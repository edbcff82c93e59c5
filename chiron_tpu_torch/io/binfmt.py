"""Fixed-record .bin training batch format (file_batch compatibility).

A copy of ``chiron_tpu/io/binfmt.py``: either package reads the folders the
other writes, byte for byte.

Byte-compatible with the reference's struct layout
``'<1H{L}f1H{L}b'`` (chiron/utils/file_batch.py:49: uint16 event length,
L float32 signal samples, uint16 label length, L int8 labels) and its
``data.meta`` descriptor — but read/written with one vectorised numpy
structured-dtype view instead of per-record struct packing, and fed into
the same in-memory Dataset the trainer uses (the TF queue pipeline of
chiron/chiron_queue_input.py collapses into this + the async host loader).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

DNA_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}
MINIMUM_LABEL_LEN_PER_100 = 1


def record_dtype(length: int) -> np.dtype:
    return np.dtype(
        [
            ("event_length", "<u2"),
            ("signal", "<f4", (length,)),
            ("label_length", "<u2"),
            ("label", "<i1", (length,)),
        ]
    )


def format_string(length: int) -> str:
    return "<1H" + str(length) + "f1H" + str(length) + "b"


def write_bin(path: str, events, event_lengths, labels, label_lengths) -> int:
    """Write one .bin batch file. labels padded with -1."""
    n = len(events)
    length = len(events[0]) if n else 0
    rec = np.zeros(n, record_dtype(length))
    for i in range(n):
        rec[i]["event_length"] = event_lengths[i]
        rec[i]["signal"] = events[i]
        rec[i]["label_length"] = label_lengths[i]
        lab = np.full(length, -1, np.int8)
        lab[: len(labels[i])] = labels[i][:length]
        rec[i]["label"] = lab
    with open(path, "wb") as f:
        rec.tofile(f)
    return n


def read_bin(path: str, length: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read a .bin batch file -> (events, event_lens, labels, label_lens)."""
    rec = np.fromfile(path, dtype=record_dtype(length))
    return (
        rec["signal"].astype(np.float32),
        rec["event_length"].astype(np.int32),
        rec["label"].astype(np.int32),
        rec["label_length"].astype(np.int32),
    )


def read_meta(folder: str) -> dict:
    """Parse data.meta (chiron/utils/file_batch.py:130-138)."""
    meta = {}
    with open(os.path.join(folder, "data.meta")) as f:
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) == 2:
                meta[parts[0]] = parts[1]
    return meta


def write_meta(folder: str, length: int, batch: int, normalization: str,
               basecall_group: str, basecall_subgroup: str, mode: str) -> None:
    with open(os.path.join(folder, "data.meta"), "w+") as f:
        f.write("signal_length " + str(length) + "\n")
        f.write("file_batch_size " + str(batch) + "\n")
        f.write("normalization " + normalization + "\n")
        f.write("basecall_group " + basecall_group + "\n")
        f.write("basecall_subgroup" + basecall_subgroup + "\n")
        f.write("DNA_base A-0 C-1 G-2 T-3" + "\n")
        f.write("data_type " + mode + "\n")
        f.write("format " + format_string(length) + "\n")


def read_bin_folder(folder: str, length: int | None = None):
    """Read every data_batch_*.bin under folder into one dense dataset."""
    if length is None:
        meta = read_meta(folder)
        length = int(meta["signal_length"])
    evs, evl, lbs, lbl = [], [], [], []
    for name in sorted(os.listdir(folder)):
        if name.endswith(".bin"):
            e, el, lb, ll = read_bin(os.path.join(folder, name), length)
            evs.append(e)
            evl.append(el)
            lbs.append(lb)
            lbl.append(ll)
    if not evs:
        z = np.zeros
        return z((0, length), np.float32), z(0, np.int32), z((0, length), np.int32), z(0, np.int32)
    return (
        np.concatenate(evs),
        np.concatenate(evl),
        np.concatenate(lbs),
        np.concatenate(lbl),
    )


def segment_events(
    raw_data: np.ndarray,
    raw_label,
    raw_start: np.ndarray,
    length: int,
    mode: str = "dna",
) -> Tuple[List, List, List, List]:
    """Cut label-boundary-aligned windows (file_batch.py:74-97 parity)."""
    if mode == "rna":
        min_label = int(MINIMUM_LABEL_LEN_PER_100 * length / 100 * 2)
        min_signal = int(min_label * 3)
    else:
        min_label = int(MINIMUM_LABEL_LEN_PER_100 * length / 100 + 1)
        min_signal = int(min_label + 1)
    events, event_lengths, labels, label_lengths = [], [], [], []
    pre_start = raw_start[0]
    pre_index = 0
    for index, start in enumerate(raw_start):
        while start - pre_start > length:
            current_len = int(raw_start[index - 1] - pre_start)
            if (index - 1 - min_label <= pre_index) or (current_len < min_signal):
                pre_index += 1
                pre_start = raw_start[pre_index]
                continue
            events.append(
                np.pad(
                    raw_data[pre_start:raw_start[index - 1]],
                    (0, length + pre_start - raw_start[index - 1]),
                    mode="constant",
                )
            )
            event_lengths.append(current_len)
            label_ind = raw_label["base"][pre_index:index - 1]
            labels.append([DNA_BASE[x.decode("UTF-8")] for x in label_ind])
            label_lengths.append(index - 1 - pre_index)
            pre_index = index - 1
            pre_start = raw_start[index - 1]
        if raw_start[index] - pre_start > length:
            pre_index = index
            pre_start = raw_start[index]
    return events, event_lengths, labels, label_lengths
