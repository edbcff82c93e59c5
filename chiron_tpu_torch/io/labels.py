"""Training-label IO: .label files and signal/label windowing.

A copy of the ``.signal``/``.label`` side of ``chiron_tpu/io/labels.py``
(reference: chiron/chiron_input.py:570-693): ``base2ind``,
``label_from_rows``, ``read_label``, ``read_raw`` and
``read_raw_data_sets`` with its ``file_shard``. It imports no h5py; the fast5 labelling functions
are not ported yet. The windower emits plain numpy arrays with dense,
-1-padded labels.
"""

from __future__ import annotations

import collections
import hashlib
import os
from typing import List, Tuple

import numpy as np

from chiron_tpu_torch.io.signal import read_signal

raw_labels = collections.namedtuple("raw_labels", ["start", "length", "base"])

MIN_LABEL_LENGTH = 2
MIN_SIGNAL_PRO = 0.3


def base2ind(base: str, alphabet_n: int = 4) -> int:
    """Base char -> class index (chiron/chiron_input.py:710-729)."""
    if alphabet_n == 4:
        upper, lower = "ACGT", "acgt"
    elif alphabet_n == 5:
        upper, lower = "ACGTX", "acgtx"
    else:
        raise ValueError("Alphabet number should be 4 or 5.")
    if base.isdigit():
        return int(base) // 256
    if ord(base) < 97:
        return upper.index(base)
    return lower.index(base)


def label_from_rows(rows, skip_start: int = 10, window_n: int = 0) -> raw_labels:
    """Build labels from (start, end, base_char) rows: ``skip_start`` rows
    trimmed at both ends, k-mer window encoding (chiron/chiron_input.py:
    570-627)."""
    start, length, base, all_base = [], [], [], []
    if skip_start < window_n:
        skip_start = window_n
    for row in rows:
        all_base.append(base2ind(row[2]))
    file_len = len(all_base)
    for count, row in enumerate(rows):
        if count < skip_start or count > (file_len - skip_start - 1):
            continue
        start.append(int(row[0]))
        length.append(int(row[1]) - int(row[0]))
        k_mer = 0
        for i in range(window_n * 2 + 1):
            k_mer = k_mer * 4 + all_base[count + i - window_n]
        base.append(k_mer)
    return raw_labels(start=start, length=length, base=base)


def read_label(file_path: str, skip_start: int = 10, window_n: int = 0) -> raw_labels:
    """Read a .label file (start, end, base per line)."""
    rows = []
    with open(file_path) as f:
        for line in f:
            record = line.split()
            rows.append((record[0], record[1], record[2]))
    return label_from_rows(rows, skip_start=skip_start, window_n=window_n)


def read_raw(raw_signal: np.ndarray, raw_label: raw_labels,
             max_seq_length: int) -> Tuple[List, List, List, List]:
    """Cut (signal, label) windows at label-event boundaries with QC.

    Greedy grouping: a window takes consecutive events while its total
    signal length stays under ``max_seq_length``; the event that would
    overflow it starts the next window. A window is kept only if it covers
    >30% of ``max_seq_length`` and holds >2 labels; kept windows are
    right-padded with the signal that follows the overflow event (then
    zeros), and the trailing partial window is dropped
    (chiron/chiron_input.py:630-692).
    """
    starts = np.asarray(raw_label.start, np.int64)
    lengths = np.asarray(raw_label.length, np.int64)
    bases = list(raw_label.base)
    signal = np.ascontiguousarray(raw_signal, np.float32)
    n = len(lengths)
    if not np.all(starts + lengths < signal.size):
        raise ValueError("label events run past the end of the signal")
    # csum[i] = total event signal before event i
    csum = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=csum[1:])

    min_keep = max_seq_length * MIN_SIGNAL_PRO
    event_val, event_length, label_val, label_length = [], [], [], []
    j = 0
    while j < n:
        # first prefix-sum index at/over the budget; events j..(stop-2) fit
        stop = int(np.searchsorted(csum, csum[j] + max_seq_length, side="left"))
        if stop > n:
            break  # every remaining event fits: unterminated window, dropped
        m = stop - 2
        if m < j:
            j += 1  # single event >= window size: acts as a window breaker
            continue
        win_len = int(csum[m + 1] - csum[j])
        if win_len > min_keep and (m - j + 1) > MIN_LABEL_LENGTH:
            parts = [signal[s:s + l] for s, l in zip(starts[j:m + 1], lengths[j:m + 1])]
            pad_from = int(starts[m + 1] + lengths[m + 1])
            parts.append(signal[pad_from:pad_from + (max_seq_length - win_len)])
            window = np.concatenate(parts)
            if window.size < max_seq_length:  # pad source hit signal end
                window = np.pad(window, (0, max_seq_length - window.size))
            event_val.append(window)
            event_length.append(win_len)
            label_val.append(bases[j:m + 1])
            label_length.append(m + 1 - j)
        j = m + 1
    return event_val, event_length, label_val, label_length


def _in_shard(rel_path: str, file_shard) -> bool:
    """Whether a file belongs to ``file_shard`` = (shard_index, num_shards):
    the md5 rule of ``parallel.dist.shard_files``, so each process of a
    multi-process run loads a disjoint subset of the corpus."""
    index, count = file_shard
    h = int.from_bytes(hashlib.md5(rel_path.encode()).digest()[:4], "big")
    return h % count == index


def read_raw_data_sets(data_dir: str, seq_length: int = 300, k_mer: int = 1,
                       max_segments_num=None, skip_start: int = 10, sig_norm=None,
                       file_shard=None):
    """Walk a directory of .signal/.label pairs into dense training arrays.

    Returns (events [N, L] f32, event_lengths [N] i32, labels [N, U] i32
    padded with -1, label_lengths [N] i32). ``file_shard`` (index, count)
    keeps the files of one shard (``_in_shard``).
    """
    events, event_lengths, labels, label_lengths = [], [], [], []
    for root, _, files in os.walk(data_dir, topdown=False):
        for name in sorted(files):
            if not name.endswith(".signal"):
                continue
            if file_shard is not None and not _in_shard(
                    os.path.relpath(os.path.join(root, name), data_dir), file_shard):
                continue
            file_pre = os.path.splitext(name)[0]
            f_signal = read_signal(os.path.join(root, name), normalize=sig_norm)
            label_path = os.path.join(root, file_pre + ".label")
            if len(f_signal) == 0:
                continue
            try:
                f_label = read_label(label_path, skip_start=skip_start,
                                     window_n=(k_mer - 1) // 2)
            except (OSError, ValueError, IndexError):
                print(f"Read the label {name} fail.Skipped.")
                continue
            ev, evl, lb, lbl = read_raw(f_signal, f_label, seq_length)
            events += ev
            event_lengths += evl
            labels += lb
            label_lengths += lbl
            if max_segments_num is not None and len(events) > max_segments_num:
                events = events[:max_segments_num]
                event_lengths = event_lengths[:max_segments_num]
                labels = labels[:max_segments_num]
                label_lengths = label_lengths[:max_segments_num]
                break
    n = len(events)
    if n == 0:
        return (np.zeros((0, seq_length), np.float32), np.zeros(0, np.int32),
                np.zeros((0, 0), np.int32), np.zeros(0, np.int32))
    u_max = max(label_lengths)
    event_arr = np.asarray(events, np.float32)
    label_arr = np.full((n, u_max), -1, np.int32)
    for i, lb in enumerate(labels):
        label_arr[i, :len(lb)] = lb
    return (event_arr, np.asarray(event_lengths, np.int32), label_arr,
            np.asarray(label_lengths, np.int32))
