"""Training-label IO: fast5 corrected events, .label files, windowing.

A copy of ``chiron_tpu/io/labels.py`` (reference: chiron/utils/labelop.py:
14-187 and chiron/chiron_input.py:570-693): ``get_label_raw`` and
``get_label_segment`` read a resquiggled fast5; ``base2ind``,
``label_from_rows``, ``read_label``, ``read_raw`` and ``read_raw_data_sets``
with its ``file_shard`` read ``.signal``/``.label`` pairs. ``h5py`` is
imported inside the fast5 functions, so the module imports on machines
without it. The windower emits plain numpy arrays with dense, -1-padded
labels.
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


MAX_RAW_SAMPLES = 99_999_999

_LABEL_DTYPE = np.dtype([("start", "<u4"), ("length", "<u4"), ("base", "S1")])


def get_label_raw(fast5_fn: str, basecall_group: str,
                  basecall_subgroup: str) -> Tuple[tuple, tuple]:
    """Raw signal + resquiggled event labels from a corrected fast5.

    Reads ``/Raw/Reads/<read>/Signal``, the channel calibration attributes,
    and the Tombo-style corrected event table under
    ``/Analyses/<group>/<subgroup>/Events``, shifting event starts by the
    table's ``read_start_rel_to_raw`` offset into raw-sample coordinates.
    Returns ((raw, labels, starts, lengths), (offset, range, digitisation))
    with the structured label dtype of chiron/utils/labelop.py:133-187.
    Raises IOError for an unreadable file, RuntimeError for a missing group
    or calibration, ValueError for an over-long signal and
    NotImplementedError for a read with fewer than 2 samples or events.
    """
    import h5py

    try:
        f5 = h5py.File(fast5_fn, "r")
    except IOError:
        raise IOError(f"{fast5_fn}: not a readable HDF5 file")
    with f5:
        reads = f5.get("/Raw/Reads")
        if reads is None or not len(reads):
            raise RuntimeError(f"{fast5_fn}: no /Raw/Reads/* group — cannot segment")
        raw_dat = np.asarray(next(iter(reads.values()))["Signal"])

        channel = f5.get("/UniqueGlobalKey/channel_id")
        if channel is None:
            raise RuntimeError(f"{fast5_fn}: missing channel_id calibration group")
        try:
            calib = tuple(float(channel.attrs[k]) for k in ("offset", "range", "digitisation"))
        except KeyError as missing:
            raise RuntimeError(f"{fast5_fn}: channel calibration lacks {missing}")

        events = f5.get(f"/Analyses/{basecall_group}/{basecall_subgroup}/Events")
        if events is None:
            raise RuntimeError(
                f"{fast5_fn}: no corrected events under Analyses/"
                f"{basecall_group}/{basecall_subgroup}"
            )
        rel = int(events.attrs["read_start_rel_to_raw"])
        events = np.asarray(events)

    if raw_dat.size > MAX_RAW_SAMPLES:
        raise ValueError(f"{fast5_fn}: signal longer than {MAX_RAW_SAMPLES} samples")
    if raw_dat.size <= 1 or events.size <= 1:
        raise NotImplementedError(f"{fast5_fn}: read holds <2 samples or <2 events")

    event_starts = events["start"] + rel
    event_lengths = events["length"]
    label_data = np.empty(events.size, dtype=_LABEL_DTYPE)
    label_data["start"] = event_starts
    label_data["length"] = event_lengths
    label_data["base"] = events["base"]
    return (raw_dat, label_data, event_starts, event_lengths), calib


def get_label_segment(fast5_fn: str, basecall_group: str, basecall_subgroup: str,
                      corrected_group: str = "RawGenomeCorrected_000",
                      ) -> Tuple[np.ndarray, int, int, int]:
    """Annotate basecaller event segments with resquiggled 5-mer labels.

    Each basecall event from ``Analyses/<group>/<subgroup>/Events`` (times
    converted to samples via the channel sampling rate) is assigned to the
    corrected event covering its start sample (one ``searchsorted``, ties to
    the right) and annotated with the centered 5-mer, the corrected event's
    start/length, and move=1 on the first segment of each corrected event.
    Segments before the first / after the last full 5-mer window are
    dropped (chiron/utils/labelop.py:14-130).

    Returns (segment_data, first_index, last_index, total) with the
    reference's structured dtype.
    """
    import h5py

    with h5py.File(fast5_fn, "r") as f5:
        try:
            rate = int(f5["UniqueGlobalKey/channel_id"].attrs["sampling_rate"])
        except Exception:
            raise RuntimeError("Could not get channel info")
        try:
            raw_grp = list(f5["/Raw/Reads/"].values())[0]
            raw_start_time = int(raw_grp.attrs["start_time"])
        except Exception:
            raise RuntimeError(
                "Raw data is not stored in Raw/Reads/Read_[read#] so "
                "new segments cannot be identified."
            )
        try:
            seg = np.asarray(
                f5["/Analyses/" + basecall_group + "/" + basecall_subgroup + "/Events"]
            )
        except Exception:
            raise RuntimeError(
                "No events or corrupted events in file. Likely a "
                "segmentation error or mis-specified basecall-subgroups."
            )
        try:
            corr = f5["/Analyses/" + corrected_group + "/" + basecall_subgroup + "/Events"]
            corr_attrs = dict(corr.attrs.items())
            corr = np.asarray(corr)
        except Exception:
            raise RuntimeError("Corrected data not found.")

    total = len(seg)
    seg_starts = (seg["start"] * rate - raw_start_time).astype(np.int64)
    seg_lengths = np.rint(seg["length"] * rate).astype(np.int64)
    corr_starts = (corr["start"] + int(corr_attrs["read_start_rel_to_raw"])).astype(np.int64)
    corr_lengths = np.asarray(corr["length"], np.int64)
    bases = np.asarray(corr["base"], "S1")
    n_corr = len(corr_starts)
    if n_corr < 5:
        raise RuntimeError("Too few corrected events for 5-mer labels.")

    # corrected event covering each segment's start sample
    bins = np.searchsorted(corr_starts, seg_starts, side="right") - 1
    # only full 5-mer windows: centers in [2, n_corr-3]
    valid = (bins >= 2) & (bins <= n_corr - 3)
    if not np.any(valid):
        raise RuntimeError("No basecall segments overlap the corrected events.")
    first_index = int(np.argmax(valid))
    last_index = int(len(valid) - np.argmax(valid[::-1]))
    sel = np.arange(first_index, last_index)
    bins = bins[sel]

    # centered 5-mers via five shifted byte columns
    kmers = bases[bins - 2]
    for off in (-1, 0, 1, 2):
        kmers = np.char.add(kmers, bases[bins + off])
    move = np.empty(len(bins), np.uint32)
    move[0] = 1
    move[1:] = (bins[1:] != bins[:-1]).astype(np.uint32)

    segment_data = np.zeros(
        len(sel),
        dtype=[
            ("mean", "float64"), ("stdv", "float64"), ("start", "<u4"),
            ("length", "<u4"), ("kmer", "S5"), ("move", "<u4"),
            ("cstart", "<u4"), ("clength", "<u4"),
        ],
    )
    segment_data["mean"] = seg["mean"][sel]
    segment_data["stdv"] = seg["stdv"][sel]
    segment_data["start"] = seg_starts[sel]
    segment_data["length"] = seg_lengths[sel]
    segment_data["kmer"] = kmers
    segment_data["move"] = move
    segment_data["cstart"] = corr_starts[bins]
    segment_data["clength"] = corr_lengths[bins]
    return segment_data, first_index, last_index, total


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
