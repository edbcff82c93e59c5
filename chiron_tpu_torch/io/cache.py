"""Out-of-core training-window cache: bounded-RSS replacement for biglist.

A copy of ``chiron_tpu/io/cache.py``: the same files and the same meta, so a
cache that either package builds is reused by the other without a rebuild,
and ``CachedDataset(seed)`` serves the JAX package's batches in its order.
One difference: a read is skipped only where its label file is missing or
malformed (the port's ``read_raw_data_sets`` rule; the JAX package skips on
any exception). ``file_shard`` (index, count) builds the cache of one shard
of the files, a process's share in multi-process training.

The reference spills training segments to an HDF5 "biglist" once they
exceed 1e5 entries (chiron/chiron_input.py:42-120) and re-reads batches
from disk. This module is the TPU framework's equivalent: windows are
streamed to flat binary shards on disk as they are cut, then served as
shuffled batches by positioned reads (``os.pread``) so resident memory is
bounded by O(batch + permutation) regardless of corpus size — training on
tens of millions of windows never materialises the corpus.

Layout under a cache directory:
  cache.meta.json   {"n", "seq_length", "u_max", "build": {...}}
  events.f32        [n, seq_length] float32 rows
  event_lens.i32    [n] int32
  labels.i32        ragged int32 label ids, row i at offsets[i]:offsets[i+1]
  label_offsets.i64 [n + 1] int64
Label rows are stored ragged (the dense pad target u_max is recorded in the
meta) so the cache stays compact while every served batch pads to the same
static [B, u_max] shape the jitted train step was compiled for.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from chiron_tpu_torch.io.labels import _in_shard, read_label, read_raw
from chiron_tpu_torch.io.signal import read_signal

META_NAME = "cache.meta.json"
_FILES = ("events.f32", "event_lens.i32", "labels.i32", "label_offsets.i64")


class CacheWriter:
    """Append windows to a cache directory in streaming fashion."""

    def __init__(self, cache_dir: str, seq_length: int,
                 build_params: Optional[Dict[str, Any]] = None):
        os.makedirs(cache_dir, exist_ok=True)
        self.cache_dir = cache_dir
        self.seq_length = int(seq_length)
        self.build_params = dict(build_params or {})
        self.n = 0
        self.u_max = 0
        self._label_offset = 0
        self._fh = {name: open(os.path.join(cache_dir, name), "wb")
                    for name in _FILES}
        self._fh["label_offsets.i64"].write(np.zeros(1, np.int64).tobytes())

    def append(self, events, event_lens, labels, label_lens) -> None:
        """Add windows: events [n, L] (or list of [L] rows), ragged labels."""
        if not len(events):
            return
        ev = np.ascontiguousarray(events, np.float32)
        if ev.ndim != 2 or ev.shape[1] != self.seq_length:
            raise ValueError(
                f"events must be [n, {self.seq_length}], got {ev.shape}"
            )
        self._fh["events.f32"].write(ev.tobytes())
        self._fh["event_lens.i32"].write(
            np.ascontiguousarray(event_lens, np.int32).tobytes()
        )
        flat = []
        offsets = np.empty(len(labels), np.int64)
        for i, row in enumerate(labels):
            row = np.asarray(row, np.int32)[: int(label_lens[i])]
            flat.append(row)
            self._label_offset += row.size
            offsets[i] = self._label_offset
            self.u_max = max(self.u_max, row.size)
        self._fh["labels.i32"].write(np.concatenate(flat).tobytes()
                                     if flat else b"")
        self._fh["label_offsets.i64"].write(offsets.tobytes())
        self.n += len(ev)

    def close(self) -> Dict[str, Any]:
        for f in self._fh.values():
            f.close()
        meta = {
            "n": self.n,
            "seq_length": self.seq_length,
            "u_max": self.u_max,
            "build": self.build_params,
        }
        with open(os.path.join(self.cache_dir, META_NAME), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        return meta


def read_meta(cache_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(cache_dir, META_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def data_signature(data_dir: str) -> Dict[str, Any]:
    """Cheap content signature of a .signal/.label tree (count, bytes,
    newest mtime) so a cache built from since-regenerated data under the
    same path is detected as stale."""
    n = 0
    total = 0
    newest = 0.0
    for root, _, files in os.walk(data_dir):
        for name in files:
            if name.endswith((".signal", ".label")):
                st = os.stat(os.path.join(root, name))
                n += 1
                total += st.st_size
                newest = max(newest, st.st_mtime)
    return {"n_files": n, "bytes": total, "newest_mtime": round(newest, 3)}


def build_cache(
    data_dir: str,
    cache_dir: str,
    seq_length: int,
    k_mer: int = 1,
    skip_start: int = 10,
    sig_norm=None,
    max_segments=None,
    file_shard=None,
) -> Dict[str, Any]:
    """Stream .signal/.label pairs under data_dir into a window cache.

    Re-windows file by file (the biglist build loop,
    chiron/chiron_input.py:447-471) but never holds more than one read's
    windows in memory. Returns the cache meta.
    """
    build_params = {
        "data_dir": os.path.abspath(data_dir),
        "k_mer": int(k_mer),
        "skip_start": int(skip_start),
        "sig_norm": sig_norm,
        "max_segments": max_segments,
        "signature": data_signature(data_dir),
        **({"file_shard": list(file_shard)} if file_shard else {}),
    }
    writer = CacheWriter(cache_dir, seq_length, build_params)
    done = False
    for root, _, files in os.walk(data_dir, topdown=False):
        if done:
            break
        for name in sorted(files):
            if not name.endswith(".signal"):
                continue
            if file_shard is not None and not _in_shard(
                    os.path.relpath(os.path.join(root, name), data_dir), file_shard):
                continue
            file_pre = os.path.splitext(name)[0]
            f_signal = read_signal(os.path.join(root, name), normalize=sig_norm)
            if len(f_signal) == 0:
                continue
            try:
                f_label = read_label(
                    os.path.join(root, file_pre + ".label"),
                    skip_start=skip_start, window_n=(k_mer - 1) // 2,
                )
            except (OSError, ValueError, IndexError):
                print(f"Read the label {name} fail.Skipped.")
                continue
            ev, evl, lb, lbl = read_raw(f_signal, f_label, seq_length)
            if max_segments is not None and writer.n + len(ev) > max_segments:
                take = max_segments - writer.n
                ev, evl, lb, lbl = ev[:take], evl[:take], lb[:take], lbl[:take]
                done = True
            if ev:
                writer.append(np.asarray(ev, np.float32), evl, lb, lbl)
            if done:
                break
    return writer.close()


class CachedDataset:
    """Shuffled epoch batcher over an on-disk window cache.

    Drop-in for train.loop.Dataset: identical ``next_batch`` contract
    (including the fixed [B, u_max] label pad shape), but rows are fetched
    with positioned reads so RSS stays O(batch) — the permutation (8 bytes
    per window) is the only per-corpus resident state.
    """

    def __init__(self, cache_dir: str, seed: int = 0):
        meta = read_meta(cache_dir)
        if meta is None:
            raise FileNotFoundError(f"{cache_dir}: no {META_NAME}")
        self.cache_dir = cache_dir
        self.meta = meta
        self.n = int(meta["n"])
        self.seq_length = int(meta["seq_length"])
        self.u_max = int(meta["u_max"])
        self._fd = {
            name: os.open(os.path.join(cache_dir, name), os.O_RDONLY)
            for name in ("events.f32", "event_lens.i32", "labels.i32")
        }
        # offsets are tiny (8 B/window): resident for O(1) ragged lookups
        self._offsets = np.fromfile(
            os.path.join(cache_dir, "label_offsets.i64"), np.int64
        )
        if len(self._offsets) != self.n + 1:
            raise ValueError(f"{cache_dir}: label_offsets length mismatch")
        self.rng = np.random.RandomState(seed)
        self._perm = self.rng.permutation(self.n)
        self._pos = 0
        self.epochs_completed = 0
        self._row_bytes = self.seq_length * 4

    def close(self) -> None:
        for fd in self._fd.values():
            os.close(fd)
        self._fd = {}

    def _take_indices(self, batch_size: int, shuffle: bool) -> np.ndarray:
        idx = []
        while len(idx) < batch_size:
            take = min(batch_size - len(idx), self.n - self._pos)
            idx.extend(self._perm[self._pos:self._pos + take])
            self._pos += take
            if self._pos >= self.n:
                self.epochs_completed += 1
                self._pos = 0
                if shuffle:
                    self._perm = self.rng.permutation(self.n)
        return np.asarray(idx)

    def next_batch(self, batch_size: int, shuffle: bool = True):
        idx = self._take_indices(batch_size, shuffle)
        b = len(idx)
        events = np.empty((b, self.seq_length), np.float32)
        ev_fd = self._fd["events.f32"]
        for i, row in enumerate(idx):
            buf = os.pread(ev_fd, self._row_bytes, int(row) * self._row_bytes)
            events[i] = np.frombuffer(buf, np.float32)
        len_fd = self._fd["event_lens.i32"]
        event_lens = np.empty(b, np.int32)
        for i, row in enumerate(idx):
            event_lens[i] = np.frombuffer(
                os.pread(len_fd, 4, int(row) * 4), np.int32
            )[0]
        labels = np.full((b, self.u_max), -1, np.int32)
        label_lens = np.empty(b, np.int32)
        lab_fd = self._fd["labels.i32"]
        for i, row in enumerate(idx):
            lo, hi = int(self._offsets[row]), int(self._offsets[row + 1])
            lab = np.frombuffer(os.pread(lab_fd, (hi - lo) * 4, lo * 4), np.int32)
            labels[i, : len(lab)] = lab
            label_lens[i] = len(lab)
        return {
            "signal": events,
            "seq_len": event_lens,
            "label": labels,
            "label_len": label_lens,
        }


def cached_dataset(
    data_dir: str,
    cache_dir: str,
    seq_length: int,
    k_mer: int = 1,
    skip_start: int = 10,
    sig_norm=None,
    max_segments=None,
    seed: int = 0,
    file_shard=None,
) -> CachedDataset:
    """Open (building or rebuilding as needed) a window cache for data_dir.

    A cache is reused only when its recorded build parameters match; any
    mismatch (different source dir, window length, k-mer, offset, norm,
    process shard) triggers a rebuild — this is what makes the trainer's
    epoch resampling with shifted offsets (chiron_rcnn_train.py:100-103)
    work out-of-core.
    """
    want = {
        "data_dir": os.path.abspath(data_dir),
        "k_mer": int(k_mer),
        "skip_start": int(skip_start),
        "sig_norm": sig_norm,
        "max_segments": max_segments,
        "signature": data_signature(data_dir),
        **({"file_shard": list(file_shard)} if file_shard else {}),
    }
    meta = read_meta(cache_dir)
    if (
        meta is None
        or int(meta.get("seq_length", -1)) != int(seq_length)
        or meta.get("build") != want
    ):
        build_cache(data_dir, cache_dir, seq_length, k_mer=k_mer,
                    skip_start=skip_start, sig_norm=sig_norm,
                    max_segments=max_segments, file_shard=file_shard)
    return CachedDataset(cache_dir, seed=seed)
