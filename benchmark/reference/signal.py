"""Plain NumPy reading and windowing of ``.signal`` reads, and the batches a
basecall packs them into.

The semantics of ``chiron call`` (reference: chiron/chiron_input.py:279-292,
527-539, chiron/chiron_eval.py:304-372), written out again: a read's text
is parsed, normalised by its mean and standard deviation (``--sig_norm 1``),
cut into windows of ``seg`` samples every ``jump`` samples (the last ones
zero padded), and the windows of all reads, in sorted file order, are
packed into batches of ``batch`` rows; the last batch is wrap-padded with
copies of its own rows. Batch-stat batch norm makes a window's logits
depend on its batch, so the reference packs exactly these batches.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def read_signal(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        vals = f.read().split()
    return np.asarray(vals, dtype=np.float32) if vals else np.zeros(0, np.float32)


def normalize_mean(signal: np.ndarray) -> np.ndarray:
    signal = np.asarray(signal, np.float32)
    if len(signal) == 0:
        return signal
    return (signal - np.mean(signal)) / np.float32(np.std(signal))


def window(signal: np.ndarray, jump: int, seg: int) -> Tuple[np.ndarray, np.ndarray]:
    """(windows [N, seg] float32, lengths [N] int32) from sample 0."""
    n_sig = len(signal)
    if n_sig == 0:
        return np.zeros((0, seg), np.float32), np.zeros(0, np.int32)
    starts = np.arange(0, n_sig, jump)
    lengths = np.minimum(n_sig - starts, seg).astype(np.int32)
    idx = starts[:, None] + np.arange(seg)[None, :]
    valid = idx < n_sig
    out = np.zeros((len(starts), seg), np.float32)
    out[valid] = signal[idx[valid]]
    return out, lengths


def window_count(n_samples: int, jump: int) -> int:
    return -(-n_samples // jump) if n_samples > 0 else 0


def window_lengths(n_samples: int, jump: int, seg: int) -> np.ndarray:
    starts = np.arange(0, n_samples, jump)
    return np.minimum(n_samples - starts, seg).astype(np.int32)


def batch_plan(names: Sequence[str], n_windows: Dict[str, int],
               batch: int) -> List[List[Tuple[str, int]]]:
    """The batches of a call over ``names`` (sorted as the call sorts its
    file list): each a list of ``batch`` (file, window index) rows, the last
    wrap-padded with copies of its own rows."""
    rows = [(name, i) for name in sorted(names) for i in range(n_windows[name])]
    plan = [rows[i:i + batch] for i in range(0, len(rows), batch)]
    if plan and len(plan[-1]) < batch:
        last = plan[-1]
        plan[-1] = [last[i % len(last)] for i in range(batch)]
    return plan


def load_windows(path: str, jump: int, seg: int) -> Tuple[np.ndarray, np.ndarray]:
    return window(normalize_mean(read_signal(path)), jump, seg)


def read_names(directory: str) -> List[str]:
    return sorted(f for f in os.listdir(directory) if f.endswith(".signal"))
