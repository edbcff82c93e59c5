"""Raw-signal reading, normalization, and static-shape windowing.

A copy of ``chiron_tpu/io/signal.py`` without its native text parser: the
numpy parse path is the only one (reference: chiron/chiron_input.py:253-292,
527-567). Emits a fixed-shape [N, seg_length] float32 matrix + length vector.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

MEDIAN = 0
MEAN = 1


def _mad(x: np.ndarray) -> float:
    """Median absolute deviation scaled to be a consistent sigma estimator
    (statsmodels.robust.mad parity: scale = 1/0.6744897501960817)."""
    med = np.median(x)
    return float(np.median(np.abs(x - med)) / 0.6744897501960817)


def normalize_signal(signal: np.ndarray, normalize=None) -> np.ndarray:
    """MEAN / MEDIAN(mad) normalization (chiron/chiron_input.py:527-539)."""
    signal = np.asarray(signal, dtype=np.float32)
    if len(signal) == 0:
        return signal
    if normalize == MEAN:
        signal = (signal - np.mean(signal)) / np.float32(np.std(signal))
    elif normalize == MEDIAN:
        signal = (signal - np.median(signal)) / np.float32(_mad(signal))
    return signal


def normalize_signal_unique(signal: np.ndarray, normalize=None) -> np.ndarray:
    """fast5 variant: moments over unique values (chiron_input.py:541-555)."""
    signal = np.asarray(signal, dtype=np.float32)
    if len(signal) == 0:
        return signal
    uniq = np.unique(signal)
    if normalize == MEAN:
        signal = (signal - np.mean(uniq)) / np.float32(np.std(uniq))
    elif normalize == MEDIAN:
        signal = (signal - np.median(uniq)) / np.float32(_mad(uniq))
    return signal


def parse_signal_text(raw: bytes) -> np.ndarray:
    """Whitespace-separated numbers -> float32 array."""
    vals = raw.split()
    return np.asarray(vals, dtype=np.float32) if vals else np.zeros(0, np.float32)


def read_signal(file_path: str, normalize=None) -> np.ndarray:
    """Read a whitespace/newline-delimited .signal file."""
    with open(file_path, "rb") as f:
        signal = parse_signal_text(f.read())
    return normalize_signal(signal, normalize)


def window_signal(
    signal: np.ndarray,
    start_index: int = 0,
    step: int = 390,
    seg_length: int = 400,
) -> Tuple[np.ndarray, np.ndarray]:
    """Slide a window of seg_length by step with zero padding.

    Windows start at every multiple of ``step`` from ``start_index`` to the
    end of the signal; the final (partial) windows are zero-padded
    (chiron/chiron_input.py:279-292).

    Returns (windows [N, seg_length] float32, lengths [N] int32).
    """
    signal = np.asarray(signal, dtype=np.float32)[start_index:]
    sig_len = len(signal)
    if sig_len == 0:
        return np.zeros((0, seg_length), np.float32), np.zeros(0, np.int32)
    starts = np.arange(0, sig_len, step)
    lengths = np.minimum(sig_len - starts, seg_length).astype(np.int32)
    n = len(starts)
    windows = np.zeros((n, seg_length), np.float32)
    idx = starts[:, None] + np.arange(seg_length)[None, :]
    valid = idx < sig_len
    windows[valid] = signal[idx[valid]]
    return windows, lengths


def read_signal_for_eval(
    file_path: str,
    start_index: int = 0,
    step: int = 390,
    seg_length: int = 400,
    normalize=None,
    reverse_fast5: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .signal or .fast5 file and window it for eval (fast5 signal
    reversed in RNA mode)."""
    if file_path.endswith(".signal"):
        f_signal = read_signal(file_path, normalize)
    elif file_path.endswith(".fast5"):
        from chiron_tpu_torch.io.fast5 import read_signal_fast5

        f_signal = read_signal_fast5(file_path, normalize)
        if reverse_fast5:
            f_signal = f_signal[::-1]
    else:
        raise TypeError(
            "Input file should be a signal file or fast5 file, "
            f"but a {os.path.splitext(file_path)[1]} file is given."
        )
    return window_signal(f_signal, start_index, step, seg_length)
