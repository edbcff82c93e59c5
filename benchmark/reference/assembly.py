"""Plain NumPy consensus assembly of a read's window decodes, and its
quality string.

The semantics of ``chiron call``'s assembly at the presets the cells run
(jump > 0.9 x segment: the "glue" kernel; reference:
chiron/utils/easy_assembler.py:276-335, chiron/chiron_eval.py:152-174),
written out again in NumPy: each window is placed after the previous one
at the displacement of their best suffix / prefix overlap, the base counts
and each window's path probability are summed per position, the consensus
is the most counted base, and a base's quality is
10·log10((n1 + 1) / (n2 + 1)) + q1 / n1 / ln 10 from the two most counted
bases' counts n and summed probabilities q, clipped to 0..93, phred+33.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

_BASES = "ACGT"


def glue_displacement(cur: str, prev: str) -> int:
    """Best overlap of prev's suffix with cur's prefix, scored 2·matches -
    overlap over overlaps 1 .. min(floor(0.1·len(prev)), len(cur)) - 1."""
    max_overlap = min(math.floor(0.1 * len(prev)), len(cur))
    best_i, best_score = 0, 0
    for i in range(1, max_overlap):
        score = 2 * sum(a == b for a, b in zip(cur[:i], prev[len(prev) - i:])) - i
        if score > best_score:
            best_i, best_score = i, score
    return len(prev) - best_i


def assemble(segments: Sequence[str], probs: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """(counts [4, L], summed probabilities [4, L]) of the non-empty windows."""
    keep = [i for i, s in enumerate(segments) if s]
    total = sum(len(segments[i]) for i in keep) + 1
    counts = np.zeros((4, total))
    qsum = np.zeros((4, total))
    pos = length = 0
    prev = None
    for n, i in enumerate(keep):
        seg = segments[i]
        disp = 0 if n == 0 else glue_displacement(seg, prev)
        start = max(pos + disp, 0) if n else 0
        if n and pos + disp < 0:
            seg = seg[-(pos + disp):]
        idx = np.asarray([_BASES.index(c) for c in seg], np.int64)
        cols = np.arange(start, start + len(seg))
        np.add.at(counts, (idx, cols), 1)
        np.add.at(qsum, (idx, cols), float(probs[i]))
        if n:
            pos += disp
        length = max(length, start + len(seg))
        prev = segments[i]
    return counts[:, :length], qsum[:, :length]


def consensus(counts: np.ndarray) -> str:
    return "".join(_BASES[i] for i in np.argmax(counts, axis=0))


def quality_values(counts: np.ndarray, qsum: np.ndarray) -> np.ndarray:
    """Integer phred values of the consensus bases (before the +33)."""
    order = np.argsort(counts, axis=0)
    cols = np.arange(counts.shape[1])[None, :]
    c = counts[order, cols]
    q = qsum[order, cols]
    with np.errstate(divide="ignore", invalid="ignore"):
        val = 10 * np.log10((c[-1] + 1) / (c[-2] + 1)) + q[-1] / c[-1] / np.log(10)
    return np.clip(np.nan_to_num(val), 0, 93).astype(int)
