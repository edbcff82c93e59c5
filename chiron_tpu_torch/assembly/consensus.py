"""Overlap-consensus assembly of per-window decoded reads.

A copy of ``chiron_tpu/assembly/consensus.py``'s pure-Python path (the JAX
package's native path is documented as bit-identical to it). Re-implements
the reference assembly kernels (chiron/utils/easy_assembler.py) with
numpy-vectorised inner loops:

* ``glue``  — suffix/prefix overlap scoring for jump ≈ segment_len
  (easy_assembler.py:276-294). This is the default at the standard presets
  (jump=390/seg=400 → jump > 0.9*seg, chiron/chiron_eval.py:138-150).
* ``stick`` — plain concatenation (easy_assembler.py:296-300).
* ``simple`` — matching-block offset voting with a log-probability
  displacement model (easy_assembler.py:212-250).
* ``global`` — global alignment displacement; the reference calls Biopython
  ``pairwise2.align.globalms(match=1, mismatch=-3, open=-5, extend=-2)``
  (easy_assembler.py:252-274); here it is a self-contained affine-gap
  Needleman-Wunsch (no Biopython dependency).

Counts accumulate into a [4, L] consensus matrix (+ a parallel quality
accumulator), and the consensus sequence is its argmax — identical contract
to simple_assembly / simple_assembly_qs (easy_assembler.py:302-335,393-432).
"""

from __future__ import annotations

import difflib
import math
from typing import List, Sequence, Tuple

import numpy as np

_BASE_INDEX = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}
_BASES = "ACGT"


def get_assembler_kernel(jump: int, segment_len: int) -> str:
    """Kernel choice by jump/segment ratio (chiron/chiron_eval.py:138-150)."""
    assembler = "simple"
    if jump > 0.9 * segment_len:
        assembler = "glue"
    if jump >= segment_len:
        assembler = "stick"
    return assembler


# --------------------------------------------------------------------------
# displacement kernels
# --------------------------------------------------------------------------

def glue_kernel(bpread: str, prev_bpread: str) -> int:
    """Best suffix(prev)/prefix(cur) overlap; returns displacement.

    Scoring: 2*matches - overlap_len, overlap searched in
    [1, min(floor(0.1*len(prev)), len(cur))) — parity with
    easy_assembler.py:276-294, vectorised via one O(k^2) boolean triangle.
    """
    prev_n = len(prev_bpread)
    n = len(bpread)
    max_overlap = min(math.floor(0.1 * prev_n), n)
    best_i, best_score = 0, 0
    if max_overlap > 1:
        head = np.frombuffer(bpread[: max_overlap - 1].encode(), dtype=np.uint8)
        tail = np.frombuffer(prev_bpread[-(max_overlap - 1):].encode(), dtype=np.uint8)
        k = max_overlap - 1
        for i in range(1, max_overlap):
            score = 2 * int(np.sum(head[:i] == tail[k - i:])) - i
            if score > best_score:
                best_i, best_score = i, score
    return prev_n - best_i


def stick_kernel(bpread: str, prev_bpread: str) -> int:
    return len(prev_bpread)


def _matching_blocks(a: str, b: str):
    """difflib.SequenceMatcher(a, b).get_matching_blocks()."""
    return difflib.SequenceMatcher(a=a, b=b).get_matching_blocks()


def simple_kernel(
    bpread: str, prev_bpread: str, error_rate: float, jump_step_ratio: float
) -> Tuple[int, float]:
    """Matching-block displacement voting (easy_assembler.py:212-250)."""
    back_ratio = 6.5 * 10e-4
    p_same = 1 - 2 * error_rate + 26 / 25 * (error_rate ** 2)
    p_diff = 1 - p_same
    ns: dict = {}
    n = len(bpread)
    for block in _matching_blocks(bpread, prev_bpread):
        offset = block[1] - block[0]
        ns[offset] = ns.get(offset, 0) + block[2]
    log_same = np.log(p_same / 0.25)
    log_px = {}
    for key, same_count in ns.items():
        k = -key if key < 0 else key
        rate = back_ratio * n * jump_step_ratio if key < 0 else n * jump_step_ratio
        log_px[key] = (
            k * np.log(rate)
            - math.lgamma(k + 1)  # == sum(log(1..k)), O(1)
            + same_count * log_same
            + 0.0  # nd[offset] is always 0 in the reference too
        )
    disp = max(log_px, key=log_px.get)
    return disp, log_px[disp]


def _nw_align(a: str, b: str, match=1, mismatch=-3, gap_open=-5, gap_extend=-2):
    """Affine-gap global alignment (globalms parity). Returns aligned strings."""
    n, m = len(a), len(b)
    neg = -1e9
    av = np.frombuffer(a.encode(), np.uint8)
    bv = np.frombuffer(b.encode(), np.uint8)
    # DP matrices: M match/mismatch end, X gap-in-b (a consumed), Y gap-in-a
    M = np.full((n + 1, m + 1), neg)
    X = np.full((n + 1, m + 1), neg)
    Y = np.full((n + 1, m + 1), neg)
    M[0, 0] = 0.0
    X[1:, 0] = gap_open + gap_extend * np.arange(n)
    Y[0, 1:] = gap_open + gap_extend * np.arange(m)
    ptrM = np.zeros((n + 1, m + 1), np.int8)  # 0=M,1=X,2=Y source
    ptrX = np.zeros((n + 1, m + 1), np.int8)
    ptrY = np.zeros((n + 1, m + 1), np.int8)
    # one batch of vector ops per row: M depends only on the previous row's
    # diagonal, and the in-row chain Y[j] = max(M[j-1]+open, Y[j-1]+ext)
    # unrolls to a running maximum over M[j'] + open - ext*j' (scores are
    # small integers, so the reassociation is exact)
    jar = np.arange(m)
    for i in range(1, n + 1):
        sub = np.where(av[i - 1] == bv, match, mismatch)
        # X: gap in b (move down): from M/X above
        openx = M[i - 1, :] + gap_open + gap_extend
        extx = X[i - 1, :] + gap_extend
        X[i, :] = np.maximum(openx, extx)
        ptrX[i, :] = (extx > openx).astype(np.int8)  # 1 if extending X
        # M: diagonal from the previous row, first-max tie order (M, X, Y)
        cands = np.stack([M[i - 1, :-1], X[i - 1, :-1], Y[i - 1, :-1]])
        k = np.argmax(cands, axis=0)
        M[i, 1:] = np.take_along_axis(cands, k[None], 0)[0] + sub
        ptrM[i, 1:] = k.astype(np.int8)
        # Y: running-max scan over in-row chain starts
        t = M[i, :-1] + gap_open - gap_extend * jar
        t[0] = max(t[0], neg)  # the Y[i, 0] = neg extension chain
        Y[i, 1:] = np.maximum.accumulate(t) + gap_extend * (jar + 1)
        ptrY[i, 1:] = np.where(
            Y[i, :-1] + gap_extend > M[i, :-1] + (gap_open + gap_extend),
            np.int8(2), np.int8(0),
        )
    # traceback from best of three at (n, m)
    state = int(np.argmax((M[n, m], X[n, m], Y[n, m])))
    i, j = n, m
    out_a: List[str] = []
    out_b: List[str] = []
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            out_a.append(a[i - 1])
            out_b.append(b[j - 1])
            state = int(ptrM[i, j])
            i -= 1
            j -= 1
        elif state == 1 and i > 0:
            out_a.append(a[i - 1])
            out_b.append("-")
            state = 0 if ptrX[i, j] == 0 else 1
            i -= 1
        elif j > 0:
            out_a.append("-")
            out_b.append(b[j - 1])
            state = 0 if ptrY[i, j] == 0 else 2
            j -= 1
        else:
            break
    return "".join(reversed(out_a)), "".join(reversed(out_b))


def _match_blocks(align_a: str, align_b: str):
    """Contiguous gap-free blocks of an alignment (easy_assembler.py:337-356)."""
    blocks = []
    tmp_start = -1
    pos_0 = pos_1 = 0
    idx = 0
    for idx in range(len(align_a)):
        if align_a[idx] == "-" or align_b[idx] == "-":
            if tmp_start >= 0:
                blocks.append([idx - tmp_start, pos_0, pos_1])
                tmp_start = -1
        else:
            if tmp_start == -1:
                tmp_start = idx
        if align_a[idx] != "-":
            pos_0 += 1
        if align_b[idx] != "-":
            pos_1 += 1
    if tmp_start >= 0:
        blocks.append([idx - tmp_start, pos_0, pos_1])
    return blocks


def global_kernel(bpread: str, prev_bpread: str) -> int:
    """Displacement from the longest gap-free block of a global alignment."""
    align_prev, align_cur = _nw_align(prev_bpread, bpread)
    blocks = _match_blocks(align_prev, align_cur)
    if not blocks:
        raise ValueError("Alignment not found")
    block = max(blocks, key=lambda x: x[0])
    return block[1] - block[2]


def _displacement(kernel: str, bpread, prev_bpread, error_rate, jump_step_ratio):
    if kernel == "simple":
        disp, _ = simple_kernel(bpread, prev_bpread, error_rate, jump_step_ratio)
        return disp
    if kernel == "global":
        return global_kernel(bpread, prev_bpread)
    if kernel == "glue":
        return glue_kernel(bpread, prev_bpread)
    if kernel == "stick":
        return stick_kernel(bpread, prev_bpread)
    raise ValueError(f"Unknown assembly kernel {kernel}")


# --------------------------------------------------------------------------
# consensus accumulation
# --------------------------------------------------------------------------

def _encode(segment: str, alphabet: str = _BASES) -> np.ndarray:
    arr = np.frombuffer(segment.encode(), np.uint8)
    out = np.zeros(arr.shape, np.int64)
    for idx, base in enumerate(alphabet):
        out[arr == ord(base)] = idx
        out[arr == ord(base.lower())] = idx
    return out


def simple_assembly(
    bpreads: Sequence[str],
    jump_step_ratio: float,
    error_rate: float = 0.2,
    kernel: str = "global",
    alphabet: str = _BASES,
) -> np.ndarray:
    """Stitch window reads into a [len(alphabet), L] base-count matrix."""
    census_len = 1000
    consensus = np.zeros((len(alphabet), census_len))
    pos = 0
    length = 0
    for indx, bpread in enumerate(bpreads):
        if indx == 0:
            disp = 0
        else:
            disp = _displacement(
                kernel, bpread, bpreads[indx - 1], error_rate, jump_step_ratio
            )
        start = max(pos + disp, 0) if indx else 0
        seg = bpread[-(pos + disp):] if (indx and pos + disp < 0) else bpread
        end = start + len(seg)
        if end > census_len:
            grow = 1000 * (1 + (end - census_len) // 1000)
            consensus = np.pad(consensus, ((0, 0), (0, grow)))
            census_len += grow
        if len(seg):
            np.add.at(consensus, (_encode(seg, alphabet), np.arange(start, end)), 1)
        if indx:
            pos += disp
        length = max(length, end)
    return consensus[:, :length]


def simple_assembly_qs(
    bpreads: Sequence[str],
    qs_list: np.ndarray,
    jump_step_ratio: float,
    error_rate: float = 0.2,
    kernel: str = "global",
    alphabet: str = _BASES,
) -> Tuple[np.ndarray, np.ndarray]:
    """Same as simple_assembly, also accumulating per-base quality mass."""
    assert len(bpreads) == len(qs_list)
    census_len = 1000
    consensus = np.zeros((len(alphabet), census_len))
    consensus_qs = np.zeros((len(alphabet), census_len))
    pos = 0
    length = 0
    for indx, bpread in enumerate(bpreads):
        if indx == 0:
            disp = 0
        else:
            disp = _displacement(
                kernel, bpread, bpreads[indx - 1], error_rate, jump_step_ratio
            )
        start = max(pos + disp, 0) if indx else 0
        seg = bpread[-(pos + disp):] if (indx and pos + disp < 0) else bpread
        end = start + len(seg)
        if end > census_len:
            grow = 1000 * (1 + (end - census_len) // 1000)
            consensus = np.pad(consensus, ((0, 0), (0, grow)))
            consensus_qs = np.pad(consensus_qs, ((0, 0), (0, grow)))
            census_len += grow
        if len(seg):
            idx = (_encode(seg, alphabet), np.arange(start, end))
            np.add.at(consensus, idx, 1)
            np.add.at(consensus_qs, idx, float(np.asarray(qs_list[indx]).ravel()[0]))
        if indx:
            pos += disp
        length = max(length, end)
    return consensus[:, :length], consensus_qs[:, :length]


def consensus_to_bases(consensus: np.ndarray, alphabet: str = None) -> str:
    """argmax over the count matrix -> base string (chiron_eval.py:457)."""
    if alphabet is None:
        alphabet = "ACGTX"[: consensus.shape[0]]
    return "".join(alphabet[i] for i in np.argmax(consensus, axis=0))


def qs(consensus: np.ndarray, consensus_qs: np.ndarray, output_standard="phred+33"):
    """Phred quality from count + quality matrices (chiron_eval.py:152-174)."""
    sort_ind = np.argsort(consensus, axis=0)
    length = consensus.shape[1]
    cols = np.arange(length)[None, :]
    sorted_consensus = consensus[sort_ind, cols]
    sorted_consensus_qs = consensus_qs[sort_ind, cols]
    with np.errstate(divide="ignore", invalid="ignore"):
        quality_score = 10 * np.log10(
            (sorted_consensus[-1, :] + 1) / (sorted_consensus[-2, :] + 1)
        ) + sorted_consensus_qs[-1, :] / sorted_consensus[-1, :] / np.log(10)
    # zero-coverage columns yield nan/inf (the reference would crash on
    # chr() overflow, chiron_eval.py:173); clamp to the printable phred+33
    # range instead
    quality_score = np.clip(np.nan_to_num(quality_score), 0, 93)
    if output_standard == "number":
        return quality_score.astype(int)
    elif output_standard == "phred+33":
        return "".join(chr(x + 33) for x in quality_score.astype(int))
    raise ValueError(f"Unknown quality standard {output_standard}")
