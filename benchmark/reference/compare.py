"""The numbers that decide ``correct``: what the timed path produced against
what the plain reference works out.

- ``window_edit``: the Levenshtein distance between each window's decoded
  bases and the reference's, summed, over the reference's bases summed.
- ``consensus_diff``: positions at which a read's consensus differs from
  the consensus the reference assembles from the same window decodes (and
  the difference of their lengths): an exact comparison.
- ``quality_gap``: the mean absolute difference between a read's phred
  values and the ones the reference gives the same decodes from its own
  path probabilities.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from benchmark.reference import assembly

_CODE = np.full(256, 4, np.int64)
for _i, _b in enumerate("ACGT"):
    _CODE[ord(_b)] = _i


def _codes(strings: Sequence[str]):
    lens = np.asarray([len(s) for s in strings], np.int64)
    width = int(lens.max(initial=0))
    mat = np.full((len(strings), max(width, 1)), 5, np.int64)
    for i, s in enumerate(strings):
        if s:
            mat[i, :len(s)] = _CODE[np.frombuffer(s.encode(), np.uint8)]
    return mat, lens


def edit_distances(hyps: Sequence[str], refs: Sequence[str]) -> np.ndarray:
    """Levenshtein distance of each pair: one DP wavefront over all pairs,
    the in-row insertion recurrence as a min-plus prefix scan."""
    h, h_len = _codes(hyps)
    r, r_len = _codes(refs)
    b = len(hyps)
    max_h = int(h_len.max(initial=0))
    max_r = int(r_len.max(initial=0))
    cols = np.arange(max_r + 1)
    prev = np.broadcast_to(cols, (b, max_r + 1)).copy()
    out = np.where(h_len == 0, r_len, 0)
    ref_mat = r[:, :max_r]
    for i in range(1, max_h + 1):
        sub = prev[:, :-1] + (ref_mat != h[:, i - 1:i])
        cand = np.minimum(prev[:, 1:] + 1, sub)
        e = np.concatenate([np.full((b, 1), i, np.int64), cand], axis=1) - cols
        cur = np.minimum.accumulate(e, axis=1) + cols
        done = h_len == i
        if done.any():
            out[done] = cur[done, r_len[done]]
        prev = cur
    return out


def window_edit(observed: Sequence[str], reference: Sequence[str]) -> float:
    total = sum(len(s) for s in reference)
    return float(edit_distances(observed, reference).sum()) / max(total, 1)


def read_numbers(observed: Dict[str, Dict], reference: Dict[str, Dict]) -> Dict[str, float]:
    """The call cells' numbers over the sampled reads.

    ``observed[name]``: ``segments`` (the decodes a read's segment file
    holds, in window order), ``consensus`` and ``quality`` (its fastq);
    ``reference[name]``: ``segments`` and ``probs`` of the same windows."""
    obs_segs: List[str] = []
    ref_segs: List[str] = []
    diff = 0
    qgap = 0.0
    qn = 0
    for name, obs in observed.items():
        ref = reference[name]
        if len(obs["segments"]) != len(ref["segments"]):
            raise ValueError(f"{name}: {len(obs['segments'])} window decodes written, "
                             f"{len(ref['segments'])} windows in the read")
        obs_segs += obs["segments"]
        ref_segs += ref["segments"]
        counts, qsum = assembly.assemble(obs["segments"], ref["probs"])
        cons = assembly.consensus(counts)
        qref = assembly.quality_values(counts, qsum)
        seq, qual = obs["consensus"], obs["quality"]
        n = min(len(seq), len(cons))
        diff += abs(len(seq) - len(cons)) + sum(a != b for a, b in zip(seq[:n], cons[:n]))
        qobs = np.frombuffer(qual.encode(), np.uint8).astype(int)[:n] - 33
        qgap += float(np.abs(qobs - qref[:n]).sum())
        qn += n
    return {"window_edit": window_edit(obs_segs, ref_segs),
            "consensus_diff": float(diff),
            "quality_gap": qgap / max(qn, 1)}
