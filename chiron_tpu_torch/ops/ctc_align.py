"""CTC forced alignment: best blank-interleaved path for a KNOWN label
sequence through a log-prob lattice.

A copy of ``chiron_tpu/ops/ctc_align.py`` (numpy only), so that the port
imports nothing of the JAX package; the tests hold the two copies to the
same outputs.

The training-label bootstrap (make_bundled_models --stage realdata) needs
per-base signal segmentations for the reference's real reads. Pore-model
DTW gives a first coarse pass; this refines it with the model's own
evidence: the Viterbi path of the golden base sequence through the
model's per-frame CTC posteriors (the standard forced-alignment used to
build frame labels in speech pipelines). The reference has no equivalent
(its labels come from the vendored cwDTW binary + a genome alignment,
chiron/chiron_label.py:255-277); this is the framework's replacement when
only basecalls, not a reference genome, are available.

Pure numpy — an offline label-prep tool, not on the basecall hot path.
"""

from __future__ import annotations

import numpy as np

NEG = np.float32(-1e30)


def forced_align(log_probs: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Viterbi-align ``labels`` to a CTC log-prob lattice.

    Args:
      log_probs: [T, C] per-frame log-probabilities; blank is class C-1.
      labels: [U] int label sequence (0..C-2), U >= 1, U <= T.

    Returns:
      starts [U+1]: frame of each label's FIRST emission; starts[U] = T.
    """
    lp = np.asarray(log_probs, np.float32)
    labels = np.asarray(labels, np.int64)
    t_max, nclass = lp.shape
    blank = nclass - 1
    u = len(labels)
    assert 1 <= u <= t_max, (u, t_max)
    s_len = 2 * u + 1
    # z[s]: blank at even s, labels[s//2] at odd s
    z = np.full(s_len, blank, np.int64)
    z[1::2] = labels
    # skip transition s-2 -> s allowed for odd s with distinct labels
    can_skip = np.zeros(s_len, bool)
    can_skip[1::2] = True
    can_skip[3::2] &= labels[1:] != labels[:-1]

    alpha = np.full(s_len, NEG, np.float32)
    alpha[0] = lp[0, blank]
    alpha[1] = lp[0, z[1]]
    moves = np.zeros((t_max, s_len), np.int8)
    for t in range(1, t_max):
        stay = alpha
        diag = np.concatenate([[NEG], alpha[:-1]])
        skip = np.concatenate([[NEG, NEG], alpha[:-2]])
        skip = np.where(can_skip, skip, NEG)
        best = np.maximum(np.maximum(stay, diag), skip)
        mv = np.zeros(s_len, np.int8)
        mv[diag > stay] = 1
        mv[(skip > stay) & (skip > diag)] = 2
        moves[t] = mv
        alpha = best + lp[t, z]
    # end in the last blank or last label
    s = s_len - 1 if alpha[s_len - 1] >= alpha[s_len - 2] else s_len - 2
    starts = np.zeros(u + 1, np.int64)
    starts[u] = t_max
    for t in range(t_max - 1, 0, -1):
        mv = int(moves[t][s])
        if s % 2 == 1 and mv > 0:
            # entering label s//2 at frame t via diag/skip => t is its start
            starts[s // 2] = t
        s -= mv
    if s % 2 == 1:  # path begins inside label s//2 (no leading blank)
        starts[s // 2] = 0
    return starts


def chunked_forced_align(
    log_probs: np.ndarray,
    labels: np.ndarray,
    coarse_starts: np.ndarray,
    chunk: int = 4000,
) -> np.ndarray:
    """Forced alignment of a long read in chunks anchored by a coarse pass.

    ``coarse_starts`` [U+1] (e.g. from tools.resquiggle) assigns each label
    to the chunk containing its coarse start; each chunk is then aligned
    independently (frames [c0, c1) x its label subrange), keeping the DP
    linear in read length. Returns refined starts [U+1] in frame space.
    """
    lp = np.asarray(log_probs, np.float32)
    t_max = len(lp)
    labels = np.asarray(labels, np.int64)
    u = len(labels)
    coarse = np.asarray(coarse_starts, np.int64)
    starts = np.zeros(u + 1, np.int64)
    starts[u] = t_max
    bounds = list(range(0, t_max, chunk)) + [t_max]
    for i in range(len(bounds) - 1):
        c0, c1 = bounds[i], bounds[i + 1]
        u_lo = int(np.searchsorted(coarse[:u], c0, side="left"))
        u_hi = int(np.searchsorted(coarse[:u], c1, side="left"))
        if u_hi <= u_lo:
            continue
        n_frames = c1 - c0
        n_lab = u_hi - u_lo
        if n_lab > n_frames:  # degenerate coarse pass; keep coarse
            starts[u_lo:u_hi] = coarse[u_lo:u_hi]
            continue
        sub = forced_align(lp[c0:c1], labels[u_lo:u_hi])
        starts[u_lo:u_hi] = sub[:-1] + c0
    # NOTE: the first label is defined to absorb any leading blank region
    # (starts[0] = 0), unlike unchunked forced_align which places it after
    # leading blanks. Bootstrap windowing clips label 0's dwell anyway, and
    # a whole-read-coordinate 0 keeps chunk boundaries monotone.
    starts[0] = 0
    # enforce monotonicity across chunk boundaries
    np.maximum.accumulate(starts, out=starts)
    starts[u] = t_max
    return starts
