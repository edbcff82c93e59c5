"""CRF decode of a linear-chain basecaller (CUDA kernels + plain version).

The decode of Bonito's CTC-CRF models (github.com/nanoporetech/bonito,
``bonito/crf/model.py``: ``CTC_CRF`` and its ``decode_batch``), for scores
``z`` [B, T, 4 S] of S = 4^state_len states. A frame's edge scores are
M[t, s, c] for c = 0..4: column 0 is the constant ``blank_score`` (a stay),
and column k + 1 is ``z[b, t, 4 s + k]``. The predecessor of state s through
column 0 is s itself, through column k + 1 it is ``k S / 4 + s // 4``
(``CTC_CRF.idx``): emitting base k shifts it in at the front of the state.

Per row, over its own ``lengths[b]`` frames n only:

- forward ``alpha_0 = 0``, ``alpha_{t+1}[s] = logsumexp_c(alpha_t[pred(s, c)]
  + M[t, s, c])``; backward ``beta_n = 0``, the same recursion in reverse;
  ``logZ = logsumexp_s(beta_0[s])`` (alpha_0 is 0);
- edge posteriors ``P[t, s, c] = exp(alpha_t[pred(s, c)] + M[t, s, c] +
  beta_{t+1}[s] - logZ)``;
- Viterbi by max-plus over ``log(P + 1e-8)`` from ``v_0 = 0``, ties to the
  lowest column and, at the end, to the lowest state; the frame's label is
  the best path's column (1..4 emit "ACGT"[c - 1], 0 emits nothing);
- ``score``: the best path's sum of ``log(P + 1e-8)``; ``prob``: the mean over
  the row's frames of the gap between the largest and the second largest
  ``log(P + 1e-8)`` of the frame's 5 S edges, the CRF's counterpart of the
  CTC path probability ``path_prob``.

``crf_decode`` launches ``csrc/crf.cu`` for CUDA tensors and runs
``crf_decode_plain`` for CPU tensors. The kernels never hold the [B, T, 5 S]
posteriors: ``crf_beta_kernel`` scans each row backwards and stores beta
[B, T + 1, S]; ``crf_viterbi_kernel`` scans forwards, keeps alpha and the
Viterbi scores of the current frame on chip, forms each frame's posteriors
from them and beta, and stores one byte of traceback a (frame, state);
``crf_traceback_kernel`` follows the best path back, one thread a row.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.ctc_greedy import compact_labels

POSTERIOR_EPS = 1e-8
# csrc/crf.cu holds up to 4^5 states (state_len 1..5)
MAX_STATE_LEN = 5

# launches of each CUDA kernel (plain-version calls on the CPU are not counted)
launches = {"crf_beta": 0, "crf_viterbi": 0, "crf_traceback": 0}
# frames decoded on the card, summed on the device (no host sync a step):
# device -> int64 tensor; read with ``frames_decoded()``
_frames: Dict[torch.device, torch.Tensor] = {}


def frames_decoded() -> int:
    """The frames the CUDA kernels decoded (each row's own), over every device."""
    return int(sum(int(v.item()) for v in _frames.values()))


def n_states(scores: torch.Tensor) -> int:
    """S from the scores' last dimension 4 S (4^(state_len + 1))."""
    s4 = scores.shape[-1]
    s = s4 // 4
    state_len = s.bit_length() // 2
    if s4 != 4 * s or s != 4 ** state_len or not 1 <= state_len <= MAX_STATE_LEN:
        raise ValueError(f"crf: the scores' last dimension must be 4^(state_len + 1) with "
                         f"state_len 1..{MAX_STATE_LEN}, got {s4}")
    return s


def predecessors(s_count: int, device=None) -> torch.Tensor:
    """pred [S, 5]: the state each edge (s, c) comes from (``CTC_CRF.idx``)."""
    s = torch.arange(s_count, device=device)
    n = s_count // 4
    return torch.stack([s] + [k * n + s // 4 for k in range(4)], dim=1)


def successors(s_count: int, device=None):
    """(state [S, 5], column [S, 5]) of the edges that leave each state: the
    stay, and the 4 states 4 (s % (S / 4)) + j that s moves to by column
    s // (S / 4) + 1."""
    s = torch.arange(s_count, device=device)
    n = s_count // 4
    state = torch.stack([s] + [4 * (s % n) + j for j in range(4)], dim=1)
    col = torch.stack([torch.zeros_like(s)] + [s // n + 1] * 4, dim=1)
    return state, col


def edge_scores(zt: torch.Tensor, blank_score: float) -> torch.Tensor:
    """M[t] [B, S, 5] of one frame's scores zt [B, 4 S]."""
    m = zt.float().reshape(zt.shape[0], -1, 4)
    return torch.cat([m.new_full(m.shape[:2] + (1,), blank_score), m], dim=2)


def crf_beta_plain(z: torch.Tensor, lengths: torch.Tensor, blank_score: float) -> torch.Tensor:
    """beta [B, T + 1, S]: zero at and past each row's length."""
    bsz, t_max, _ = z.shape
    s_count = n_states(z)
    st, col = successors(s_count, z.device)
    beta = z.new_zeros((bsz, t_max + 1, s_count), dtype=torch.float32)
    rows = torch.arange(bsz, device=z.device)[:, None, None]
    for t in range(t_max - 1, -1, -1):
        m = edge_scores(z[:, t], blank_score)
        nxt = beta[:, t + 1]
        new = torch.logsumexp(nxt[:, st] + m[rows, st, col], dim=2)
        beta[:, t] = torch.where((t < lengths)[:, None], new, torch.zeros_like(new))
    return beta


def crf_forward_plain(z: torch.Tensor, lengths: torch.Tensor, beta: torch.Tensor,
                      blank_score: float, posteriors: bool = False):
    """(traceback [B, T, S] uint8, score [B], prob [B], final state [B], and
    log(P + 1e-8) [B, T, S, 5] with ``posteriors``, else None)."""
    bsz, t_max, _ = z.shape
    s_count = beta.shape[2]
    pred = predecessors(s_count, z.device)
    log_z = torch.logsumexp(beta[:, 0], dim=1)
    alpha = z.new_zeros((bsz, s_count), dtype=torch.float32)
    v = torch.zeros_like(alpha)
    tb = torch.zeros((bsz, t_max, s_count), dtype=torch.uint8, device=z.device)
    gap = torch.zeros(bsz, dtype=torch.float32, device=z.device)
    post = z.new_zeros((bsz, t_max, s_count, 5), dtype=torch.float32) if posteriors else None
    for t in range(t_max):
        live = (t < lengths)[:, None]
        a = alpha[:, pred] + edge_scores(z[:, t], blank_score)
        lp = a + beta[:, t + 1, :, None] - log_z[:, None, None]
        lpe = torch.log(torch.exp(lp) + POSTERIOR_EPS)
        w = v[:, pred] + lpe
        best, arg = torch.max(w, dim=2)  # first max: the lowest column on ties
        alpha = torch.where(live, torch.logsumexp(a, dim=2), alpha)
        v = torch.where(live, best, v)
        tb[:, t] = torch.where(live, arg, torch.zeros_like(arg)).to(torch.uint8)
        top2 = torch.topk(lpe.reshape(bsz, -1), 2, dim=1).values
        gap = gap + torch.where(live[:, 0], top2[:, 0] - top2[:, 1], torch.zeros_like(gap))
        if post is not None:
            post[:, t] = torch.where(live[:, :, None], lpe, torch.zeros_like(lpe))
    score, final = torch.max(v, dim=1)  # the lowest state on ties
    prob = gap / torch.clamp(lengths, min=1).float()
    return tb, score, prob, final, post


def crf_traceback_plain(tb: torch.Tensor, final: torch.Tensor, lengths: torch.Tensor
                        ) -> torch.Tensor:
    """The best path's column a frame [B, T] int32, -1 past each length."""
    bsz, t_max, s_count = tb.shape
    pred = predecessors(s_count, tb.device)
    path = torch.full((bsz, t_max), -1, dtype=torch.int32, device=tb.device)
    rows = torch.arange(bsz, device=tb.device)
    s = final.long()
    for t in range(t_max - 1, -1, -1):
        live = t < lengths
        c = tb[rows, t, s].long()
        path[:, t] = torch.where(live, c, torch.full_like(c, -1)).to(torch.int32)
        s = torch.where(live, pred[s, c], s)
    return path


def crf_decode_plain(z: torch.Tensor, lengths: torch.Tensor, blank_score: float):
    """Plain PyTorch version of the kernels: (path [B, T] int32, score [B],
    prob [B])."""
    beta = crf_beta_plain(z, lengths, blank_score)
    tb, score, prob, final, _ = crf_forward_plain(z, lengths, beta, blank_score)
    return crf_traceback_plain(tb, final, lengths), score, prob


def _check(z: torch.Tensor, lengths: torch.Tensor) -> torch.device:
    if z.dim() != 3 or z.dtype != torch.float32:
        raise ValueError(f"crf: scores must be float32 [B, T, 4S], got {z.dtype} "
                         f"{tuple(z.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (z.shape[0],) \
            or lengths.device != z.device:
        raise ValueError("crf: lengths must be int32 [B] on the scores' device")
    n_states(z)
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"crf: unsupported device {z.device}")
    return z.device


def crf_beta(z: torch.Tensor, lengths: torch.Tensor, blank_score: float) -> torch.Tensor:
    """``crf_beta_kernel`` on checked CUDA inputs (contiguous float32 scores,
    int32 lengths): beta [B, T + 1, S], as ``crf_beta_plain``."""
    bsz, t_max, _ = z.shape
    beta = torch.empty((bsz, t_max + 1, n_states(z)), dtype=torch.float32, device=z.device)
    lib = cuda_build.load("crf")
    with cuda_build.on_device(z.device):
        rc = lib.crf_beta_launch(z.data_ptr(), lengths.data_ptr(), beta.data_ptr(), bsz,
                                 t_max, beta.shape[2], float(blank_score),
                                 torch.cuda.current_stream(z.device).cuda_stream)
        cuda_build.check(rc, "crf_beta_kernel")
        launches["crf_beta"] += 1
    return beta


def crf_viterbi(z: torch.Tensor, lengths: torch.Tensor, beta: torch.Tensor,
                blank_score: float, posteriors: Optional[torch.Tensor] = None):
    """``crf_viterbi_kernel``: (traceback [B, T, S] uint8, score [B], prob [B],
    final state [B] int32), as ``crf_forward_plain``. ``posteriors`` (float32
    [B, T, S, 5] or None) receives log(P + 1e-8) of every (frame, state,
    column) of each row's frames: for the tests only."""
    dev = z.device
    bsz, t_max, s_count = beta.shape[0], beta.shape[1] - 1, beta.shape[2]
    if posteriors is not None and (posteriors.shape != (bsz, t_max, s_count, 5)
                                   or posteriors.dtype != torch.float32
                                   or not posteriors.is_contiguous()):
        raise ValueError("crf: posteriors must be contiguous float32 [B, T, S, 5]")
    tb = torch.empty((bsz, t_max, s_count), dtype=torch.uint8, device=dev)
    score = torch.empty(bsz, dtype=torch.float32, device=dev)
    prob = torch.empty_like(score)
    final = torch.empty(bsz, dtype=torch.int32, device=dev)
    lib = cuda_build.load("crf")
    with cuda_build.on_device(dev):
        rc = lib.crf_viterbi_launch(z.data_ptr(), lengths.data_ptr(), beta.data_ptr(),
                                    tb.data_ptr(), score.data_ptr(), prob.data_ptr(),
                                    final.data_ptr(),
                                    None if posteriors is None else posteriors.data_ptr(),
                                    bsz, t_max, s_count, float(blank_score),
                                    torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(rc, "crf_viterbi_kernel")
        launches["crf_viterbi"] += 1
    return tb, score, prob, final


def crf_traceback(tb: torch.Tensor, final: torch.Tensor, lengths: torch.Tensor
                  ) -> torch.Tensor:
    """``crf_traceback_kernel``: the best path's column a frame [B, T] int32,
    -1 past each length, as ``crf_traceback_plain``."""
    bsz, t_max, s_count = tb.shape
    path = torch.empty((bsz, t_max), dtype=torch.int32, device=tb.device)
    lib = cuda_build.load("crf")
    with cuda_build.on_device(tb.device):
        rc = lib.crf_traceback_launch(tb.data_ptr(), final.data_ptr(), lengths.data_ptr(),
                                      path.data_ptr(), bsz, t_max, s_count,
                                      torch.cuda.current_stream(tb.device).cuda_stream)
        cuda_build.check(rc, "crf_traceback_kernel")
        launches["crf_traceback"] += 1
    return path


def crf_kernels(z: torch.Tensor, lengths: torch.Tensor, blank_score: float,
                posteriors: Optional[torch.Tensor] = None):
    """The three kernels on CUDA tensors: (path [B, T] int32, score [B],
    prob [B], beta [B, T + 1, S]); ``posteriors`` as ``crf_viterbi``'s."""
    z = z.contiguous()
    lengths = lengths.contiguous()
    beta = crf_beta(z, lengths, blank_score)
    tb, score, prob, final = crf_viterbi(z, lengths, beta, blank_score, posteriors)
    path = crf_traceback(tb, final, lengths)
    dev, t_max = z.device, z.shape[1]
    count = lengths.clamp(0, t_max).sum(dtype=torch.int64)
    _frames[dev] = _frames[dev] + count if dev in _frames else count
    return path, score, prob, beta


def crf_decode(scores: torch.Tensor, lengths: torch.Tensor, blank_score: float):
    """Decode scores [B, T, 4 S] float32 over each row's ``lengths`` frames.

    Returns (decoded [B, T] int32 bases 0..3 front-packed, -1 padded;
    lengths [B] int32; score [B] the Viterbi path's; prob [B] the mean
    posterior gap), the outputs of the CTC decoders."""
    dev = _check(scores, lengths)
    if dev.type == "cpu":
        path, score, prob = crf_decode_plain(scores, lengths, blank_score)
    else:
        path, score, prob, _ = crf_kernels(scores, lengths, blank_score)
    decoded, n = compact_labels(path - 1, path >= 1)
    return decoded, n, score, prob


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.crf_beta_launch.argtypes = [vp] * 3 + [ci] * 3 + [cf, vp]
    lib.crf_beta_launch.restype = ci
    lib.crf_viterbi_launch.argtypes = [vp] * 8 + [ci] * 3 + [cf, vp]
    lib.crf_viterbi_launch.restype = ci
    lib.crf_traceback_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.crf_traceback_launch.restype = ci


cuda_build.register("crf", _declare)
