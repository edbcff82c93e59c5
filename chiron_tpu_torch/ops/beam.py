"""CTC prefix beam search: CUDA search + traceback kernels and plain versions.

Port of ``chiron_tpu/ops/pallas/beam.py:beam_search_pallas`` (search and
traceback kernels) with the semantics of its XLA twin
``chiron_tpu/ops/ctc_beam.py:beam_search_decode`` (which the Pallas kernel
matches exactly): separate blank-ending / non-blank-ending log masses per
beam, ``length_bonus`` added to every extend (merged extend mass
included), extends merged into stays by a 32-bit rolling prefix hash, the
exact top-W with ties to the lowest candidate index in the pool layout
[stays | extends by label 0 | ...], and rows past their length frozen.

``beam_search`` and ``beam_traceback`` launch ``csrc/beam.cu`` for CUDA
tensors and run their plain versions for CPU tensors. The hash is uint32
arithmetic that wraps; the plain version keeps it in int64 masked to 32
bits, since torch has no wrapping uint32 multiply.
"""

from __future__ import annotations

import ctypes

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.ctc_greedy import compact_labels

_NEG = -1e30
_MULT = 2654435761
_MASK = 0xFFFFFFFF
MAX_WIDTH = 64
MAX_CLASSES = 8

# launches of each CUDA kernel (plain-version calls on the CPU are not counted)
launches = {"beam_search": 0, "beam_traceback": 0}


def _lae(a, b):
    """logaddexp guarded for the -1e30 sentinel."""
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return torch.where(mx <= _NEG, torch.full_like(mx, _NEG),
                       mx + torch.log1p(torch.exp(mn - mx)))


def _hash_mul(h):
    """(h * 2654435761) mod 2^32 for int64 h in [0, 2^32), without overflow."""
    lo = h & 0xFFFF
    hi = h >> 16
    return (lo * _MULT + (((hi * _MULT) & 0xFFFF) << 16)) & _MASK


def beam_search_plain(lp, lens, beam_width: int, length_bonus: float = 0.0):
    """Plain PyTorch version of the search kernel: same inputs, same outputs."""
    bsz, t_max, nclass = lp.shape
    w = beam_width
    nlab = nclass - 1  # blank is the last class
    dev = lp.device
    widx = torch.arange(w, device=dev)
    pb = torch.full((bsz, w), _NEG, dtype=torch.float32, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((bsz, w), _NEG, dtype=torch.float32, device=dev)
    h = torch.where(widx == 0, 1, widx * 7919 + 3).expand(bsz, w).clone()
    last = torch.full((bsz, w), -1, dtype=torch.int64, device=dev)
    labels = torch.arange(nlab, device=dev)
    trace = torch.empty((bsz, t_max, w), dtype=torch.int32, device=dev)
    neg_ext = torch.full((bsz, nlab * w), _NEG, dtype=torch.float32, device=dev)
    lens = lens.to(torch.int64)
    for t in range(t_max):
        lp_cur = lp[:, t, :]
        lp_blank = lp_cur[:, nlab:nlab + 1]
        lp_last = torch.gather(lp_cur, 1, last.clamp(0, nlab - 1))
        pbnb = _lae(pb, pnb)
        stay_pb = pbnb + lp_blank
        stay_pnb = torch.where(last >= 0, pnb + lp_last, torch.full_like(pnb, _NEG))
        same = labels[None, :, None] == last[:, None, :]
        base = torch.where(same, pb[:, None, :], pbnb[:, None, :])
        ext_pnb = lp_cur[:, :nlab, None] + base + length_bonus  # [B, nlab, W]
        ext_h = (_hash_mul(h)[:, None, :] + labels[None, :, None] + 1) & _MASK
        # eq[b, e, y]: extend e = c*W + x produces stay y's prefix
        eq = (ext_h.reshape(bsz, nlab * w)[:, :, None] == h[:, None, :])
        ext_flat = ext_pnb.reshape(bsz, nlab * w)
        contrib = torch.where(eq, ext_flat[:, :, None], _NEG)
        mmax = contrib.max(dim=1).values  # [B, W]
        msum = torch.exp(torch.where(eq, contrib - mmax[:, None, :], _NEG)).sum(dim=1)
        merged = torch.where(mmax > _NEG / 2,
                             mmax + torch.log(torch.clamp(msum, min=1e-37)),
                             torch.full_like(mmax, _NEG))
        stay_pnb = _lae(stay_pnb, merged)
        ext_flat = torch.where(eq.any(dim=2), _NEG, ext_flat)
        cand_pb = torch.cat([stay_pb, neg_ext], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_flat], dim=1)
        score = _lae(cand_pb, cand_pnb)
        top = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :w]
        is_stay = top < w
        parent = torch.where(is_stay, top, (top - w) % w)
        char = torch.where(is_stay, -1, (top - w) // w)
        p_h = torch.gather(h, 1, parent)
        new_h = torch.where(is_stay, p_h, (_hash_mul(p_h) + char + 1) & _MASK)
        new_last = torch.where(is_stay, torch.gather(last, 1, parent), char)
        active = (t < lens)[:, None]
        trace[:, t] = torch.where(active, (char + 1) * w + parent, widx).to(torch.int32)
        pb = torch.where(active, torch.gather(cand_pb, 1, top), pb)
        pnb = torch.where(active, torch.gather(cand_pnb, 1, top), pnb)
        h = torch.where(active, new_h, h)
        last = torch.where(active, new_last, last)
    return trace, pb, pnb


def beam_traceback_plain(trace, best):
    """Plain PyTorch version of the traceback kernel."""
    bsz, t_max, w = trace.shape
    cur = best.to(torch.int64)[:, None]
    chars = torch.empty((bsz, t_max), dtype=torch.int32, device=trace.device)
    for t in range(t_max - 1, -1, -1):
        v = torch.gather(trace[:, t, :], 1, cur)[:, 0]
        chars[:, t] = torch.div(v, w, rounding_mode="floor") - 1
        cur = (v % w).to(torch.int64)[:, None]
    return chars


def beam_search(lp: torch.Tensor, lens: torch.Tensor, beam_width: int,
                length_bonus: float = 0.0):
    """Search over log-probabilities lp [B, T, C] (blank = C-1).

    Returns (trace [B, T, W] int32 packed (char+1)*W + parent,
    pb [B, W], pnb [B, W] final blank / non-blank log masses).
    """
    bsz, t_max, nclass = lp.shape
    dev = lp.device
    if lp.dtype != torch.float32 or lens.dtype != torch.int32 or lens.shape != (bsz,) \
            or lens.device != dev:
        raise ValueError("beam_search: lp float32 [B,T,C], lens int32 [B] on one device")
    if not 1 <= beam_width <= MAX_WIDTH or not 2 <= nclass <= MAX_CLASSES:
        raise ValueError(f"beam_search: width <= {MAX_WIDTH}, classes <= {MAX_CLASSES}")
    if dev.type == "cpu":
        return beam_search_plain(lp, lens, beam_width, length_bonus)
    if dev.type != "cuda":
        raise ValueError(f"beam_search: unsupported device {dev}")
    lp = lp.contiguous()
    lens = lens.contiguous()
    trace = torch.empty((bsz, t_max, beam_width), dtype=torch.int32, device=dev)
    pb = torch.empty((bsz, beam_width), dtype=torch.float32, device=dev)
    pnb = torch.empty_like(pb)
    lib = cuda_build.load("beam")
    rc = lib.beam_search_launch(lp.data_ptr(), lens.data_ptr(), trace.data_ptr(),
                                pb.data_ptr(), pnb.data_ptr(), bsz, t_max, nclass,
                                beam_width, float(length_bonus),
                                torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "beam_search")
    launches["beam_search"] += 1
    return trace, pb, pnb


def beam_traceback(trace: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Follow the best beam's parent chain: chars [B, T] int32, -1 = none."""
    bsz, t_max, w = trace.shape
    dev = trace.device
    if trace.dtype != torch.int32 or best.dtype != torch.int32 or best.shape != (bsz,) \
            or best.device != dev:
        raise ValueError("beam_traceback: trace int32 [B,T,W], best int32 [B] on one device")
    if dev.type == "cpu":
        return beam_traceback_plain(trace, best)
    if dev.type != "cuda":
        raise ValueError(f"beam_traceback: unsupported device {dev}")
    trace = trace.contiguous()
    best = best.contiguous()
    chars = torch.empty((bsz, t_max), dtype=torch.int32, device=dev)
    lib = cuda_build.load("beam")
    rc = lib.beam_traceback_launch(trace.data_ptr(), best.data_ptr(), chars.data_ptr(),
                                   bsz, t_max, w,
                                   torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "beam_traceback")
    launches["beam_traceback"] += 1
    return chars


def beam_search_decode(logits: torch.Tensor, seq_lengths: torch.Tensor,
                       beam_width: int = 30, length_bonus: float = 0.0):
    """CTC prefix beam search over a batch of logits [B, T, C].

    Returns (decoded [B, T] int32 front-packed, -1 padded; lengths [B]
    int32; log_prob [B] of the best beam).
    """
    lp = torch.log_softmax(logits, dim=-1)
    trace, pb, pnb = beam_search(lp, seq_lengths.to(torch.int32), beam_width,
                                 length_bonus)
    final = _lae(pb, pnb)
    best = torch.argmax(final, dim=1)  # first max: lowest index on ties
    log_prob = torch.gather(final, 1, best[:, None])[:, 0]
    chars = beam_traceback(trace, best.to(torch.int32))
    decoded, lengths = compact_labels(chars, chars >= 0)
    return decoded, lengths, log_prob


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.beam_search_launch.argtypes = [vp] * 5 + [ci] * 4 + [ctypes.c_float, vp]
    lib.beam_search_launch.restype = ci
    lib.beam_traceback_launch.argtypes = [vp] * 3 + [ci] * 3 + [vp]
    lib.beam_traceback_launch.restype = ci


cuda_build.register("beam", _declare)
