"""Plain PyTorch CTC prefix beam search: the reference decoder.

The search of the program's decoder as its semantics are defined
(``chiron_tpu_torch/ops/beam.py``, after the JAX package's
``ops/ctc_beam.py:beam_search_decode``): separate blank-ending and
non-blank-ending log masses a beam, ``length_bonus`` added to every extend
(a merged extend's mass included), extends merged into stays by a 32-bit
rolling prefix hash, the exact top-W with ties to the lowest candidate
index in the pool [stays | extends by label 0 | ...], rows frozen past
their length; then the traceback of the best beam and the compaction of its
labels. A frozen copy of the program's plain versions, vectorised over the
rows, so it runs on the card over many windows in one pass.
"""

from __future__ import annotations

import torch

_NEG = -1e30
_MULT = 2654435761
_MASK = 0xFFFFFFFF


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
    """The search over log-probabilities lp [B, T, C] (blank = C-1): (trace
    [B, T, W] int32 packed (char+1)*W + parent, pb [B, W], pnb [B, W])."""
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
    """Follow the best beam's parent chain: chars [B, T] int32, -1 = none."""
    bsz, t_max, w = trace.shape
    cur = best.to(torch.int64)[:, None]
    chars = torch.empty((bsz, t_max), dtype=torch.int32, device=trace.device)
    for t in range(t_max - 1, -1, -1):
        v = torch.gather(trace[:, t, :], 1, cur)[:, 0]
        chars[:, t] = torch.div(v, w, rounding_mode="floor") - 1
        cur = (v % w).to(torch.int64)[:, None]
    return chars


def compact_labels(classes: torch.Tensor, keep: torch.Tensor):
    """Front-pack kept labels, -1 padded; returns (decoded, lengths)."""
    b, t = classes.shape
    tidx = torch.arange(t, device=classes.device)[None, :]
    key = torch.where(keep, tidx, t + tidx)
    order = torch.argsort(key, dim=1, stable=True)
    decoded = torch.gather(classes.to(torch.int32), 1, order)
    lengths = keep.sum(dim=1).to(torch.int32)
    decoded = torch.where(tidx < lengths[:, None], decoded, torch.full_like(decoded, -1))
    return decoded, lengths


def decode(logits: torch.Tensor, lengths: torch.Tensor, beam_width: int,
           length_bonus: float = 0.0):
    """Logits [B, T, C] (blank last) -> (labels [B, T] int32 front-packed, -1
    padded; lengths [B] int32; the best beam's log mass [B])."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    trace, pb, pnb = beam_search_plain(lp, lengths.to(torch.int32), beam_width, length_bonus)
    final = _lae(pb, pnb)
    best = torch.argmax(final, dim=1)
    log_prob = torch.gather(final, 1, best[:, None])[:, 0]
    chars = beam_traceback_plain(trace, best.to(torch.int32))
    decoded, dlen = compact_labels(chars, chars >= 0)
    return decoded, dlen, log_prob


def path_prob(logits: torch.Tensor) -> torch.Tensor:
    """A window's mean (top1 - top2) logit gap over all its frames
    (chiron/chiron_eval.py:116-136), the quality a window lends its bases."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).mean(dim=-1)
