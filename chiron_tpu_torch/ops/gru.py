"""GRU layers for inference (CUDA kernel + plain versions) and the
differentiable step loop for training.

Port of ``chiron_tpu/ops/pallas/gru.py``: ``bigru_layer`` (both directions,
``bigru_layer_pallas``) and ``gru_layer`` (one direction,
``gru_layer_pallas``), over the precomputed input projections
``gx = x @ wx_g + b_g`` ([T, B, 2H], columns r then u) and
``cx = x @ wx_c + b_c`` ([T, B, H]) with the recurrent kernels ``whg``
[H, 2H] and ``whc`` [H, H] (tf.nn.rnn_cell.GRUCell):

    [r, u] = sigmoid(gx[t] + h @ whg)
    cand   = tanh(cx[t] + (r * h) @ whc)
    h'     = u * h + (1 - u) * cand

Row b is active on ``starts[b] <= t < starts[b] + lengths[b]``; outside it
the state is frozen and the output zero. The fused layer's backward
direction reads the time-flipped sequence with ``starts = T - lengths``.

The wrappers launch ``csrc/gru.cu`` for CUDA tensors and run the plain
versions for CPU tensors. ``gru_scan`` is that plain step loop, written
without in-place updates so that autograd differentiates it: the training
path uses it, as the JAX package trains the GRU through ``lax.scan``
outside any kernel. H is handled directly (no padding to 128 lanes).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.lstm import check_cuda_size, check_recurrent_inputs

# launches of each CUDA entry point (plain-version calls are not counted)
launches = {"bigru": 0, "gru": 0}


def gru_scan(gx, cx, whg, whc, lo, hi):
    """The GRU recurrence as a differentiable step loop. ``lo``/``hi``: [B]
    bounds of each row's active window."""
    t_max, bsz, h_dim = cx.shape
    h = cx.new_zeros((bsz, h_dim))
    zero = cx.new_zeros((bsz, h_dim))
    outs = []
    for t in range(t_max):
        r, u = torch.sigmoid(gx[t] + h @ whg).split(h_dim, dim=1)
        cand = torch.tanh(cx[t] + (r * h) @ whc)
        nh = u * h + (1.0 - u) * cand
        m = ((lo <= t) & (t < hi))[:, None]
        h = torch.where(m, nh, h)
        outs.append(torch.where(m, nh, zero))
    return torch.stack(outs)


def gru_layer_plain(gx, cx, whg, whc, lengths, starts=None):
    """Plain PyTorch version of the one-direction kernel."""
    lo = torch.zeros_like(lengths) if starts is None else starts
    return gru_scan(gx, cx, whg, whc, lo, lo + lengths)


def bigru_layer_plain(gx_fw, cx_fw, gx_bw, cx_bw, wh_fw, wh_bw, lengths, starts_bw):
    """Plain PyTorch version of the fused kernel."""
    return (gru_layer_plain(gx_fw, cx_fw, *wh_fw, lengths),
            gru_layer_plain(gx_bw, cx_bw, *wh_bw, lengths, starts_bw))


def _shapes(t_max, bsz, h_dim):
    return ((t_max, bsz, 2 * h_dim), (t_max, bsz, h_dim), (h_dim, 2 * h_dim), (h_dim, h_dim))


def _ptr(tsr):
    return None if tsr is None else tsr.data_ptr()


def gru_layer(gx: torch.Tensor, cx: torch.Tensor, whg: torch.Tensor, whc: torch.Tensor,
              lengths: torch.Tensor, starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU direction.

    Args:
      gx: [T, B, 2H], cx: [T, B, H], whg: [H, 2H], whc: [H, H], float32.
      lengths: [B] int32; starts: [B] int32 or None (every window from 0).
    Returns:
      hs [T, B, H] float32, zero outside each row's window.
    """
    t_max, bsz, h_dim = cx.shape
    dev = check_recurrent_inputs("gru_layer", (gx, cx, whg, whc), _shapes(t_max, bsz, h_dim),
                                 (lengths, starts), bsz)
    if dev.type == "cpu":
        return gru_layer_plain(gx, cx, whg, whc, lengths, starts)
    check_cuda_size("gru_layer", t_max, bsz, h_dim)
    args = [a.contiguous() for a in (gx, cx, whg, whc, lengths)]
    starts = None if starts is None else starts.contiguous()
    out = torch.empty((t_max, bsz, h_dim), dtype=torch.float32, device=dev)
    lib = cuda_build.load("gru")
    rc = lib.gru_launch(*[a.data_ptr() for a in args], _ptr(starts), out.data_ptr(), t_max, bsz,
                        h_dim, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "gru_layer")
    launches["gru"] += 1
    return out


def bigru_layer(gx_fw: torch.Tensor, cx_fw: torch.Tensor, gx_bw: torch.Tensor,
                cx_bw: torch.Tensor, wh_fw: Tuple[torch.Tensor, torch.Tensor],
                wh_bw: Tuple[torch.Tensor, torch.Tensor], lengths: torch.Tensor,
                starts_bw: torch.Tensor):
    """Both directions of one GRU layer.

    Args:
      gx_*: [T, B, 2H], cx_*: [T, B, H] float32; the backward pair are
        projections of the time-flipped input.
      wh_fw, wh_bw: (whg [H, 2H], whc [H, H]) per direction.
      lengths, starts_bw: [B] int32 (starts_bw = T - lengths).
    Returns:
      (hs_fw, hs_bw) each [T, B, H], zero outside each row's window; hs_bw
      is in flipped time order (the caller flips back).
    """
    t_max, bsz, h_dim = cx_fw.shape
    floats = (gx_fw, cx_fw, *wh_fw, gx_bw, cx_bw, *wh_bw)
    dev = check_recurrent_inputs("bigru_layer", floats, _shapes(t_max, bsz, h_dim) * 2,
                                 (lengths, starts_bw), bsz)
    if dev.type == "cpu":
        return bigru_layer_plain(gx_fw, cx_fw, gx_bw, cx_bw, wh_fw, wh_bw, lengths, starts_bw)
    check_cuda_size("bigru_layer", t_max, bsz, h_dim)
    args = [a.contiguous() for a in (gx_fw, cx_fw, gx_bw, cx_bw, *wh_fw, *wh_bw, lengths,
                                     starts_bw)]
    out_f = torch.empty((t_max, bsz, h_dim), dtype=torch.float32, device=dev)
    out_b = torch.empty_like(out_f)
    lib = cuda_build.load("gru")
    rc = lib.bigru_launch(*[a.data_ptr() for a in args], out_f.data_ptr(), out_b.data_ptr(),
                          t_max, bsz, h_dim, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "bigru_layer")
    launches["bigru"] += 1
    return out_f, out_b


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bigru_launch.argtypes = [vp] * 12 + [ci] * 3 + [vp]
    lib.bigru_launch.restype = ci
    lib.gru_launch.argtypes = [vp] * 7 + [ci] * 3 + [vp]
    lib.gru_launch.restype = ci


cuda_build.register("gru", _declare)
