"""Recurrent-batch-norm LSTM layers (arxiv 1603.09025) for inference (CUDA
kernel + plain versions) and the differentiable step loop for training.

Port of ``chiron_tpu/ops/pallas/bnlstm.py``: ``bibnlstm_layer`` (both
directions, ``bibnlstm_layer_pallas``) and ``bnlstm_layer`` (one direction,
``bnlstm_layer_pallas``), over the raw input projection ``xw = x @ wx``
WITHOUT bias ([T, B, 4H], gate order i, g, f, o, forget bias +1). Per step,
with BN(v) = (v - mean) * rsqrt(var + 1e-5) * scale and the moments taken
per column over the rows still active at that step (``t < lengths[b]``; the
count is at least 1):

    gates = BN_x(xw[t]) + BN_h(h @ wh) + b
    c'    = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
    h'    = sigmoid(o) * tanh(BN_c(c') + offset_c)

A row past its length keeps its state and puts out zero. There are no start
offsets: both directions mask on ``t < len`` and the caller reverses the
backward direction's input within each length (``reverse_sequence``),
because under a flip the moments would cover another set of rows.

The wrappers launch ``csrc/bnlstm.cu`` for CUDA tensors (one cooperative
launch per layer: every block must be resident for its grid-wide
exchanges, so the wrapper asks for larger row tiles when the launcher
reports that the grid does not fit, and raises when none fits) and run the
plain versions for CPU tensors. ``bnlstm_scan`` is that plain step loop,
written without in-place updates so that autograd differentiates it: the
training path uses it, as the JAX package trains this cell through
``lax.scan`` outside any kernel. H is handled directly (no padding to 128
lanes).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.lstm import check_cuda_size, check_recurrent_inputs

_FORGET_BIAS = 1.0
_BN_EPS = 1e-5
# batch rows per block the wrapper tries, smallest first
_ROW_TILES = (8, 16, 32, 64)
_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge

# launches of each CUDA entry point (plain-version calls are not counted)
launches = {"bibnlstm": 0, "bnlstm": 0}

Weights = Tuple[torch.Tensor, ...]  # (wh, b, scale_x, scale_h, scale_c, offset_c)


def _batch_norm_step(x, scale, m, count):
    mean = (x * m).sum(dim=0, keepdim=True) / count
    var = (((x - mean) ** 2) * m).sum(dim=0, keepdim=True) / count
    return (x - mean) * torch.rsqrt(var + _BN_EPS) * scale


def bnlstm_scan(xw, wh, b, scale_x, scale_h, scale_c, offset_c, lengths):
    """The recurrence as a differentiable step loop (two-pass moments, as
    the JAX package's ``_bnlstm_scan``)."""
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    h = xw.new_zeros((bsz, h_dim))
    c = xw.new_zeros((bsz, h_dim))
    outs = []
    for t in range(t_max):
        m = (t < lengths)[:, None].to(xw.dtype)
        count = m.sum().clamp(min=1.0)
        gates = (_batch_norm_step(xw[t], scale_x, m, count)
                 + _batch_norm_step(h @ wh, scale_h, m, count) + b)
        i, g, f, o = gates.split(h_dim, dim=1)
        nc = torch.sigmoid(f + _FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
        nh = torch.sigmoid(o) * torch.tanh(_batch_norm_step(nc, scale_c, m, count) + offset_c)
        c = m * nc + (1.0 - m) * c
        h = m * nh + (1.0 - m) * h
        outs.append(m * nh)
    return torch.stack(outs)


def bnlstm_layer_plain(xw, wh, b, scale_x, scale_h, scale_c, offset_c, lengths):
    """Plain PyTorch version of the one-direction kernel."""
    return bnlstm_scan(xw, wh, b, scale_x, scale_h, scale_c, offset_c, lengths)


def bibnlstm_layer_plain(xw_fw, xw_bw, fw_weights, bw_weights, lengths):
    """Plain PyTorch version of the fused kernel."""
    return (bnlstm_scan(xw_fw, *fw_weights, lengths), bnlstm_scan(xw_bw, *bw_weights, lengths))


def _shapes(t_max, bsz, h_dim):
    g = 4 * h_dim
    return ((t_max, bsz, g), (h_dim, g), (g,), (g,), (g,), (h_dim,), (h_dim,))


def _launch(entry: str, xws: Sequence[torch.Tensor], weights: Sequence[Weights],
            lengths: torch.Tensor):
    """Launch one layer (1 or 2 directions); returns the output tensors."""
    t_max, bsz, four_h = xws[0].shape
    h_dim = four_h // 4
    dev = xws[0].device
    dirs = len(xws)
    xws = [x.contiguous() for x in xws]
    whs = [w[0].contiguous() for w in weights]
    vecs = [torch.cat([v.reshape(-1) for v in w[1:]]) for w in weights]
    lengths = lengths.contiguous()
    outs = [torch.empty((t_max, bsz, h_dim), dtype=torch.float32, device=dev) for _ in xws]
    lib = cuda_build.load("bnlstm")
    fn = getattr(lib, f"{entry}_launch")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows in _ROW_TILES:
        tiles = -(-bsz // rows)
        scratch = torch.empty(dirs * (t_max * 8 * h_dim + tiles * (10 * h_dim + 2)),
                              dtype=torch.float32, device=dev)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        ptrs = [t.data_ptr() for group in (xws, whs, vecs) for t in group]
        rc = fn(*ptrs, lengths.data_ptr(), *[o.data_ptr() for o in outs], scratch.data_ptr(),
                bar.data_ptr(), t_max, bsz, h_dim, rows, stream)
        if rc != _TOO_LARGE:
            break
    else:
        raise RuntimeError(f"{entry}_layer: [T={t_max}, B={bsz}, H={h_dim}] does not fit the "
                           "card in one cooperative launch at any row tile")
    cuda_build.check(rc, f"{entry}_layer")
    launches[entry] += 1
    return outs


def bnlstm_layer(xw: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, scale_x: torch.Tensor,
                 scale_h: torch.Tensor, scale_c: torch.Tensor, offset_c: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """One recurrent-BN LSTM direction.

    Args:
      xw: [T, B, 4H] float32, x @ wx without bias; wh: [H, 4H];
      b, scale_x, scale_h: [4H]; scale_c, offset_c: [H]; lengths: [B] int32.
    Returns:
      hs [T, B, H] float32, zero past each length.
    """
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    weights = (wh, b, scale_x, scale_h, scale_c, offset_c)
    dev = check_recurrent_inputs("bnlstm_layer", (xw, *weights), _shapes(t_max, bsz, h_dim),
                                 (lengths,), bsz)
    if dev.type == "cpu":
        return bnlstm_layer_plain(xw, *weights, lengths)
    check_cuda_size("bnlstm_layer", t_max, bsz, h_dim)
    return _launch("bnlstm", (xw,), (weights,), lengths)[0]


def bibnlstm_layer(xw_fw: torch.Tensor, xw_bw: torch.Tensor, fw_weights: Weights,
                   bw_weights: Weights, lengths: torch.Tensor):
    """Both directions of one recurrent-BN LSTM layer.

    Args:
      xw_fw, xw_bw: [T, B, 4H] float32 raw input projections (no bias), the
        backward one of the input reversed within each length.
      fw_weights, bw_weights: (wh, b, scale_x, scale_h, scale_c, offset_c)
        per direction.
      lengths: [B] int32.
    Returns:
      (hs_fw, hs_bw) each [T, B, H], zero past each length; hs_bw is in
      reversed time order (the caller reverses back).
    """
    t_max, bsz, four_h = xw_fw.shape
    h_dim = four_h // 4
    if len(fw_weights) != 6 or len(bw_weights) != 6:
        raise ValueError("bibnlstm_layer: weights are (wh, b, scale_x, scale_h, scale_c, offset_c)")
    dev = check_recurrent_inputs("bibnlstm_layer", (xw_fw, *fw_weights, xw_bw, *bw_weights),
                                 _shapes(t_max, bsz, h_dim) * 2, (lengths,), bsz)
    if dev.type == "cpu":
        return bibnlstm_layer_plain(xw_fw, xw_bw, fw_weights, bw_weights, lengths)
    check_cuda_size("bibnlstm_layer", t_max, bsz, h_dim)
    out_f, out_b = _launch("bibnlstm", (xw_fw, xw_bw), (fw_weights, bw_weights), lengths)
    return out_f, out_b


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bibnlstm_launch.argtypes = [vp] * 11 + [ci] * 4 + [vp]
    lib.bibnlstm_launch.restype = ci
    lib.bnlstm_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.bnlstm_launch.restype = ci


cuda_build.register("bnlstm", _declare)
