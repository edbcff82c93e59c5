"""Fused prologue-affine + conv1d + output moments (CUDA kernel + plain version).

Port of ``chiron_tpu/ops/pallas/convbn.py``. A batch-stat BN conv chain
writes each conv's RAW output once, together with its per-channel sum and
sum of squares; the BN affine (``bn_affine``) and the relu are applied by
the NEXT conv's prologue as it reads the raw tensor, and a residual block's
output flows as two (raw, a, b) terms (see models/layers.py LazyBN).

``conv_bn`` launches ``csrc/conv_bn.cu`` for CUDA tensors and runs
``conv_bn_plain`` for CPU tensors. Numerics: moments are one-pass
E[y^2] - E[y]^2 in float32 (clamped at 0), as in the JAX kernel; parity with
the two-pass reference is ~1e-6 relative, asserted at 1e-4 in the tests.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build

_BN_EPS = 1e-5

# launches of the CUDA kernel (plain-version calls on the CPU are not counted)
launches = 0


def same_padding(t: int, k: int, stride: int) -> Tuple[int, int]:
    """(out_t, left pad) of an XLA SAME window: out_t = ceil(t / stride)."""
    out_t = -(-t // stride)
    pad_total = max((out_t - 1) * stride + k - t, 0)
    return out_t, pad_total // 2


def _prologue(terms, relu_in: bool) -> torch.Tensor:
    x = None
    for raw, a, b in terms:
        v = raw * a + b
        x = v if x is None else x + v
    return torch.relu(x) if relu_in else x


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """XLA-SAME 1-D conv of x [B, T, C_in] by w [k, C_in, C_out] (JAX WIO
    layout) at ``stride``: one torch.matmul per tap, differentiable."""
    t = x.shape[1]
    k = w.shape[0]
    out_t, lpad = same_padding(t, k, stride)
    need = (out_t - 1) * stride + k
    xp = torch.nn.functional.pad(x, (0, 0, lpad, max(need - lpad - t, 0)))
    y = None
    for i in range(k):
        yi = torch.matmul(xp[:, i:i + (out_t - 1) * stride + 1:stride, :], w[i])
        y = yi if y is None else y + yi
    return y


def conv_bn_plain(terms, w: torch.Tensor, relu_in: bool, stride: int = 1):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    y = conv_same(_prologue(terms, relu_in), w, stride)
    return y, y.sum(dim=(0, 1)), (y * y).sum(dim=(0, 1))


def _check(terms, w):
    if len(terms) not in (1, 2):
        raise ValueError("conv_bn takes one or two (raw, a, b) terms")
    raw0 = terms[0][0]
    if raw0.dim() != 3 or w.dim() != 3 or w.shape[1] != raw0.shape[2]:
        raise ValueError(f"bad shapes: raw {tuple(raw0.shape)}, w {tuple(w.shape)}")
    dev = raw0.device
    for raw, a, b in terms:
        if raw.shape != raw0.shape or a.shape != (raw0.shape[2],) or b.shape != a.shape:
            raise ValueError("all terms must share [B, T, C_in] and [C_in] affines")
        for tsr in (raw, a, b):
            if tsr.device != dev or tsr.dtype != torch.float32:
                raise ValueError("conv_bn: every input must be float32 on one device")
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError("conv_bn: w must be float32 on the inputs' device")
    return dev


def conv_bn(terms: Sequence, w: torch.Tensor, relu_in: bool, stride: int = 1):
    """relu?(sum_i raw_i*a_i + b_i) -> SAME conv at ``stride`` -> (y, sums, sqs).

    Args:
      terms: one or two (raw [B, T, C_in], a [C_in], b [C_in]).
      w: [k, C_in, C_out] kernel (JAX WIO layout).
    Returns:
      y [B, ceil(T/stride), C_out] float32 and the per-channel moments of y
      over (B, T') as float32 [C_out] each.
    """
    dev = _check(terms, w)
    if dev.type == "cpu":
        return conv_bn_plain(terms, w, relu_in, stride)
    if dev.type != "cuda":
        raise ValueError(f"conv_bn: unsupported device {dev}")
    global launches
    terms = [tuple(t.contiguous() for t in term) for term in terms]
    w = w.contiguous()
    raw0 = terms[0][0]
    bsz, t, c_in = raw0.shape
    k, _, c_out = w.shape
    out_t, lpad = same_padding(t, k, stride)
    lib = cuda_build.load("conv_bn")
    n_tiles = lib.conv_bn_row_tiles(bsz, out_t)
    y = torch.empty((bsz, out_t, c_out), dtype=torch.float32, device=dev)
    partial = torch.empty((2, n_tiles, c_out), dtype=torch.float32, device=dev)
    sums = torch.empty((c_out,), dtype=torch.float32, device=dev)
    sqs = torch.empty((c_out,), dtype=torch.float32, device=dev)
    two = len(terms) == 2
    p = [term[i].data_ptr() for term in terms for i in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.conv_bn_launch(
        p[0], p[3] if two else None, p[1], p[2],
        p[4] if two else None, p[5] if two else None,
        w.data_ptr(), y.data_ptr(), partial.data_ptr(), sums.data_ptr(),
        sqs.data_ptr(), bsz, t, c_in, c_out, k, int(stride), lpad, out_t,
        int(bool(relu_in)), stream)
    cuda_build.check(rc, "conv_bn")
    launches += 1
    return y, sums, sqs


def bn_affine(sums, sqs, count: float, scale, offset):
    """(a, b) such that bn(y) == y * a + b, from streamed moments."""
    mean = sums / count
    var = torch.clamp(sqs / count - mean * mean, min=0.0)
    a = torch.rsqrt(var + _BN_EPS) * scale
    return a, offset - mean * a


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.conv_bn_row_tiles.argtypes = [ci, ci]
    lib.conv_bn_row_tiles.restype = ci
    lib.conv_bn_launch.argtypes = [vp] * 11 + [ci] * 9 + [vp]
    lib.conv_bn_launch.restype = ci


cuda_build.register("conv_bn", _declare)
