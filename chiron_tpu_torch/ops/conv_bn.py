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

On the card the product runs on the tensor cores as three TF32 products
with float32 accumulation (3xTF32): each operand is split into a TF32 head
and a TF32 tail, and head*head + head*tail + tail*head is summed. A single
TF32 product is excluded: at the main path's depth (K = 3 x 256) it is off
by ~2e-3, 20 times the 1e-4 gate, while three products stay within ~4e-6,
the size of float32's own sum-order residue (``tf32_round`` and
``conv_bn_3xtf32`` below repeat that arithmetic on the CPU, and the tests
pin both numbers). So the kernel's operations bound is 3 x the product's
FLOP over the tensor cores' TF32 rate, not the FLOP over the CUDA cores'
float32 rate. A tensor-core MMA truncates its sum, which leaves each channel
of y with an offset of ~5e-8; the kernel therefore takes sum(y) from the
conv's linearity (w applied to the column sums of the normalised input, in
float64) and only sum(y^2) from y itself. Inputs with k * C_in <= 16 (the
one-channel first convs and the strided fronts) take a CUDA-core kernel
bound by the output it writes.

Bonito's conv stem (``models/layers.py:stem_conv``) takes the same kernels
with two runtime choices the JAX package has no use for: a swish prologue
(``swish_in``: v * sigmoid(v) of the affine sum, where dna_model1 has a relu)
and an explicit symmetric padding (``padding`` an int p: p zeros on each side,
out_t = (T + 2 p - k) // stride + 1, as ``torch.nn.Conv1d`` pads, where XLA's
SAME pads less on the left at a stride that does not divide the window). Swish
is a template parameter of both kernels, so it adds instances and leaves the
relu ones' code as it was; the relu and SAME launches pass the same arguments as
before.

bf16 inference mode (``chiron_tpu/ops/pallas/convbn.py:118,135``): the raw
terms may be bfloat16 and y is then stored as bfloat16 (``out_dtype``), rounded
to nearest even from the float32 value; the prologue, the product (w stays
float32) and both moments are float32, the moments taken before y is rounded.
Both kernels have a float32 and a bfloat16 instance, one element type for the
raws and y; a bfloat16 input on the card goes to the bfloat16 instance, never
upcast to the float32 one.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build

_BN_EPS = 1e-5

# launches of the CUDA kernel (plain-version calls on the CPU are not counted),
# in all and by the instance's element type
launches = 0
launches_by_dtype = {"float32": 0, "bfloat16": 0}

# the element types of the raw terms and of y that the kernels have instances for
RAW_DTYPES = (torch.float32, torch.bfloat16)


def same_padding(t: int, k: int, stride: int) -> Tuple[int, int]:
    """(out_t, left pad) of an XLA SAME window: out_t = ceil(t / stride)."""
    out_t = -(-t // stride)
    pad_total = max((out_t - 1) * stride + k - t, 0)
    return out_t, pad_total // 2


def _prologue(terms, relu_in: bool, swish_in: bool = False) -> torch.Tensor:
    x = None
    for raw, a, b in terms:
        v = raw.float() * a + b
        x = v if x is None else x + v
    if swish_in:
        return x * torch.sigmoid(x)
    return torch.relu(x) if relu_in else x


def conv_window(t: int, k: int, stride: int = 1, dilation: int = 1,
                padding: str = "SAME") -> Tuple[int, int, int]:
    """(out_t, left pad, right pad) of an XLA conv window of k taps
    ``dilation`` apart: SAME gives out_t = ceil(t / stride), VALID no padding
    and out_t = floor((t - span) / stride) + 1 (0 when the span exceeds t);
    an int p pads p on both sides, as ``torch.nn.Conv1d(padding=p)``."""
    span = (k - 1) * dilation + 1
    if isinstance(padding, int):
        return max((t + 2 * padding - span) // stride + 1, 0), padding, padding
    if padding == "SAME":
        out_t, lpad = same_padding(t, span, stride)
        return out_t, lpad, max((out_t - 1) * stride + span - t - lpad, 0)
    if padding == "VALID":
        return max((t - span) // stride + 1, 0), 0, 0
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, dilation: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """XLA 1-D conv (``lax.conv_general_dilated`` with ``rhs_dilation``) of
    x [B, T, C_in] by w [k, C_in, C_out] (JAX WIO layout): one torch.matmul
    per tap, float32 on the card (no TF32, no global flag), differentiable."""
    bsz, t, _ = x.shape
    k, _, c_out = w.shape
    out_t, lpad, rpad = conv_window(t, k, stride, dilation, padding)
    if out_t == 0:
        return x.new_zeros((bsz, 0, c_out))
    xp = torch.nn.functional.pad(x, (0, 0, lpad, rpad))
    y = None
    for i in range(k):
        s = i * dilation
        yi = torch.matmul(xp[:, s:s + (out_t - 1) * stride + 1:stride, :], w[i])
        y = yi if y is None else y + yi
    return y


def conv_bn_plain(terms, w: torch.Tensor, relu_in: bool, stride: int = 1,
                  out_dtype: torch.dtype = torch.float32, swish_in: bool = False,
                  padding="SAME"):
    """Plain PyTorch version of the kernel: same inputs, same outputs (the
    moments from the float32 y, then y rounded to ``out_dtype``)."""
    y = conv1d(_prologue(terms, relu_in, swish_in), w, stride, padding=padding)
    return y.to(out_dtype), y.sum(dim=(0, 1)), (y * y).sum(dim=(0, 1))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits; ties away from
    zero in magnitude, as ``cvt.rna.tf32.f32`` rounds), kept as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def conv_bn_3xtf32(terms, w: torch.Tensor, relu_in: bool, stride: int = 1, products: int = 3):
    """The card kernel's arithmetic on the CPU: prologue in float32, then the
    conv as TF32 products with float32 sums. ``products=3`` is the kernel
    (head*head + head*tail + tail*head); ``products=1`` is a single TF32
    product, which the kernel does not use."""
    x = _prologue(terms, relu_in)
    xh, wh = tf32_round(x), tf32_round(w)
    y = conv1d(xh, wh, stride)
    if products == 3:
        xt, wt = tf32_round(x - xh), tf32_round(w - wh)
        y = (conv1d(xt, wh, stride) + conv1d(xh, wt, stride)) + y
    elif products != 1:
        raise ValueError("products must be 1 or 3")
    # sum(y) as the kernel takes it: the conv is linear, so it is w applied to
    # the per-tap column sums of x, in float64
    out_t, lpad = same_padding(x.shape[1], w.shape[0], stride)
    need = (out_t - 1) * stride + w.shape[0]
    xp = torch.nn.functional.pad(x.double(), (0, 0, lpad, max(need - lpad - x.shape[1], 0)))
    colsum = torch.stack([xp[:, i:i + (out_t - 1) * stride + 1:stride, :].sum(dim=(0, 1))
                          for i in range(w.shape[0])])
    sums = torch.einsum("kc,kcn->n", colsum, w.double()).to(torch.float32)
    return y, sums, (y * y).sum(dim=(0, 1))


def _check(terms, w, out_dtype):
    if len(terms) not in (1, 2):
        raise ValueError("conv_bn takes one or two (raw, a, b) terms")
    raw0 = terms[0][0]
    if raw0.dim() != 3 or w.dim() != 3 or w.shape[1] != raw0.shape[2]:
        raise ValueError(f"bad shapes: raw {tuple(raw0.shape)}, w {tuple(w.shape)}")
    dev = raw0.device
    if out_dtype not in RAW_DTYPES or any(raw.dtype != out_dtype for raw, _, _ in terms):
        raise ValueError("conv_bn (conv_bn_mma_kernel / conv_bn_direct_kernel): the kernels "
                         "take float32 raw terms to a float32 y or bfloat16 to bfloat16, got "
                         f"{[str(raw.dtype) for raw, _, _ in terms]} to {out_dtype}")
    for raw, a, b in terms:
        if raw.shape != raw0.shape or a.shape != (raw0.shape[2],) or b.shape != a.shape:
            raise ValueError("all terms must share [B, T, C_in] and [C_in] affines")
        for tsr in (raw, a, b):
            if tsr.device != dev:
                raise ValueError("conv_bn: every input must be on one device")
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError("conv_bn: the affines must be float32")
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError("conv_bn: w must be float32 on the inputs' device")
    return dev


def conv_bn(terms: Sequence, w: torch.Tensor, relu_in: bool, stride: int = 1,
            out_dtype: torch.dtype = torch.float32, swish_in: bool = False,
            padding="SAME"):
    """act(sum_i raw_i*a_i + b_i) -> conv at ``stride`` -> (y, sums, sqs).

    Args:
      terms: one or two (raw [B, T, C_in], a [C_in], b [C_in]); raw in
        ``out_dtype``, the affines float32.
      w: [k, C_in, C_out] float32 kernel (JAX WIO layout).
      out_dtype: float32, or bfloat16 (bf16 inference mode).
      swish_in: the prologue's activation is swish (``relu_in`` must be
        False), else relu where ``relu_in``, else none.
      padding: "SAME" (XLA), or an int p of zeros on both sides.
    Returns:
      y [B, T_out, C_out] in out_dtype (SAME: T_out = ceil(T/stride)) and the
      per-channel moments
      of the float32 y over (B, T') as float32 [C_out] each.
    """
    dev = _check(terms, w, out_dtype)
    if relu_in and swish_in:
        raise ValueError("conv_bn: one prologue activation, relu or swish")
    if dev.type == "cpu":
        return conv_bn_plain(terms, w, relu_in, stride, out_dtype, swish_in, padding)
    if dev.type != "cuda":
        raise ValueError(f"conv_bn: unsupported device {dev}")
    global launches
    terms = [tuple(t.contiguous() for t in term) for term in terms]
    w = w.contiguous()
    raw0 = terms[0][0]
    bsz, t, c_in = raw0.shape
    k, _, c_out = w.shape
    out_t, lpad, _ = conv_window(t, k, stride, 1, padding)
    lib = cuda_build.load("conv_bn")
    n_tiles = lib.conv_bn_row_tiles(bsz, out_t)
    bf16 = int(out_dtype == torch.bfloat16)
    y = torch.empty((bsz, out_t, c_out), dtype=out_dtype, device=dev)
    partial = torch.empty((2, n_tiles, c_out), dtype=torch.float32, device=dev)
    # scratch of the tensor-core route: per-tile column sums of the normalised
    # input and their float64 totals (sum(y) comes from them, see the kernel)
    xpart = colsum = None
    if lib.conv_bn_route(c_in, c_out, k, int(stride), int(len(terms) == 2), bf16) == 2:
        xpart = torch.empty((n_tiles, k * c_in), dtype=torch.float32, device=dev)
        colsum = torch.empty((k * c_in,), dtype=torch.float64, device=dev)
    sums = torch.empty((c_out,), dtype=torch.float32, device=dev)
    sqs = torch.empty((c_out,), dtype=torch.float32, device=dev)
    two = len(terms) == 2
    p = [term[i].data_ptr() for term in terms for i in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with cuda_build.on_device(dev):
        rc = lib.conv_bn_launch(
            p[0], p[3] if two else None, p[1], p[2],
            p[4] if two else None, p[5] if two else None,
            w.data_ptr(), y.data_ptr(), partial.data_ptr(),
            None if xpart is None else xpart.data_ptr(),
            None if colsum is None else colsum.data_ptr(), sums.data_ptr(),
            sqs.data_ptr(), bsz, t, c_in, c_out, k, int(stride), lpad, out_t,
            2 if swish_in else int(bool(relu_in)), bf16, stream)
    dtype = str(out_dtype).split(".")[-1]
    cuda_build.check(rc, f"conv_bn ({dtype} instance)")
    launches += 1
    launches_by_dtype[dtype] += 1
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
    lib.conv_bn_route.argtypes = [ci] * 6
    lib.conv_bn_route.restype = ci
    lib.conv_bn_launch.argtypes = [vp] * 13 + [ci] * 10 + [vp]
    lib.conv_bn_launch.restype = ci


cuda_build.register("conv_bn", _declare)
