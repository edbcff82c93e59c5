"""Convolutional layer library: functions on [B, T, C] tensors.

Port of ``chiron_tpu/models/layers.py`` (reference: chiron/cnn.py:15-404):
the conv, the residual, inception, wavenet and gated-conv blocks, and the
pooling layers. Parameters are the JAX package's nested dicts, with torch
tensors as leaves.

At inference a conv takes the fused conv+BN kernel (``ops/conv_bn.py``)
exactly where the JAX package's ``_fused_conv_ok`` sends it there (dilation
1, SAME, relu or linear, no bias: ``fused_conv_ok``), on either device: a
BN'd conv returns a ``LazyBN``, the raw conv output plus a deferred affine
that the NEXT fused conv applies as it reads; ``materialize`` collapses one
into a tensor. Every other conv, and every conv with ``training=True``, is
the JAX package's unfused chain: the conv as one ``torch.matmul`` per tap
(``ops/conv_bn.py:conv1d``; the JAX package runs it as XLA's conv, outside
any Pallas kernel), the bias, ``pop_bn`` / ``global_bn``, the activation,
each materialised, in full float32 (the trainer turns TF32 off for matmuls
and cuDNN: ``utils/device.py:float32_strict``, called by
``train/loop.py:make_train_step``). The reference's "global batch norm" uses
current-batch statistics even at inference (chiron/cnn.py:166-188), so
outputs depend on the batch composition.

bf16 inference mode (``chiron_tpu/models/layers.py:31-70``; the JAX
package's production inference mode): activations are stored as bfloat16
(``store_activation``), matmul operands are rounded to bfloat16 with float32
products and sums (``matmul_inputs``), and the fused conv writes its raw
output as bfloat16 while its moments stay float32. The JAX package holds the
mode in a module global set while tracing; here ``bf16_compute`` resolves it
once in ``apply_model`` and it travels down as an explicit ``bf16`` argument,
so the pipeline's producer thread and a test calling the model at the same
time cannot leak it into each other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from chiron_tpu_torch.models.initializers import variance_scaling, xavier_normal
from chiron_tpu_torch.ops.conv_bn import bn_affine, conv1d, conv_bn, conv_window
from chiron_tpu_torch.parallel.dist import all_sum, global_rows, moments_are_global

Params = Dict[str, Any]

_BN_EPS = 1e-5


def bf16_compute(enabled: bool, training: bool = False) -> bool:
    """Whether a forward pass asked for bf16 runs in bf16 inference mode: at
    inference only; training ignores it (chiron_tpu/models/model.py:404)."""
    return bool(enabled) and not training


def matmul_inputs(*arrays, bf16: bool = False):
    """Matmul operands in the mode's compute precision: as they are, or (bf16)
    rounded to bfloat16 to nearest even and held as float32, so that a float32
    product of two of them is exact and the sum runs in float32. (A matmul of
    two bfloat16 tensors would return bfloat16, a rounding the JAX package's
    ``preferred_element_type=float32`` does not have.)"""
    if not bf16:
        return arrays
    return tuple(a.to(torch.bfloat16).float() for a in arrays)


def store_activation(x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """An activation in the mode's storage dtype: bfloat16 (rounded to
    nearest even) in bf16 mode, else as it is."""
    return x.to(torch.bfloat16) if bf16 else x


def init_conv(gen: torch.Generator, ksize: int, c_in: int, c_out: int,
              bias: bool = False, bn: bool = True) -> Params:
    """A conv's params: w [k, C_in, C_out] (+ bias b [C_out], zeros) (+ BN
    scale/offset [C_out])."""
    p: Params = {"w": xavier_normal(gen, (ksize, c_in, c_out))}
    if bias:
        p["b"] = torch.zeros(c_out)
    if bn:
        p["bn_scale"] = variance_scaling(gen, (c_out,))
        p["bn_offset"] = variance_scaling(gen, (c_out,))
    return p


def init_residual(gen: torch.Generator, c_in: int, c_out: int, k: int = 3,
                  i_bn: bool = False) -> Params:
    """Residual block params: 1x1 identity branch (BN only when i_bn) and a
    1x1 -> 1xk -> 1x1 bottleneck, all BN'd."""
    return {
        "branch1": init_conv(gen, 1, c_in, c_out, bn=i_bn),
        "conv2a": init_conv(gen, 1, c_in, c_out),
        "conv2b": init_conv(gen, k, c_out, c_out),
        "conv2c": init_conv(gen, 1, c_out, c_out),
    }


def global_bn(x: torch.Tensor, scale, offset) -> torch.Tensor:
    """Normalize by current-batch moments over (batch, time), two-pass, in
    float32 (a bfloat16 x is promoted first). Inside
    ``parallel.dist.global_moments`` the batch is the ranks' global batch:
    each pass's sums are summed over the ranks and divided by the global
    row count (``parallel.dist.global_rows``); in a group of one that is
    this mean bit for bit."""
    x = x.float()
    if moments_are_global():
        n = global_rows(x.shape[0] * x.shape[1])
        mean = all_sum(x.sum(dim=(0, 1), keepdim=True)) / n
        var = all_sum(((x - mean) ** 2).sum(dim=(0, 1), keepdim=True)) / n
    else:
        mean = x.mean(dim=(0, 1), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + _BN_EPS) * scale + offset


def pop_bn(x, scale, offset, mean, var) -> torch.Tensor:
    """Population-statistics batch norm (chiron/cnn.py:125-163, eps 1e-5)."""
    return (x.float() - mean) * torch.rsqrt(var + _BN_EPS) * scale + offset


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": torch.nn.functional.elu,
}


class LazyBN:
    """Deferred sum of affine-normalized raw tensors, optionally relu'd (or,
    for Bonito's stem, swish'd).

    value == act(sum_i raw_i * a_i + b_i); raws share [B, T, C].
    """

    def __init__(self, terms, relu: bool, swish: bool = False):
        self.terms = list(terms)
        self.relu = bool(relu)
        self.swish = bool(swish)

    @property
    def shape(self):
        return self.terms[0][0].shape


def materialize(x, bf16: bool = False):
    """Collapse a LazyBN into a plain tensor: the affine and the relu in
    float32, the result stored in the mode's dtype."""
    if not isinstance(x, LazyBN):
        return x
    y = None
    for raw, a, b in x.terms:
        t = raw.float() * a + b
        y = t if y is None else y + t
    if x.swish:
        return store_activation(swish(y), bf16)
    return store_activation(torch.relu(y) if x.relu else y, bf16)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (Bonito's activation)."""
    return x * torch.sigmoid(x)


def _as_terms(x):
    """(terms, relu_in) for a fused conv's input (a swish'd LazyBN goes
    through ``stem_conv`` alone)."""
    if isinstance(x, LazyBN):
        if x.swish:
            raise ValueError("a swish'd LazyBN feeds only stem_conv")
        return tuple(x.terms), x.relu
    c = x.shape[-1]
    one = torch.ones((c,), dtype=torch.float32, device=x.device)
    zero = torch.zeros((c,), dtype=torch.float32, device=x.device)
    return ((x, one, zero),), False


def fused_conv_ok(params: Params, dilation: int, padding: str, active: Optional[str]) -> bool:
    """Whether an inference conv takes the fused conv+BN kernel: the JAX
    package's ``_fused_conv_ok`` (chiron_tpu/models/layers.py:191-198) with
    its fused flag on, on either device and in either mode."""
    return dilation == 1 and padding == "SAME" and active in ("relu", None) and "b" not in params


def _fused_conv(params: Params, x, stride: int, active: Optional[str], bf16: bool) -> LazyBN:
    """The fused kernel's conv: a LazyBN of this conv's raw output."""
    if isinstance(x, LazyBN) and len(x.terms) > 2:
        x = materialize(x, bf16)  # the kernel prologue sums at most two terms
    terms, relu_in = _as_terms(x)
    w = params["w"]
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    y_raw, sums, sqs = conv_bn(terms, w, relu_in, stride=stride, out_dtype=out_dtype)
    c_out = w.shape[-1]
    if "bn_mean" in params:  # pop-stats BN: affine from stored moments
        a = torch.rsqrt(params["bn_var"] + _BN_EPS) * params["bn_scale"]
        b = params["bn_offset"] - params["bn_mean"] * a
    elif "bn_scale" in params:  # batch-stat BN: affine from streamed moments
        count = float(y_raw.shape[0] * y_raw.shape[1])
        if moments_are_global():  # the ranks' global batch (a validation step)
            total = all_sum(torch.cat([sums, sqs, sums.new_full((1,), count)]))
            sums, sqs, count = total[:c_out], total[c_out:2 * c_out], total[2 * c_out:]
        a, b = bn_affine(sums, sqs, count, params["bn_scale"], params["bn_offset"])
    else:
        a = torch.ones((c_out,), dtype=torch.float32, device=y_raw.device)
        b = torch.zeros((c_out,), dtype=torch.float32, device=y_raw.device)
    return LazyBN([(y_raw, a, b)], relu=(active == "relu"))


def _unfused_conv(params: Params, x, stride: int, dilation: int, padding: str,
                  active: Optional[str], bf16: bool) -> torch.Tensor:
    """The JAX package's unfused chain: conv -> bias -> BN -> activation,
    materialised (in bf16 mode both conv operands bfloat16-rounded, the conv
    result and bias stored as bfloat16, BN in float32)."""
    lhs, rhs = matmul_inputs(materialize(x, bf16), params["w"], bf16=bf16)
    y = store_activation(conv1d(lhs, rhs, stride, dilation, padding), bf16)
    if "b" in params:
        y = y + store_activation(params["b"], bf16)
    if "bn_mean" in params:
        y = pop_bn(y, params["bn_scale"], params["bn_offset"], params["bn_mean"],
                   params["bn_var"])
    elif "bn_scale" in params:
        y = global_bn(y, params["bn_scale"], params["bn_offset"])
    if active is not None:
        y = _ACTIVATIONS[active](y)
    return store_activation(y, bf16)


def conv(params: Params, x, stride: int = 1, dilation: int = 1,
         padding: str = "SAME", active: Optional[str] = "relu", training: bool = False,
         bf16: bool = False):
    """1-D conv [B, T, C_in] -> [B, T', C_out] (T' = ceil(T / stride) for
    SAME), then bias, BN (batch-stat, or population stats when the params
    carry bn_mean/bn_var) and activation (relu, sigmoid, tanh, elu or None),
    each where the params or arguments ask for it (chiron/cnn.py:15-83).

    At inference a conv that ``fused_conv_ok`` admits runs the fused kernel
    and returns a LazyBN (``bf16``: its raw output stored as bfloat16, so its
    input must be bfloat16 too); any other conv, and every conv with
    ``training``, is the unfused chain and returns a tensor.
    """
    if not training and fused_conv_ok(params, dilation, padding, active):
        return _fused_conv(params, x, stride, active, bf16)
    return _unfused_conv(params, x, stride, dilation, padding, active, bf16 and not training)


def stem_conv(params: Params, x, stride: int = 1, padding: int = 0, bf16: bool = False):
    """One conv of Bonito's stem at inference: swish(conv(x) + b) with
    ``padding`` zeros on each side, as ``torch.nn.Conv1d(padding=k // 2)``
    pads (not XLA's SAME), on the fused kernel (``ops/conv_bn.py``). It
    returns a swish'd LazyBN of its raw output with the bias as the affine
    shift, which the next ``stem_conv``'s prologue applies as it reads
    (``swish_in``) and ``materialize`` collapses; ``x`` is a window tensor or
    such a LazyBN."""
    lazy = isinstance(x, LazyBN)
    terms = tuple(x.terms) if lazy else _as_terms(x)[0]
    w = params["w"]
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    y_raw, _, _ = conv_bn(terms, w, False, stride=stride, out_dtype=out_dtype,
                          swish_in=lazy and x.swish, padding=padding)
    one = torch.ones((w.shape[-1],), dtype=torch.float32, device=y_raw.device)
    return LazyBN([(y_raw, one, params["b"])], relu=False, swish=True)


def _merge(identity, y, bf16: bool):
    """relu(identity + y): as one LazyBN of both branches' terms when both
    are lazy (never materialised), else summed as tensors."""
    if isinstance(identity, LazyBN) and isinstance(y, LazyBN):
        return LazyBN(identity.terms + y.terms, relu=True)
    return torch.relu(materialize(identity, bf16) + materialize(y, bf16))


def residual(params: Params, x, stride: int = 1, training: bool = False, bf16: bool = False):
    """Residual block (chiron/cnn.py:234-262). At inference its output is
    never materialised: both branches flow to the next conv's prologue as
    terms. With ``training`` both branches are tensors, summed and relu'd."""
    identity = conv(params["branch1"], x, stride=stride, active=None, training=training,
                    bf16=bf16)
    y = conv(params["conv2a"], x, training=training, bf16=bf16)
    y = conv(params["conv2b"], y, stride=stride, training=training, bf16=bf16)
    y = conv(params["conv2c"], y, active=None, training=training, bf16=bf16)
    return _merge(identity, y, bf16)


def init_inception(gen: torch.Generator, c_in: int, times: int = 16) -> Params:
    """Inception block params (chiron/cnn.py:191-231): six branches of
    3 * times channels each."""
    return {
        "conv1a": init_conv(gen, 1, c_in, times * 3),
        "conv0b": init_conv(gen, 1, c_in, times * 3),
        "conv0c": init_conv(gen, 1, c_in, times * 2),
        "conv1c": init_conv(gen, 3, times * 2, times * 3),
        "conv0d": init_conv(gen, 1, c_in, times * 2),
        "conv1d": init_conv(gen, 5, times * 2, times * 3),
        "conv0e": init_conv(gen, 1, c_in, times * 2),
        "conv1e": init_conv(gen, 3, times * 2, times * 3),
        "conv0f": init_conv(gen, 1, c_in, times * 2),
        "conv1f": init_conv(gen, 3, times * 2, times * 3),
    }


def inception(params: Params, x, training: bool = False, bf16: bool = False) -> torch.Tensor:
    """Six branches concatenated on channels: avg-pool -> 1x1, 1x1, 1x1 ->
    3, 1x1 -> 5, 1x1 -> 3 dilated 2, 1x1 -> 3 dilated 3."""
    kw = dict(training=training, bf16=bf16)
    branches = [
        conv(params["conv1a"], avg_pool(x, 3, 1, bf16=bf16), **kw),
        conv(params["conv0b"], x, **kw),
        conv(params["conv1c"], conv(params["conv0c"], x, **kw), **kw),
        conv(params["conv1d"], conv(params["conv0d"], x, **kw), **kw),
        conv(params["conv1e"], conv(params["conv0e"], x, **kw), dilation=2, **kw),
        conv(params["conv1f"], conv(params["conv0f"], x, **kw), dilation=3, **kw),
    ]
    return torch.cat([materialize(b, bf16) for b in branches], dim=-1)


def init_wavenet(gen: torch.Generator, c_in: int, c_out: int) -> Params:
    """Wavenet block params (chiron/cnn.py:299-331)."""
    return {
        "identity": init_conv(gen, 1, c_in, c_out),
        "gate": init_conv(gen, 2, c_in, c_out),
        "filter": init_conv(gen, 2, c_in, c_out),
        "proj": init_conv(gen, 1, c_out, c_out),
    }


def wavenet(params: Params, x, dilation: int, training: bool = False, bf16: bool = False):
    """relu(identity(x) + proj(sigmoid(gate(x)) * tanh(filter(x)))), the gate
    and filter convs dilated; lazy where both outer branches are."""
    kw = dict(training=training, bf16=bf16)
    identity = conv(params["identity"], x, active=None, **kw)
    gate = conv(params["gate"], x, dilation=dilation, active="sigmoid", **kw)
    filt = conv(params["filter"], x, dilation=dilation, active="tanh", **kw)
    y = conv(params["proj"], gate * filt, active=None, **kw)
    return _merge(identity, y, bf16)


def init_gated_conv(gen: torch.Generator, c_in: int, c_out: int, k: int) -> Params:
    """Gated conv block params (chiron/cnn.py:85-124): biased gate and conv."""
    return {
        "gate": init_conv(gen, k, c_in, c_out, bias=True),
        "conv": init_conv(gen, k, c_in, c_out, bias=True),
        "identity": init_conv(gen, 1, c_in, c_out),
    }


def gated_conv(params: Params, x, dilation: int = 1, training: bool = False,
               bf16: bool = False) -> torch.Tensor:
    """sigmoid(gate(x)) * tanh(conv(x)) + identity(x)."""
    kw = dict(training=training, bf16=bf16)
    gate = conv(params["gate"], x, dilation=dilation, active="sigmoid", **kw)
    y = conv(params["conv"], x, dilation=dilation, active="tanh", **kw)
    identity = conv(params["identity"], x, active=None, **kw)
    return gate * y + materialize(identity, bf16)


def _pool(x: torch.Tensor, ksize: int, stride: int, padding: str, fill: float, op):
    """XLA ``reduce_window`` over time: ``op`` folded over the window's taps
    in order, in x's dtype (XLA rounds each bfloat16 step), from ``fill``
    padding."""
    out_t, lpad, rpad = conv_window(x.shape[1], ksize, stride, 1, padding)
    if out_t == 0:
        return x[:, :0]
    xp = torch.nn.functional.pad(x, (0, 0, lpad, rpad), value=fill)
    y = None
    for i in range(ksize):
        xi = xp[:, i:i + (out_t - 1) * stride + 1:stride]
        y = xi if y is None else op(y, xi)
    return y


def avg_pool(x, ksize: int, stride: int, padding: str = "SAME", bf16: bool = False):
    """Average over each window's unpadded samples (XLA ``reduce_window``
    SAME / VALID semantics), materialising x."""
    x = materialize(x, bf16)
    s = _pool(x, ksize, stride, padding, 0.0, torch.add)
    ones = torch.ones((1, x.shape[1], 1), dtype=x.dtype, device=x.device)
    return s / _pool(ones, ksize, stride, padding, 0.0, torch.add)


def max_pool(x, ksize: int, stride: int, padding: str = "SAME", bf16: bool = False):
    """Maximum over each window, padded with -inf (XLA ``reduce_window``),
    materialising x."""
    return _pool(materialize(x, bf16), ksize, stride, padding, float("-inf"), torch.maximum)
