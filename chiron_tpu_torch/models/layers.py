"""Convolutional layer library: functions on [B, T, C] tensors.

Port of ``chiron_tpu/models/layers.py`` (reference: chiron/cnn.py:15-331),
float32. Parameters are the JAX package's nested dicts, with torch tensors
as leaves.

At inference every conv of the ported fronts goes through the fused conv+BN
kernel (``ops/conv_bn.py``): a BN'd relu/linear conv returns a ``LazyBN``,
the raw conv output plus a deferred affine that the NEXT conv applies as it
reads; ``materialize`` collapses one into a tensor. With ``training=True``
a conv is the differentiable chain of the JAX package's unfused path: a SAME
conv as one ``torch.matmul`` per tap, ``global_bn``, then the activation,
each materialised, in full float32 (the trainer turns TF32 off for matmuls
and cuDNN: ``utils/device.py:float32_strict``, called by
``train/loop.py:make_train_step``). The reference's "global batch norm" uses current-batch
statistics even at inference (chiron/cnn.py:166-188), so outputs depend on
the batch composition.

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
from chiron_tpu_torch.ops.conv_bn import bn_affine, conv_bn, conv_same

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
              bn: bool = True) -> Params:
    """A conv's params: w [k, C_in, C_out] (+ BN scale/offset [C_out])."""
    p: Params = {"w": xavier_normal(gen, (ksize, c_in, c_out))}
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
    """Normalize by current-batch moments over (batch, time), two-pass."""
    mean = x.mean(dim=(0, 1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + _BN_EPS) * scale + offset


def pop_bn(x, scale, offset, mean, var) -> torch.Tensor:
    """Population-statistics batch norm (chiron/cnn.py:125-163, eps 1e-5)."""
    return (x - mean) * torch.rsqrt(var + _BN_EPS) * scale + offset


class LazyBN:
    """Deferred sum of affine-normalized raw tensors, optionally relu'd.

    value == relu?(sum_i raw_i * a_i + b_i); raws share [B, T, C].
    """

    def __init__(self, terms, relu: bool):
        self.terms = list(terms)
        self.relu = bool(relu)

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
    return store_activation(torch.relu(y) if x.relu else y, bf16)


def _as_terms(x):
    """(terms, relu_in) for a fused conv's input."""
    if isinstance(x, LazyBN):
        return tuple(x.terms), x.relu
    c = x.shape[-1]
    one = torch.ones((c,), dtype=torch.float32, device=x.device)
    zero = torch.zeros((c,), dtype=torch.float32, device=x.device)
    return ((x, one, zero),), False


def _conv_train(params: Params, x, stride: int, active: Optional[str]) -> torch.Tensor:
    """The differentiable unfused conv: SAME conv -> BN -> activation."""
    y = conv_same(materialize(x), params["w"], stride)
    if "bn_mean" in params:
        y = pop_bn(y, params["bn_scale"], params["bn_offset"], params["bn_mean"],
                   params["bn_var"])
    elif "bn_scale" in params:
        y = global_bn(y, params["bn_scale"], params["bn_offset"])
    return torch.relu(y) if active == "relu" else y


def conv(params: Params, x, stride: int = 1, dilation: int = 1,
         padding: str = "SAME", active: Optional[str] = "relu", training: bool = False,
         bf16: bool = False):
    """1-D SAME conv [B, T, C_in] -> [B, ceil(T/stride), C_out].

    conv -> optional BN (batch-stat, or population stats when the params
    carry bn_mean/bn_var) -> optional relu (chiron/cnn.py:15-83). At
    inference through the fused conv+BN kernel, returning a LazyBN; with
    ``training`` as differentiable torch ops, returning a tensor. The ported
    fronts only use dilation 1, SAME padding, relu/linear activations and no
    bias. ``bf16``: the raw output is stored as bfloat16 (its input must then
    be bfloat16 too: the bf16 signal or an earlier conv's output).
    """
    if dilation != 1 or padding != "SAME" or active not in ("relu", None) or "b" in params:
        raise NotImplementedError(
            "only dilation-1 SAME relu/linear convs without bias are ported")
    if training:
        return _conv_train(params, x, stride, active)
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
        bsz, t = y_raw.shape[0], y_raw.shape[1]
        a, b = bn_affine(sums, sqs, float(bsz * t), params["bn_scale"],
                         params["bn_offset"])
    else:
        a = torch.ones((c_out,), dtype=torch.float32, device=y_raw.device)
        b = torch.zeros((c_out,), dtype=torch.float32, device=y_raw.device)
    return LazyBN([(y_raw, a, b)], relu=(active == "relu"))


def residual(params: Params, x, stride: int = 1, training: bool = False, bf16: bool = False):
    """Residual block (chiron/cnn.py:234-262). At inference its output is
    never materialised: both branches flow to the next conv's prologue as
    terms. With ``training`` both branches are tensors, summed and relu'd."""
    identity = conv(params["branch1"], x, stride=stride, active=None, training=training,
                    bf16=bf16)
    y = conv(params["conv2a"], x, training=training, bf16=bf16)
    y = conv(params["conv2b"], y, stride=stride, training=training, bf16=bf16)
    y = conv(params["conv2c"], y, active=None, training=training, bf16=bf16)
    if training:
        return torch.relu(identity + y)
    return LazyBN(identity.terms + y.terms, relu=True)
