"""Convolutional layer library: functions on [B, T, C] tensors.

Port of ``chiron_tpu/models/layers.py`` (reference: chiron/cnn.py:15-331),
inference only, float32. Parameters are the JAX package's nested dicts,
with torch tensors as leaves.

Every conv of the ported fronts goes through the fused conv+BN kernel
(``ops/conv_bn.py``): a BN'd relu/linear conv returns a ``LazyBN``, the raw
conv output plus a deferred affine that the NEXT conv applies as it reads;
``materialize`` collapses one into a tensor. The reference's "global batch
norm" uses current-batch statistics even at inference (chiron/cnn.py:166-188),
so outputs depend on the batch composition.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from chiron_tpu_torch.ops.conv_bn import bn_affine, conv_bn

Params = Dict[str, Any]

_BN_EPS = 1e-5


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


def materialize(x):
    """Collapse a LazyBN into a plain tensor."""
    if not isinstance(x, LazyBN):
        return x
    y = None
    for raw, a, b in x.terms:
        t = raw * a + b
        y = t if y is None else y + t
    return torch.relu(y) if x.relu else y


def _as_terms(x):
    """(terms, relu_in) for a fused conv's input."""
    if isinstance(x, LazyBN):
        return tuple(x.terms), x.relu
    c = x.shape[-1]
    one = torch.ones((c,), dtype=torch.float32, device=x.device)
    zero = torch.zeros((c,), dtype=torch.float32, device=x.device)
    return ((x, one, zero),), False


def conv(params: Params, x, stride: int = 1, dilation: int = 1,
         padding: str = "SAME", active: Optional[str] = "relu") -> LazyBN:
    """1-D SAME conv [B, T, C_in] -> LazyBN of [B, ceil(T/stride), C_out].

    conv -> optional BN (batch-stat, or population stats when the params
    carry bn_mean/bn_var) -> optional relu (chiron/cnn.py:15-83), through
    the fused conv+BN kernel. The ported fronts only use dilation 1, SAME
    padding, relu/linear activations and no bias.
    """
    if dilation != 1 or padding != "SAME" or active not in ("relu", None) or "b" in params:
        raise NotImplementedError(
            "only dilation-1 SAME relu/linear convs without bias are ported")
    if isinstance(x, LazyBN) and len(x.terms) > 2:
        x = materialize(x)  # the kernel prologue sums at most two terms
    terms, relu_in = _as_terms(x)
    w = params["w"]
    y_raw, sums, sqs = conv_bn(terms, w, relu_in, stride=stride)
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


def residual(params: Params, x, stride: int = 1) -> LazyBN:
    """Residual block (chiron/cnn.py:234-262); its output is never
    materialised: both branches flow to the next conv's prologue as terms."""
    identity = conv(params["branch1"], x, stride=stride, active=None)
    y = conv(params["conv2a"], x)
    y = conv(params["conv2b"], y, stride=stride)
    y = conv(params["conv2c"], y, active=None)
    return LazyBN(identity.terms + y.terms, relu=True)
