"""Weight initializers: the TF1 choices of the reference, drawn with torch.

Port of ``chiron_tpu/models/initializers.py``: xavier (glorot) normal for
conv weights (chiron/cnn.py:45), variance scaling for BN scale/offset
(chiron/cnn.py:181-186), a truncated normal for the RNN head
(chiron/rnn.py:73-88) and glorot uniform for LSTM kernels. Each draws from
a ``torch.Generator`` on the CPU and returns a float32 CPU tensor. The bits
differ from ``jax.random``'s; the distributions are the same (truncated
normals are cut at two standard deviations and not rescaled, as JAX's).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _fans(shape) -> tuple[float, float]:
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def _truncated(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated to [-2, 2]."""
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def xavier_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Glorot normal: std = sqrt(2 / (fan_in + fan_out))."""
    fan_in, fan_out = _fans(shape)
    return math.sqrt(2.0 / (fan_in + fan_out)) * torch.randn(shape, generator=gen)


def xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """Glorot uniform on [-limit, limit], limit = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def variance_scaling(gen: torch.Generator, shape, scale: float = 2.0) -> torch.Tensor:
    """He / variance scaling (fan_in, truncated normal), TF contrib default."""
    fan_in, _ = _fans(shape)
    return math.sqrt(scale / max(fan_in, 1.0)) * _truncated(gen, shape)


def truncated_normal(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    return stddev * _truncated(gen, shape)


def orthogonal(gen: torch.Generator, shape) -> torch.Tensor:
    """Orthogonal init (used by the custom LSTM cells, chiron/utils/lstm.py)."""
    n_rows = int(np.prod(shape[:-1]))
    n_cols = int(shape[-1])
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.t()
    return q[:n_rows, :n_cols].reshape(shape).contiguous()
