"""Carry the JAX package's weights into the port.

``from_jax_params`` takes the params pytree that ``chiron_tpu`` builds
(``init_model``) or stores (the bundled ``.npz`` checkpoints, loaded with
``train/checkpoint.py``): nested dicts and lists with numpy leaves. It
returns a ``Basecaller`` module whose ``params`` is the same tree with
float32 torch tensors on ``device`` (``flat`` maps each leaf's "/"-joined
checkpoint key to its tensor). The weights are fixed at inference; build a
new model to move it to another device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from chiron_tpu_torch.models.model import apply_model, model_ratio
from chiron_tpu_torch.utils.device import resolve_device


def _to_torch(tree, device, name, sink):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, f"{name}/{k}", sink) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, f"{name}/[{i}]", sink) for i, v in enumerate(tree)]
    if isinstance(tree, (int, str)) or tree is None:
        return tree  # static metadata leaves
    t = torch.tensor(np.asarray(tree, dtype=np.float32), device=device)
    sink[name.lstrip("/")] = t
    return t


class Basecaller(nn.Module):
    """The port's model: a params tree + its config; forward = apply_model."""

    def __init__(self, params: Dict[str, Any], config: Dict[str, Any],
                 flat: Dict[str, torch.Tensor]):
        super().__init__()
        self.params = params
        self.config = config
        self.flat = flat

    def forward(self, signal: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
        return apply_model(self.params, self.config, signal, seq_len)

    def ratio(self, seg_len: int) -> float:
        return model_ratio(self.config, seg_len)


def from_jax_params(tree: Any, config: Dict[str, Any], device="cuda") -> Basecaller:
    """Build the port's model from a JAX params pytree (numpy leaves)."""
    dev = resolve_device(device)
    flat: Dict[str, torch.Tensor] = {}
    params = _to_torch(tree, dev, "", flat)
    return Basecaller(params, config, flat)
