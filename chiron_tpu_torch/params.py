"""The port's model object, and the way between it and the JAX params tree.

``from_jax_params`` takes the params pytree that ``chiron_tpu`` builds
(``init_model``) or stores (the ``.npz`` checkpoints, loaded with
``train/checkpoint.py``): nested dicts and lists with numpy leaves. It
returns a ``Basecaller`` whose every float leaf is an ``nn.Parameter``
registered in ``flat``, a ``ParameterDict`` keyed by the leaf's "/"-joined
checkpoint key, so ``parameters()``, ``state_dict()`` and an optimizer see
them. ``params`` is the same nested tree, pointing at the same Parameter
objects, which the model functions read. The weights come frozen
(``requires_grad`` False, as inference wants); the trainer turns gradients
on with ``requires_grad_(True)``.

``to_numpy_tree`` is the way back: the JAX-layout tree with numpy leaves,
for checkpoints and for the JAX side of the tests.

``attention_from_jax`` does the same for the experimental attention
decoder's tree (``chiron_tpu/models/attention.py``: ``embed``, ``att_we``,
``att_wh``, ``att_v``, ``gru_wx``, ``gru_wh``, ``gru_b``, ``out_w``,
``out_b``), returning an ``AttentionDecoder``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from chiron_tpu_torch.models import attention
from chiron_tpu_torch.models.model import apply_model, encode, model_ratio
from chiron_tpu_torch.utils.device import resolve_device


def _to_params(tree, device, name, sink):
    if isinstance(tree, dict):
        return {k: _to_params(v, device, f"{name}/{k}", sink) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_params(v, device, f"{name}/[{i}]", sink) for i, v in enumerate(tree)]
    if isinstance(tree, (int, str)) or tree is None:
        return tree  # static metadata leaves
    if np.ndim(tree) == 0 and np.asarray(tree).dtype.kind in "iu":
        return int(tree)  # an int leaf that went through numpy (variant_wavnet's dilate_layer)
    data = torch.tensor(np.asarray(tree, dtype=np.float32), device=device)
    p = nn.Parameter(data, requires_grad=False)
    sink[name.lstrip("/")] = p
    return p


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


class Basecaller(nn.Module):
    """The port's model: registered weights + the params tree + its config;
    forward = apply_model."""

    def __init__(self, params: Dict[str, Any], config: Dict[str, Any],
                 flat: Dict[str, nn.Parameter]):
        super().__init__()
        self.params = params
        self.config = config
        self.flat = nn.ParameterDict(flat)

    def forward(self, signal: torch.Tensor, seq_len: torch.Tensor,
                training: bool = False, bf16: bool = False) -> torch.Tensor:
        return apply_model(self.params, self.config, signal, seq_len, training=training,
                           bf16=bf16)

    def encode(self, signal: torch.Tensor, seq_len: torch.Tensor,
               bf16: bool = False) -> torch.Tensor:
        """The features that feed the logit head (inference mode)."""
        return encode(self.params, self.config, signal, seq_len, bf16=bf16)

    def ratio(self, seg_len: int) -> float:
        return model_ratio(self.config, seg_len)


def from_jax_params(tree: Any, config: Dict[str, Any], device="cuda") -> Basecaller:
    """Build the port's model from a JAX params pytree (numpy leaves)."""
    dev = resolve_device(device)
    flat: Dict[str, nn.Parameter] = {}
    params = _to_params(tree, dev, "", flat)
    return Basecaller(params, config, flat)


def to_numpy_tree(model: Basecaller) -> Any:
    """The model's params as the JAX-layout tree with numpy float32 leaves."""
    return _to_numpy(model.params)


class AttentionDecoder(nn.Module):
    """The attention decoder's registered weights + its params tree."""

    def __init__(self, params: Dict[str, Any], flat: Dict[str, nn.Parameter]):
        super().__init__()
        self.params = params
        self.flat = nn.ParameterDict(flat)

    def decode(self, encodings: torch.Tensor, enc_lengths: torch.Tensor, max_steps: int):
        """Greedy decode: (tokens [B, max_steps] int32, logits [B, max_steps, C])."""
        return attention.attention_decode(self.params, encodings, enc_lengths, max_steps)

    def loss(self, encodings: torch.Tensor, enc_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor) -> torch.Tensor:
        """The teacher-forced cross-entropy."""
        return attention.attention_teacher_forcing_loss(self.params, encodings, enc_lengths,
                                                        targets, target_lengths)

    def teacher_forced_logits(self, encodings: torch.Tensor, enc_lengths: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
        """The logits [B, U, C] the loss is taken over."""
        return attention.teacher_forced_logits(self.params, encodings, enc_lengths, targets)


def attention_from_jax(tree: Dict[str, Any], device="cuda") -> AttentionDecoder:
    """Build the port's attention decoder from a JAX attention params tree
    (numpy leaves); weights frozen, as ``from_jax_params`` gives them."""
    dev = resolve_device(device)
    flat: Dict[str, nn.Parameter] = {}
    params = _to_params(tree, dev, "", flat)
    return AttentionDecoder(params, flat)
