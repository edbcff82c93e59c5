"""Bonito's CTC-CRF head, and the way in from Bonito's weights.

The head of ``bonito/crf/model.py:LinearCRFEncoder`` (github.com/nanoporetech/
bonito) at ``blank_score`` set: ``scale * tanh(h W + c)``, W [features,
4^(state_len + 1)], read by the CRF decode (``ops/crf.py``) as S =
4^state_len states of 4 move scores each, behind a constant blank (stay)
column of ``blank_score`` that the decode adds itself: the [B, T, 5 S]
expansion Bonito materialises is never made here.

``from_bonito`` takes the weights of Bonito's ``rnn_encoder`` (its
``state_dict``, keys ``[encoder.]<i>.conv.weight``, ``<i>.rnn.weight_ih_l0``,
``<i>.linear.weight`` ...; numpy or torch values) to the port's params tree:

- a conv's weight [C_out, C_in, k] to ``w`` [k, C_in, C_out], its bias to
  ``b``;
- an LSTM's ``weight_ih_l0`` / ``weight_hh_l0`` [4H, *] (gates i, f, g, o) to
  ``wx`` [C_in, 4H] / ``wh`` [H, 4H] in the port's gate order i, g, f, o,
  and ``b = b_ih + b_hh`` in that order with 1 taken off the forget gate's
  (the port's LSTM kernels add a forget bias of +1);
- the linear layer's weight [4S, features] to ``w`` [features, 4S], its bias
  to ``b``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from chiron_tpu_torch.models.initializers import xavier_uniform
from chiron_tpu_torch.models.layers import matmul_inputs

Params = Dict[str, Any]

# the port's gate blocks (i, g, f, o) as blocks of torch's (i, f, g, o)
_GATES_FROM_TORCH = (0, 2, 1, 3)
_FORGET_BIAS = 1.0
STEM_LAYERS = 3  # Bonito's rnn_encoder: three convs, then the LSTMs, then the head


def init_crf_head(gen: torch.Generator, features: int, state_len: int) -> Params:
    size = 4 ** (state_len + 1)
    return {"w": xavier_uniform(gen, (features, size)), "b": torch.zeros(size)}


def crf_head(params: Params, h: torch.Tensor, scale: float, bf16: bool = False) -> torch.Tensor:
    """Features [B, T, F] -> float32 scores [B, T, 4 S] (bf16 mode: both
    operands of the product rounded to bfloat16, the sum in float32)."""
    bsz, t, f = h.shape
    lhs, rhs = matmul_inputs(h.float().reshape(bsz * t, f), params["w"], bf16=bf16)
    z = torch.addmm(params["b"], lhs, rhs).reshape(bsz, t, -1)
    if z.requires_grad:
        return torch.tanh(z) * scale
    return z.tanh_().mul_(scale)  # in place: the scores are the largest tensor of the step


def _arr(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def lstm_from_torch(w_ih, w_hh, b_ih, b_hh) -> Params:
    """One ``torch.nn.LSTM`` layer's weights to the port's LSTM cell."""
    w_ih, w_hh, bias = _arr(w_ih), _arr(w_hh), _arr(b_ih) + _arr(b_hh)
    h = w_hh.shape[1]

    def reorder(m):
        blocks = np.split(m, 4, axis=0)
        return np.concatenate([blocks[i] for i in _GATES_FROM_TORCH], axis=0)

    b = reorder(bias)
    b[2 * h:3 * h] -= _FORGET_BIAS
    return {"wx": np.ascontiguousarray(reorder(w_ih).T),
            "wh": np.ascontiguousarray(reorder(w_hh).T), "b": b}


def from_bonito(state: Mapping[str, Any], layers: int) -> Params:
    """The port's params tree (numpy leaves) from the ``state_dict`` of
    Bonito's ``rnn_encoder`` with ``layers`` LSTM layers."""
    flat = {k.split("encoder.", 1)[-1]: v for k, v in state.items()}

    def conv(i):
        w = _arr(flat[f"{i}.conv.weight"])
        return {"w": np.ascontiguousarray(w.transpose(2, 1, 0)),
                "b": _arr(flat[f"{i}.conv.bias"])}

    first = STEM_LAYERS + 1  # the Permute between the convs and the LSTMs is layer 3
    stack = []
    for i in range(first, first + layers):
        p = f"{i}.rnn."
        stack.append(lstm_from_torch(flat[p + "weight_ih_l0"], flat[p + "weight_hh_l0"],
                                     flat[p + "bias_ih_l0"], flat[p + "bias_hh_l0"]))
    head = f"{first + layers}.linear."
    return {"cnn": {f"conv{i + 1}": conv(i) for i in range(STEM_LAYERS)},
            "rnn": {"stack": {"layers": stack}},
            "crf": {"w": np.ascontiguousarray(_arr(flat[head + "weight"]).T),
                    "b": _arr(flat[head + "bias"])}}
