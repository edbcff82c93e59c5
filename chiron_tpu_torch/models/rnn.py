"""Stacked bidirectional LSTM + direction-weighted head.

Port of ``chiron_tpu/models/rnn.py`` for layer type ``normal`` and cell type
``LSTM`` (reference: chiron/rnn.py:20-97): per-layer bidirectional concat
feeding the next layer. Each layer's input projections for all timesteps
are one large matmul outside the recurrence.

- Inference: the recurrence is the fused BiLSTM kernel (``ops/bilstm.py``),
  whose backward direction reads the time-flipped sequence with per-row
  start ``T - len`` (flip mode).
- Training (``training=True``): each direction is the differentiable
  ``ops/lstm_grad.py:lstm_layer_ad``, and the backward direction reads
  ``reverse_sequence`` of its input, with no start offset, as the JAX
  package's non-flip path does.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from chiron_tpu_torch.models.initializers import truncated_normal, xavier_uniform
from chiron_tpu_torch.ops.bilstm import bilstm_layer
from chiron_tpu_torch.ops.lstm_grad import lstm_layer_ad

Params = Dict[str, Any]


def _reverse_sequence(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    t = x.shape[0]
    tidx = torch.arange(t, device=x.device)[:, None]
    lens = lengths.to(torch.int64)[None, :]
    idx = torch.where(tidx < lens, lens - 1 - tidx, tidx)  # [T, B]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 0, idx)


class _ReverseSequence(torch.autograd.Function):
    """The reversal is its own inverse and transpose, so its gradient is the
    same reversal of the incoming gradient (not gather's scatter-add)."""

    @staticmethod
    def forward(ctx, x, lengths):
        ctx.save_for_backward(lengths)
        return _reverse_sequence(x, lengths)

    @staticmethod
    def backward(ctx, g):
        (lengths,) = ctx.saved_tensors
        return _reverse_sequence(g, lengths), None


def reverse_sequence(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse x[t] within each example's first ``lengths[b]`` steps.

    x: [T, B, ...], lengths: [B] (tf.reverse_sequence semantics; identity
    past each length).
    """
    return _ReverseSequence.apply(x, lengths)


def init_lstm_cell(gen: torch.Generator, c_in: int, hidden: int) -> Params:
    return {
        "wx": xavier_uniform(gen, (c_in, 4 * hidden)),
        "wh": xavier_uniform(gen, (hidden, 4 * hidden)),
        "b": torch.zeros(4 * hidden),
    }


def init_rnn_layers(gen: torch.Generator, c_in: int, hidden: int, layer_num: int,
                    class_n: int) -> Params:
    """A ``normal`` LSTM stack (layer i > 0 reads the 2H concat) + head."""
    layers = [{d: init_lstm_cell(gen, c_in if i == 0 else 2 * hidden, hidden)
               for d in ("fw", "bw")} for i in range(layer_num)]
    head = {
        "w_dir": truncated_normal(gen, (2, hidden), math.sqrt(2.0 / (2 * hidden))),
        "b_dir": torch.zeros(hidden),
        "w_class": truncated_normal(gen, (hidden, class_n), math.sqrt(2.0 / hidden)),
        "b_class": torch.zeros(class_n),
    }
    return {"stack": {"layers": layers}, "head": head}


def _proj(x, cell):
    return torch.matmul(x, cell["wx"]) + cell["b"]


def _run_cell(cell: Params, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One training direction: xw = x @ wx + b, then the differentiable kernel."""
    return lstm_layer_ad(_proj(x, cell), cell["wh"], lengths)


def birnn_stack(params: Params, x: torch.Tensor, lengths: torch.Tensor,
                cell_type: str = "LSTM", layer_type: str = "normal",
                training: bool = False) -> torch.Tensor:
    """Bidirectional stack. x: [B, T, C] -> [B, T, 2H]."""
    if cell_type != "LSTM" or layer_type != "normal":
        raise NotImplementedError(
            f"only LSTM 'normal' stacks are ported (got {cell_type}/{layer_type})")
    xt = x.transpose(0, 1)  # time-major [T, B, C]
    t = xt.shape[0]
    lengths = lengths.to(torch.int32)
    starts = (t - lengths).to(torch.int32)
    out = xt
    for layer in params["layers"]:
        if training:
            fw = _run_cell(layer["fw"], out, lengths)
            bw = _run_cell(layer["bw"], reverse_sequence(out, lengths), lengths)
            out = torch.cat([fw, reverse_sequence(bw, lengths)], dim=-1)
        else:
            fw, bw = bilstm_layer(_proj(out, layer["fw"]),
                                  _proj(torch.flip(out, dims=(0,)), layer["bw"]),
                                  layer["fw"]["wh"], layer["bw"]["wh"], lengths, starts)
            out = torch.cat([fw, torch.flip(bw, dims=(0,))], dim=-1)
    return out.transpose(0, 1)  # back to [B, T, 2H]


def rnn_head(params: Params, lasth: torch.Tensor) -> torch.Tensor:
    """[B, T, 2H] -> [B, T, class_n] via direction-weighted sum + FC
    (chiron/rnn.py:72-97)."""
    b, t, two_h = lasth.shape
    pair = lasth.reshape(b, t, 2, two_h // 2)
    merged = torch.einsum("btdh,dh->bth", pair, params["w_dir"]) + params["b_dir"]
    return merged @ params["w_class"] + params["b_class"]


def rnn_layers(params: Params, x: torch.Tensor, lengths: torch.Tensor,
               cell_type: str = "LSTM", layer_type: str = "normal",
               training: bool = False) -> torch.Tensor:
    lasth = birnn_stack(params["stack"], x, lengths, cell_type, layer_type, training)
    return rnn_head(params["head"], lasth)
