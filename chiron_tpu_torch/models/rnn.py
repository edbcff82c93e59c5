"""Stacked bidirectional LSTM + direction-weighted head (inference).

Port of ``chiron_tpu/models/rnn.py`` for layer type ``normal`` and cell type
``LSTM`` (reference: chiron/rnn.py:20-97): per-layer bidirectional concat
feeding the next layer. Each layer's input projections for all timesteps
are one large matmul outside the recurrence; the recurrence itself is the
fused BiLSTM kernel (``ops/bilstm.py``), whose backward direction reads the
time-flipped sequence with per-row start ``T - len`` (flip mode).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from chiron_tpu_torch.ops.bilstm import bilstm_layer

Params = Dict[str, Any]


def reverse_sequence(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse x[t] within each example's first ``lengths[b]`` steps.

    x: [T, B, ...], lengths: [B] (tf.reverse_sequence semantics; identity
    past each length).
    """
    t = x.shape[0]
    tidx = torch.arange(t, device=x.device)[:, None]
    lens = lengths.to(torch.int64)[None, :]
    idx = torch.where(tidx < lens, lens - 1 - tidx, tidx)  # [T, B]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 0, idx)


def _bilstm(layer: Params, x_fw, x_bw, lengths, starts):
    def proj(x, cell):
        return torch.matmul(x, cell["wx"]) + cell["b"]

    return bilstm_layer(proj(x_fw, layer["fw"]), proj(x_bw, layer["bw"]),
                        layer["fw"]["wh"], layer["bw"]["wh"], lengths, starts)


def birnn_stack(params: Params, x: torch.Tensor, lengths: torch.Tensor,
                cell_type: str = "LSTM", layer_type: str = "normal") -> torch.Tensor:
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
        fw, bw = _bilstm(layer, out, torch.flip(out, dims=(0,)), lengths, starts)
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
               cell_type: str = "LSTM", layer_type: str = "normal") -> torch.Tensor:
    lasth = birnn_stack(params["stack"], x, lengths, cell_type, layer_type)
    return rnn_head(params["head"], lasth)
