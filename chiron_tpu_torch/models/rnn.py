"""Recurrent layers: stacked bidirectional LSTM / GRU / BNLSTM + head, and
the forward-only stack.

Port of ``chiron_tpu/models/rnn.py`` (reference: chiron/rnn.py:20-216), and
Bonito's alternating single-direction stack (``alternating_stack``, layer
type ``alternating``, the CRF models' encoder). Two bidirectional stacking
orders: ``normal``, a per-layer bidirectional concat feeding the
next layer, and ``rna``, independent forward and backward deep stacks
concatenated once at the top. Each layer's input projections for all
timesteps are large matmuls outside the recurrence.

- Inference: every layer is one fused two-direction kernel
  (``ops/bilstm.py``, ``ops/gru.py``, ``ops/bnlstm.py``). The LSTM and GRU
  backward directions read the time-flipped sequence with per-row start
  ``T - len`` (flip mode). The BNLSTM cannot: its per-step batch moments
  must cover exactly the rows with ``t < len`` in both directions, so its
  backward input goes through ``reverse_sequence``. ``unirnn_layers`` runs
  the single-direction kernels (``ops/lstm.py`` and the same two modules).
  Inside ``parallel.dist.global_moments`` (a data-parallel validation step)
  a BNLSTM layer runs the training recurrence instead, its moments summed
  over the ranks: the kernels take each step's moments on chip.
- Training (``training=True``): the backward direction reads
  ``reverse_sequence`` of its input with no start offset. An LSTM direction
  is the differentiable ``ops/lstm_grad.py:lstm_layer_ad``; GRU and BNLSTM
  directions are differentiable step loops under autograd, as the JAX
  package trains them through ``lax.scan``.
- bf16 inference mode (``bf16=True``, chiron_tpu/models/rnn.py:36-43,
  259, 303-304): every projection rounds its two operands to bfloat16 and
  sums in float32 (``layers.matmul_inputs``); an LSTM layer stores ``xw`` as
  bfloat16, and its kernel returns bfloat16 ``h``; GRU and BNLSTM layers keep
  float32 projections and outputs, so their kernels run unchanged. The head
  promotes a bfloat16 ``h`` to float32; the logits are float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from chiron_tpu_torch.models.initializers import orthogonal, truncated_normal, xavier_uniform
from chiron_tpu_torch.models.layers import matmul_inputs, store_activation
from chiron_tpu_torch.ops.bilstm import bilstm_layer
from chiron_tpu_torch.ops.bnlstm import bibnlstm_layer, bnlstm_layer, bnlstm_scan
from chiron_tpu_torch.ops.gru import bigru_layer, gru_layer, gru_scan
from chiron_tpu_torch.ops.lstm import lstm_layer
from chiron_tpu_torch.ops.lstm_grad import lstm_layer_ad
from chiron_tpu_torch.parallel.dist import moments_are_global

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


def init_gru_cell(gen: torch.Generator, c_in: int, hidden: int) -> Params:
    return {
        "wx_g": xavier_uniform(gen, (c_in, 2 * hidden)),
        "wh_g": xavier_uniform(gen, (hidden, 2 * hidden)),
        "b_g": torch.ones(2 * hidden),  # TF GRUCell gate bias init = 1.0
        "wx_c": xavier_uniform(gen, (c_in, hidden)),
        "wh_c": xavier_uniform(gen, (hidden, hidden)),
        "b_c": torch.zeros(hidden),
    }


def init_bnlstm_cell(gen: torch.Generator, c_in: int, hidden: int) -> Params:
    """Batch-normalized LSTM cell (chiron/utils/lstm.py:61-151): orthogonal
    recurrent kernel, BN scales 0.1, one bias added after normalisation."""
    return {
        "wx": xavier_uniform(gen, (c_in, 4 * hidden)),
        "wh": orthogonal(gen, (hidden, 4 * hidden)),
        "b": torch.zeros(4 * hidden),
        "scale_x": torch.full((4 * hidden,), 0.1),
        "scale_h": torch.full((4 * hidden,), 0.1),
        "scale_c": torch.full((hidden,), 0.1),
        "offset_c": torch.zeros(hidden),
    }


_INIT_CELL = {"LSTM": init_lstm_cell, "GRU": init_gru_cell, "BNLSTM": init_bnlstm_cell}


def _init_cell(cell_type: str, gen: torch.Generator, c_in: int, hidden: int) -> Params:
    if cell_type not in _INIT_CELL:
        raise ValueError(f"Cell type unrecognized: {cell_type}")
    return _INIT_CELL[cell_type](gen, c_in, hidden)


def init_birnn_stack(gen: torch.Generator, c_in: int, hidden: int, layer_num: int,
                     cell_type: str = "LSTM", layer_type: str = "normal") -> Params:
    """Layer i > 0 reads the 2H concat (``normal``) or its own direction's H
    (``rna``: independent deep stacks)."""
    layer_in = hidden if layer_type == "rna" else 2 * hidden
    return {"layers": [{d: _init_cell(cell_type, gen, c_in if i == 0 else layer_in, hidden)
                        for d in ("fw", "bw")} for i in range(layer_num)]}


def init_rnn_head(gen: torch.Generator, hidden: int, class_n: int) -> Params:
    return {
        "w_dir": truncated_normal(gen, (2, hidden), math.sqrt(2.0 / (2 * hidden))),
        "b_dir": torch.zeros(hidden),
        "w_class": truncated_normal(gen, (hidden, class_n), math.sqrt(2.0 / hidden)),
        "b_class": torch.zeros(class_n),
    }


def init_rnn_layers(gen: torch.Generator, c_in: int, hidden: int, layer_num: int,
                    class_n: int, cell_type: str = "LSTM",
                    layer_type: str = "normal") -> Params:
    return {"stack": init_birnn_stack(gen, c_in, hidden, layer_num, cell_type, layer_type),
            "head": init_rnn_head(gen, hidden, class_n)}


def _matmul(x, w, bf16=False):
    """The hoisted input projection: float32 out, bfloat16-rounded operands
    in bf16 mode."""
    return torch.matmul(*matmul_inputs(x, w, bf16=bf16))


def _proj(x, cell, bf16=False):
    """An LSTM layer's xw = x @ wx + b, stored as bfloat16 in bf16 mode."""
    return store_activation(_matmul(x, cell["wx"], bf16) + cell["b"], bf16)


def _gru_proj(x, cell, bf16=False):
    return (_matmul(x, cell["wx_g"], bf16) + cell["b_g"],
            _matmul(x, cell["wx_c"], bf16) + cell["b_c"])


def _bn_weights(cell):
    return tuple(cell[k] for k in ("wh", "b", "scale_x", "scale_h", "scale_c", "offset_c"))


def _run_cell(cell_type: str, cell: Params, x: torch.Tensor, lengths: torch.Tensor,
              training: bool = False, starts: Optional[torch.Tensor] = None,
              bf16: bool = False) -> torch.Tensor:
    """One direction of one layer over time-major x [T, B, C] -> [T, B, H]:
    the single-direction kernel at inference, the differentiable version in
    training. ``starts`` (flip mode) is for LSTM/GRU inference only."""
    if starts is not None and (training or cell_type == "BNLSTM"):
        raise ValueError("starts requires the LSTM/GRU inference path")
    if cell_type == "BNLSTM":
        xw = _matmul(x, cell["wx"], bf16)  # the bias is added after normalisation
        # the inference kernels take each step's moments on chip, over their
        # own rows: a step whose moments span the ranks runs the recurrence
        return (bnlstm_scan if training or moments_are_global() else bnlstm_layer)(
            xw, *_bn_weights(cell), lengths)
    if cell_type == "LSTM":
        if training:
            return lstm_layer_ad(_proj(x, cell), cell["wh"], lengths)
        return lstm_layer(_proj(x, cell, bf16), cell["wh"], lengths, starts)
    if cell_type == "GRU":
        gx, cx = _gru_proj(x, cell, bf16)
        if training:
            return gru_scan(gx, cx, cell["wh_g"], cell["wh_c"], torch.zeros_like(lengths),
                            lengths)
        return gru_layer(gx, cx, cell["wh_g"], cell["wh_c"], lengths, starts)
    raise ValueError(f"Cell type unrecognized: {cell_type}")


def _fused_bilstm(layer, x_fw, x_bw, lengths, starts, bf16=False):
    """x_bw already time-flipped; the returned h_bw is still flipped."""
    return bilstm_layer(_proj(x_fw, layer["fw"], bf16), _proj(x_bw, layer["bw"], bf16),
                        layer["fw"]["wh"], layer["bw"]["wh"], lengths, starts)


def _fused_bigru(layer, x_fw, x_bw, lengths, starts, bf16=False):
    """x_bw already time-flipped; the returned h_bw is still flipped."""
    fw, bw = layer["fw"], layer["bw"]
    return bigru_layer(*_gru_proj(x_fw, fw, bf16), *_gru_proj(x_bw, bw, bf16),
                       (fw["wh_g"], fw["wh_c"]), (bw["wh_g"], bw["wh_c"]), lengths, starts)


def _fused_bibnlstm(layer, x_fw, x_bw, lengths, starts, bf16=False):
    """x_bw reversed within each length (no flip mode: see the module note)."""
    del starts
    if moments_are_global():  # see _run_cell
        return (_run_cell("BNLSTM", layer["fw"], x_fw, lengths, bf16=bf16),
                _run_cell("BNLSTM", layer["bw"], x_bw, lengths, bf16=bf16))
    return bibnlstm_layer(_matmul(x_fw, layer["fw"]["wx"], bf16),
                          _matmul(x_bw, layer["bw"]["wx"], bf16),
                          _bn_weights(layer["fw"]), _bn_weights(layer["bw"]), lengths)


_FUSED = {"LSTM": _fused_bilstm, "GRU": _fused_bigru, "BNLSTM": _fused_bibnlstm}


def birnn_stack(params: Params, x: torch.Tensor, lengths: torch.Tensor,
                cell_type: str = "LSTM", layer_type: str = "normal",
                training: bool = False, bf16: bool = False) -> torch.Tensor:
    """Bidirectional stack. x: [B, T, C] -> [B, T, 2H] (bfloat16 for an LSTM
    stack in bf16 mode, else float32)."""
    if cell_type not in _FUSED:
        raise ValueError(f"Cell type unrecognized: {cell_type}")
    if layer_type not in ("normal", "rna"):
        raise ValueError(f"Layer type unrecognized: {layer_type}")
    xt = x.transpose(0, 1)  # time-major [T, B, C]
    t = xt.shape[0]
    lengths = lengths.to(torch.int32)
    flip = not training and cell_type in ("LSTM", "GRU")
    starts = (t - lengths).to(torch.int32) if flip else None

    def rev(arr):  # into and out of the backward direction's time order
        return torch.flip(arr, dims=(0,)) if flip else reverse_sequence(arr, lengths)

    def layer_fn(layer, x_fw, x_bw):
        if not training:
            return _FUSED[cell_type](layer, x_fw, x_bw, lengths, starts, bf16)
        return (_run_cell(cell_type, layer["fw"], x_fw, lengths, training),
                _run_cell(cell_type, layer["bw"], x_bw, lengths, training))

    if layer_type == "rna":
        fw, bw = xt, rev(xt)
        for layer in params["layers"]:
            fw, bw = layer_fn(layer, fw, bw)
        out = torch.cat([fw, rev(bw)], dim=-1)
    else:
        out = xt
        for layer in params["layers"]:
            fw, bw = layer_fn(layer, out, rev(out))
            out = torch.cat([fw, rev(bw)], dim=-1)
    return out.transpose(0, 1)  # back to [B, T, 2H]


def rnn_head(params: Params, lasth: torch.Tensor) -> torch.Tensor:
    """[B, T, 2H] -> [B, T, class_n] via direction-weighted sum + FC
    (chiron/rnn.py:72-97); a bfloat16 lasth is promoted to float32 first, as
    JAX promotes a mixed product."""
    b, t, two_h = lasth.shape
    pair = lasth.float().reshape(b, t, 2, two_h // 2)
    merged = torch.einsum("btdh,dh->bth", pair, params["w_dir"]) + params["b_dir"]
    return merged @ params["w_class"] + params["b_class"]


def rnn_layers(params: Params, x: torch.Tensor, lengths: torch.Tensor,
               cell_type: str = "LSTM", layer_type: str = "normal",
               training: bool = False, bf16: bool = False) -> torch.Tensor:
    lasth = birnn_stack(params["stack"], x, lengths, cell_type, layer_type, training, bf16)
    return rnn_head(params["head"], lasth)


def init_alternating_stack(gen: torch.Generator, c_in: int, hidden: int,
                           layer_num: int) -> Params:
    """Single-direction LSTM layers, each reading the last one's H."""
    return {"layers": [init_lstm_cell(gen, c_in if i == 0 else hidden, hidden)
                       for i in range(layer_num)]}


def layer_reversed(i: int, layer_num: int) -> bool:
    """Whether layer i of an alternating stack runs backwards in time: Bonito's
    ``rnn_encoder`` sets ``reverse = (layer_num - i) % 2``, so the last layer
    and every second one before it are reversed (layers 1, 3 and 5 of 5)."""
    return (layer_num - i) % 2 == 1


def alternating_stack(params: Params, x: torch.Tensor, lengths: torch.Tensor,
                      bf16: bool = False) -> torch.Tensor:
    """Bonito's LSTM encoder (``bonito/crf/model.py:rnn_encoder``) at
    inference: one direction a layer, alternating, each layer reading the
    previous one's h, on the single-direction kernel. x: [B, T, C] -> [B, T, H]
    (bfloat16 in bf16 mode).

    A reversed layer runs over each row's own frames in reverse, through the
    kernel's flip mode (the whole window flipped, the row active from
    ``T - len``). Bonito flips the whole padded chunk instead; its chunks are
    all full length, where a read's last window here is shorter."""
    h = x.transpose(0, 1)  # time-major [T, B, C]
    t = h.shape[0]
    lengths = lengths.to(torch.int32)
    starts = (t - lengths).to(torch.int32)
    layers = params["layers"]
    for i, cell in enumerate(layers):
        if layer_reversed(i, len(layers)):
            out = lstm_layer(_proj(torch.flip(h, dims=(0,)), cell, bf16), cell["wh"], lengths,
                             starts)
            h = torch.flip(out, dims=(0,))
        else:
            h = lstm_layer(_proj(h, cell, bf16), cell["wh"], lengths)
    return h.transpose(0, 1)


def init_unirnn_layers(gen: torch.Generator, c_in: int, hidden: int, layer_num: int,
                       class_n: int, cell_type: str = "BNLSTM") -> Params:
    """Single-direction stacked RNN + FC head (chiron/rnn.py:176-216)."""
    return {
        "layers": [_init_cell(cell_type, gen, c_in if i == 0 else hidden, hidden)
                   for i in range(layer_num)],
        "w_class": truncated_normal(gen, (hidden, class_n), math.sqrt(2.0 / hidden)),
        "b_class": torch.zeros(class_n),
    }


def unirnn_layers(params: Params, x: torch.Tensor, lengths: torch.Tensor,
                  cell_type: str = "BNLSTM", training: bool = False,
                  bf16: bool = False) -> torch.Tensor:
    """[B, T, C] -> [B, T, class_n] through a forward-only stack (``bf16``:
    bf16 inference mode, as in birnn_stack; training ignores it)."""
    h = x.transpose(0, 1)
    lengths = lengths.to(torch.int32)
    for layer in params["layers"]:
        h = _run_cell(cell_type, layer, h, lengths, training, bf16=bf16 and not training)
    return h.transpose(0, 1).float() @ params["w_class"] + params["b_class"]
