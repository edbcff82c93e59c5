"""Model assembly: CNN front + bidirectional RNN stack -> per-timestep CTC logits.

Port of ``chiron_tpu/models/model.py`` for the three bundled fronts
(reference: chiron/cnn.py:380-389, :454-476): ``dna_model1`` (3 residual
blocks of 256 channels), ``rna_model2`` (a k=9 stride-5 front conv + 3
residual blocks) and ``slow_model1`` (k=8 stride 4), with an LSTM, GRU or
BNLSTM stack of layer type ``normal`` or ``rna``. ``init_model(gen, config)``
draws fresh weights; ``apply_model(params, config, signal, seq_len,
training, bf16)`` returns logits [B, T_out, class_n]: at inference under
``no_grad`` through the fused kernels (in float32 or in bf16 inference mode),
in training differentiably (see layers.py and rnn.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from chiron_tpu_torch.config import class_n
from chiron_tpu_torch.models import layers as L
from chiron_tpu_torch.models import rnn as R

Params = Dict[str, Any]


def _apply_dna_model1(params, x, training=False, bf16=False):
    x = L.residual(params["res1"], x, training=training, bf16=bf16)
    x = L.residual(params["res2"], x, training=training, bf16=bf16)
    return L.residual(params["res3"], x, training=training, bf16=bf16)


def _init_dna_model1(gen, c_in):
    return {"res1": L.init_residual(gen, c_in, 256, i_bn=True),
            "res2": L.init_residual(gen, 256, 256),
            "res3": L.init_residual(gen, 256, 256)}


def _make_rna_front(kw: int, stride: int):
    def apply(params, x, training=False, bf16=False):
        x = L.conv(params["front"], x, stride=stride, training=training, bf16=bf16)
        x = L.residual(params["res1"], x, training=training, bf16=bf16)
        x = L.residual(params["res2"], x, training=training, bf16=bf16)
        return L.residual(params["res3"], x, training=training, bf16=bf16)

    def init(gen, c_in):
        return {"front": L.init_conv(gen, kw, c_in, 256),
                "res1": L.init_residual(gen, 256, 256, i_bn=True),
                "res2": L.init_residual(gen, 256, 256),
                "res3": L.init_residual(gen, 256, 256)}

    return apply, init


# name -> (time stride, apply(params, x, training, bf16), init(gen, c_in)); every
# front ends in 256 channels
CNN_ZOO: Dict[str, Tuple[int, Callable, Callable]] = {
    "dna_model1": (1, _apply_dna_model1, _init_dna_model1),
    "rna_model2": (5, *_make_rna_front(kw=9, stride=5)),
    "slow_model1": (4, *_make_rna_front(kw=8, stride=4)),
}


def _front(config: Dict[str, Any]) -> Tuple[int, Callable, Callable]:
    name = config["cnn"]["model"]
    if name not in CNN_ZOO:
        raise ValueError(f"CNN model {name!r} is not ported (have {sorted(CNN_ZOO)})")
    return CNN_ZOO[name]


def model_stride(config: Dict[str, Any]) -> int:
    """Static time-downsampling factor of the configured CNN."""
    return _front(config)[0]


def output_len(config: Dict[str, Any], seg_len: int) -> int:
    """Logit sequence length for an input window of seg_len samples."""
    return -(-seg_len // model_stride(config))  # SAME padding: ceil


def model_ratio(config: Dict[str, Any], seg_len: int) -> float:
    """Input-samples-per-logit ratio (chiron/chiron_model.py:150-152)."""
    return seg_len / output_len(config, seg_len)


def init_model(gen: torch.Generator, config: Dict[str, Any]) -> Params:
    """Fresh parameters for ``config``, in the JAX package's tree layout
    (float32 CPU tensors drawn from ``gen``)."""
    _, _, init_fn = _front(config)
    rnn_cfg = config["rnn"]
    if rnn_cfg["layer_num"] == 0:
        raise NotImplementedError("the CNN-only logit head is not ported")
    return {"cnn": init_fn(gen, 1),
            "rnn": R.init_rnn_layers(gen, 256, rnn_cfg["hidden_num"], rnn_cfg["layer_num"],
                                     class_n(config), rnn_cfg["cell_type"],
                                     rnn_cfg["layer_type"])}


def apply_model(params: Params, config: Dict[str, Any], signal: torch.Tensor,
                seq_len: torch.Tensor, training: bool = False,
                bf16: bool = False) -> torch.Tensor:
    """Forward pass: raw signal windows [B, T] -> CTC logits [B, T_out, C].

    ``seq_len`` [B] is each window's valid length IN LOGIT FRAMES (already
    divided by the model ratio, chiron/chiron_eval.py:337). ``training``
    takes the differentiable path; otherwise the fused kernels under
    ``no_grad``. ``bf16`` selects bf16 inference mode (see layers.py; the
    JAX package reads it from ``config["bf16"]``, which ``call --bf16`` sets);
    training ignores it. In that mode the window enters as bfloat16, as the
    pipeline uploads it (chiron_tpu/eval/pipeline.py:477-486): a float32
    window is rounded first. The logits are float32 in both modes.
    """
    _, apply_fn, _ = _front(config)
    rnn_cfg = config["rnn"]
    if rnn_cfg["layer_num"] == 0:
        raise NotImplementedError("the CNN-only logit head is not ported")
    bf16 = L.bf16_compute(bf16, training)
    with torch.set_grad_enabled(training and torch.is_grad_enabled()):
        x = L.store_activation(signal, bf16)[..., None]
        fea = L.materialize(apply_fn(params["cnn"], x, training=training, bf16=bf16), bf16)
        return R.rnn_layers(params["rnn"], fea, seq_len, rnn_cfg["cell_type"],
                            rnn_cfg["layer_type"], training=training, bf16=bf16)
