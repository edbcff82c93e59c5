"""Model assembly: CNN front + BiLSTM stack -> per-timestep CTC logits.

Port of ``chiron_tpu/models/model.py`` for the three bundled fronts
(reference: chiron/cnn.py:380-389, :454-476): ``dna_model1`` (3 residual
blocks of 256 channels), ``rna_model2`` (a k=9 stride-5 front conv + 3
residual blocks) and ``slow_model1`` (k=8 stride 4). Inference only.
``apply_model(params, config, signal, seq_len)`` returns logits
[B, T_out, class_n].
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from chiron_tpu_torch.models import layers as L
from chiron_tpu_torch.models import rnn as R

Params = Dict[str, Any]


def _apply_dna_model1(params, x):
    x = L.residual(params["res1"], x)
    x = L.residual(params["res2"], x)
    return L.residual(params["res3"], x)


def _make_rna_front(stride: int):
    def apply(params, x):
        x = L.conv(params["front"], x, stride=stride)
        x = L.residual(params["res1"], x)
        x = L.residual(params["res2"], x)
        return L.residual(params["res3"], x)

    return apply


# name -> (time stride, apply(params, x))
CNN_ZOO: Dict[str, Tuple[int, Callable]] = {
    "dna_model1": (1, _apply_dna_model1),
    "rna_model2": (5, _make_rna_front(stride=5)),
    "slow_model1": (4, _make_rna_front(stride=4)),
}


def _front(config: Dict[str, Any]) -> Tuple[int, Callable]:
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


def apply_model(params: Params, config: Dict[str, Any], signal: torch.Tensor,
                seq_len: torch.Tensor) -> torch.Tensor:
    """Forward pass: raw signal windows [B, T] -> CTC logits [B, T_out, C].

    ``seq_len`` [B] is each window's valid length IN LOGIT FRAMES (already
    divided by the model ratio, chiron/chiron_eval.py:337).
    """
    _, apply_fn = _front(config)
    rnn_cfg = config["rnn"]
    if rnn_cfg["layer_num"] == 0:
        raise NotImplementedError("the CNN-only logit head is not ported")
    with torch.no_grad():
        fea = L.materialize(apply_fn(params["cnn"], signal[..., None]))
        return R.rnn_layers(params["rnn"], fea, seq_len, rnn_cfg["cell_type"],
                            rnn_cfg["layer_type"])
