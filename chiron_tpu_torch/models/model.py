"""Model assembly: CNN zoo + bidirectional RNN stack (or the CNN-only logit
head) -> per-timestep CTC logits.

Port of ``chiron_tpu/models/model.py`` (reference: chiron/cnn.py:350-645):
every front of the JAX package's zoo, each with its parameter tree key for
key, and an LSTM, GRU or BNLSTM stack of layer type ``normal`` or ``rna``,
or with ``rnn.layer_num`` 0 a linear logit head on the CNN features. A model
whose ``decoder`` is ``crf`` (``config.decoder``) is Bonito's CTC-CRF model
instead: the ``bonito_stem`` front, an ``alternating`` LSTM stack and the CRF
head (``models/crf.py``), whose scores [B, T_out, 4^(state_len + 1)]
``apply_model`` returns in place of logits.
``init_model(gen, config)`` draws fresh weights; ``apply_model(params,
config, signal, seq_len, training, bf16)`` returns logits [B, T_out,
class_n]: at inference under ``no_grad`` through the fused kernels (in
float32 or in bf16 inference mode), in training differentiably (see
layers.py and rnn.py). The time stride and the output width of a front come
from its init function and the config, as the JAX package takes them.
"""

from __future__ import annotations

import functools
import json
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from chiron_tpu_torch.config import class_n, decoder
from chiron_tpu_torch.models import crf as CRF
from chiron_tpu_torch.models import layers as L
from chiron_tpu_torch.models import rnn as R
from chiron_tpu_torch.models.initializers import xavier_normal
from chiron_tpu_torch.utils.timing import span

Params = Dict[str, Any]

# name -> (init(gen, c_in, cnn_config) -> (params, c_out, stride),
#          apply(params, x, cnn_config, training, bf16) -> y)
CNN_ZOO: Dict[str, Tuple[Callable, Callable]] = {}


def _residual_stack(params, x, training, bf16, stride=1):
    """The blocks in order; the first one at ``stride``."""
    for i, block in enumerate(params):
        x = L.residual(block, x, stride=stride if i == 0 else 1, training=training, bf16=bf16)
    return x


# -- dna_model1: 3x residual(256) (chiron/cnn.py:380-389) -------------------

def _init_dna_model1(gen, c_in, cnn_config):
    return {"res1": L.init_residual(gen, c_in, 256, i_bn=True),
            "res2": L.init_residual(gen, 256, 256),
            "res3": L.init_residual(gen, 256, 256)}, 256, 1


def _apply_dna_model1(params, x, cnn_config, training=False, bf16=False):
    return _residual_stack([params[k] for k in ("res1", "res2", "res3")], x, training, bf16)


CNN_ZOO["dna_model1"] = (_init_dna_model1, _apply_dna_model1)


# -- res_x: N-1 residual(256) blocks (chiron/cnn.py:373-378) -----------------

def _init_res_x(gen, c_in, cnn_config):
    layer_num = int(cnn_config.get("layer_num", 10))
    blocks, c = [], c_in
    for _ in range(layer_num - 1):
        blocks.append(L.init_residual(gen, c, 256, i_bn=True))
        c = 256
    return {"blocks": blocks}, c, 1


def _apply_blocks(params, x, cnn_config, training=False, bf16=False):
    return _residual_stack(params["blocks"], x, training, bf16)


CNN_ZOO["res_x"] = (_init_res_x, _apply_blocks)


# -- rna_model1: stride-2 pool + strided res + 2x res (chiron/cnn.py:391-401)

def _apply_rna_model1(params, x, cnn_config, training=False, bf16=False):
    x = L.avg_pool(x, ksize=3, stride=2, bf16=bf16)
    return _residual_stack([params[k] for k in ("res1", "res2", "res3")], x, training, bf16,
                           stride=2)


CNN_ZOO["rna_model1"] = (
    lambda gen, c_in, cnn_config: (_init_dna_model1(gen, c_in, cnn_config)[0], 256, 4),
    _apply_rna_model1)


# -- rna_model2 / rna_model3 / slow_model1: strided front conv + 3x res -----
# (chiron/cnn.py:454-476; slow_model1 is the JAX package's own extension)

def _make_rna_front(kw: int, stride: int):
    def init(gen, c_in, cnn_config):
        return {"front": L.init_conv(gen, kw, c_in, 256),
                "res1": L.init_residual(gen, 256, 256, i_bn=True),
                "res2": L.init_residual(gen, 256, 256),
                "res3": L.init_residual(gen, 256, 256)}, 256, stride

    def apply(params, x, cnn_config, training=False, bf16=False):
        x = L.conv(params["front"], x, stride=stride, training=training, bf16=bf16)
        return _residual_stack([params[k] for k in ("res1", "res2", "res3")], x, training,
                               bf16)

    return init, apply


CNN_ZOO["rna_model2"] = _make_rna_front(kw=9, stride=5)
CNN_ZOO["rna_model3"] = _make_rna_front(kw=14, stride=7)
CNN_ZOO["slow_model1"] = _make_rna_front(kw=8, stride=4)


# -- rna_test: 5x residual(256) (chiron/cnn.py:555-566) ---------------------

def _init_rna_test(gen, c_in, cnn_config):
    blocks = [L.init_residual(gen, c_in, 256, i_bn=True)]
    blocks += [L.init_residual(gen, 256, 256) for _ in range(4)]
    return {"blocks": blocks}, 256, 1


CNN_ZOO["rna_test"] = (_init_rna_test, _apply_blocks)


# -- variant_wavnet: res + dilated wavenet stack (chiron/cnn.py:570-581) ----

def _init_variant_wavnet(gen, c_in, cnn_config):
    res_layer = int(cnn_config.get("res_layer", 1))
    dilate_layer = int(cnn_config.get("dilate_layer", 7))
    dilate_repeat = int(cnn_config.get("dilate_repeat", 1))
    res = [L.init_residual(gen, c_in, 256, i_bn=True)]
    res += [L.init_residual(gen, 256, 256) for _ in range(1, res_layer)]
    wave = [L.init_wavenet(gen, 256, 256) for _ in range(dilate_repeat * dilate_layer)]
    return {"res": res, "wave": wave, "dilate_layer": dilate_layer}, 256, 1


def _apply_variant_wavnet(params, x, cnn_config, training=False, bf16=False):
    x = _residual_stack(params["res"], x, training, bf16)
    dilate_layer = int(params["dilate_layer"])
    for j, block in enumerate(params["wave"]):
        x = L.wavenet(block, x, dilation=2 ** (j % dilate_layer), training=training, bf16=bf16)
    return x


CNN_ZOO["variant_wavnet"] = (_init_variant_wavnet, _apply_variant_wavnet)


# -- incp_v2: conv x4 + inception x9 + pools (chiron/cnn.py:583-619) --------

def _init_incp_v2(gen, c_in, cnn_config):
    params = {"conv1": L.init_conv(gen, 3, c_in, 64),
              "conv2": L.init_conv(gen, 3, 64, 128),
              "conv3": L.init_conv(gen, 3, 128, 256),
              "conv4": L.init_conv(gen, 5, 256, 256),
              "incp": []}
    c = 256
    for _ in range(9):
        params["incp"].append(L.init_inception(gen, c, times=16))
        c = 16 * 3 * 6  # six branches of 3 * times channels each
    return params, c, 4  # two stride-2 max pools


def _apply_incp_v2(params, x, cnn_config, training=False, bf16=False):
    for name in ("conv1", "conv2", "conv3", "conv4"):
        x = L.conv(params[name], x, training=training, bf16=bf16)
    for i, block in enumerate(params["incp"]):
        x = L.inception(block, x, training=training, bf16=bf16)
        if i in (1, 6):
            x = L.max_pool(x, ksize=3, stride=2, bf16=bf16)
    return x


CNN_ZOO["incp_v2"] = (_init_incp_v2, _apply_incp_v2)


# -- gate_conv_net family (chiron/cnn.py:478-553) ---------------------------

def _make_gate_conv(arch):
    def init(gen, c_in, cnn_config):
        params = {"res1": L.init_residual(gen, c_in, arch["hu"][0], k=arch["kw"][0]),
                  "gates": []}
        c = arch["hu"][0]
        for i in range(1, 5):
            params["gates"].append(L.init_gated_conv(gen, c, arch["hu"][i], arch["kw"][i]))
            c = arch["hu"][i]
        return params, c, arch["strides"][0]

    def apply(params, x, cnn_config, training=False, bf16=False):
        x = L.residual(params["res1"], x, stride=arch["strides"][0], training=training,
                       bf16=bf16)
        for i, block in enumerate(params["gates"]):
            x = L.gated_conv(block, x, dilation=arch["strides"][i + 1], training=training,
                             bf16=bf16)
        return x

    return init, apply


CNN_ZOO["gate_conv_net"] = _make_gate_conv(
    {"hu": [256] * 5, "kw": [13, 3, 5, 5, 5], "strides": [5, 1, 2, 4, 8]})
CNN_ZOO["gate_conv_net_low"] = _make_gate_conv(
    {"hu": [256] * 5, "kw": [13, 3, 3, 3, 3], "strides": [5, 1, 3, 6, 9]})
# the first five entries of the reference's 11-element arch lists, the ones
# its gate_conv_kernal reads (chiron/cnn.py:489-531, :548-553)
CNN_ZOO["gate_conv_net_high"] = _make_gate_conv(
    {"hu": [200, 200, 400, 600, 800], "kw": [17, 7, 11, 15, 19], "strides": [9, 1, 1, 1, 1]})


# -- dynamic_net: config-driven layer stack (chiron/cnn.py:403-452) ---------

def _init_dynamic_net(gen, c_in, cnn_config):
    tps, hus, kws, sts, pds = (cnn_config[k] for k in ("tp", "hu", "kw", "st", "pd"))
    if not len(hus) == len(kws) == len(sts) == len(tps) == len(pds):
        raise ValueError("dynamic_net: tp, hu, kw, st and pd must have one entry a layer")
    blocks, c, stride = [], c_in, 1
    for i, tp in enumerate(tps):
        if tp == "res":
            blocks.append(L.init_residual(gen, c, hus[i], k=kws[i]))
            c = hus[i]
        elif tp == "conv":
            blocks.append(L.init_conv(gen, kws[i], c, hus[i]))
            c = hus[i]
        else:  # pooling layers hold no params
            blocks.append({})
        stride *= max(int(sts[i]), 1)
    return {"blocks": blocks}, c, stride


def _apply_dynamic_net(params, x, cnn_config, training=False, bf16=False):
    kw = dict(training=training, bf16=bf16)
    for block, tp, k, st, pd in zip(params["blocks"], *(cnn_config[key] for key in
                                                        ("tp", "kw", "st", "pd"))):
        st = max(int(st), 1)
        if tp == "res":
            x = L.residual(block, x, stride=st, **kw)
        elif tp == "conv":
            x = L.conv(block, x, stride=st, padding=pd, **kw)
        elif tp == "p_avg":
            x = L.avg_pool(x, ksize=k, stride=st, padding=pd, bf16=bf16)
        elif tp == "p_max":
            x = L.max_pool(x, ksize=k, stride=st, padding=pd, bf16=bf16)
    return x


CNN_ZOO["dynamic_net"] = (_init_dynamic_net, _apply_dynamic_net)


# -- custom: identity passthrough (chiron/cnn.py:621-623) -------------------

CNN_ZOO["custom"] = (lambda gen, c_in, cnn_config: ({}, c_in, 1),
                     lambda params, x, cnn_config, training=False, bf16=False: x)


# -- bonito_stem: Bonito's conv stem (bonito/crf/model.py:rnn_encoder) -----
# three biased convs with swish, each padded k // 2 on both sides:
# 1 -> 4 (k 5), 4 -> 16 (k 5), 16 -> features (k winlen, at the stride)

def _bonito_stem_shapes(cnn_config):
    f, k = int(cnn_config.get("features", 384)), int(cnn_config.get("winlen", 19))
    return [(5, 4, 1), (5, 16, 1), (k, f, int(cnn_config.get("stride", 5)))]


def _init_bonito_stem(gen, c_in, cnn_config):
    params, c = {}, c_in
    for i, (k, c_out, _) in enumerate(_bonito_stem_shapes(cnn_config)):
        params[f"conv{i + 1}"] = L.init_conv(gen, k, c, c_out, bias=True, bn=False)
        c = c_out
    return params, c, _bonito_stem_shapes(cnn_config)[-1][2]


def _apply_bonito_stem(params, x, cnn_config, training=False, bf16=False):
    if training:
        raise ValueError("a CRF model runs at inference only: the port has no CTC-CRF loss")
    for i, (k, _, stride) in enumerate(_bonito_stem_shapes(cnn_config)):
        x = L.stem_conv(params[f"conv{i + 1}"], x, stride=stride, padding=k // 2, bf16=bf16)
    return x


CNN_ZOO["bonito_stem"] = (_init_bonito_stem, _apply_bonito_stem)


# -- CNN-only logit head (chiron/cnn.py:625-645), for rnn.layer_num == 0 ----

def init_cnn_logit(gen: torch.Generator, c_in: int, n_class: int) -> Params:
    return {"w": xavier_normal(gen, (c_in, n_class)), "b": xavier_normal(gen, (n_class,))}


def cnn_logit(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, T, class_n]; a bfloat16 x is promoted to float32
    first, as JAX promotes a mixed product."""
    return x.float() @ params["w"] + params["b"]


# --------------------------------------------------------------------------
# full-model assembly
# --------------------------------------------------------------------------

def _front(config: Dict[str, Any]) -> Tuple[Callable, Callable]:
    name = config["cnn"]["model"]
    if name not in CNN_ZOO:
        raise ValueError(f"Unknown CNN model: {name!r} (have {sorted(CNN_ZOO)})")
    return CNN_ZOO[name]


@functools.lru_cache(maxsize=None)
def _stride(cnn_json: str) -> int:
    """A front's stride, from its init (which draws every weight: ~1 s for
    gate_conv_net_high on a CPU), once per CNN config."""
    cnn = json.loads(cnn_json)
    return _front({"cnn": cnn})[0](torch.Generator().manual_seed(0), 1, cnn)[2]


def model_stride(config: Dict[str, Any]) -> int:
    """Static time-downsampling factor of the configured CNN (its init's)."""
    return _stride(json.dumps(config["cnn"], sort_keys=True))


def output_len(config: Dict[str, Any], seg_len: int) -> int:
    """Logit sequence length for an input window of seg_len samples: the JAX
    package's ceil(seg_len / stride), which assumes SAME padding (a
    dynamic_net VALID layer gives fewer frames; ROADMAP C4)."""
    return -(-seg_len // model_stride(config))


def model_ratio(config: Dict[str, Any], seg_len: int) -> float:
    """Input-samples-per-logit ratio (chiron/chiron_model.py:150-152)."""
    return seg_len / output_len(config, seg_len)


def window_frames(config: Dict[str, Any], samples, seg_len: int):
    """Each window's frames [B] int32 from its samples [B] (numpy): the
    JAX package's round(samples / ratio) (chiron/chiron_eval.py:337); for a
    CRF model ceil(samples / stride), the frames whose centre lies in the
    window, as Bonito's convs give a window of that length."""
    if decoder(config)["type"] == "crf":
        stride = model_stride(config)
        return ((np.asarray(samples) + stride - 1) // stride).astype(np.int32)
    return np.round(np.asarray(samples) / model_ratio(config, seg_len)).astype(np.int32)


def _check_crf(config: Dict[str, Any]) -> Dict[str, Any]:
    dec = decoder(config)
    rnn_cfg = config["rnn"]
    alternating = rnn_cfg.get("layer_type") == "alternating"
    if (dec["type"] == "crf") != alternating or alternating and rnn_cfg["cell_type"] != "LSTM":
        raise ValueError("a CRF decoder takes an alternating LSTM stack, and an alternating "
                         "stack a CRF decoder")
    return dec


def init_model(gen: torch.Generator, config: Dict[str, Any]) -> Params:
    """Fresh parameters for ``config``, in the JAX package's tree layout
    (float32 CPU tensors drawn from ``gen``; static int leaves stay ints)."""
    init_fn, _ = _front(config)
    cnn_params, c_out, _ = init_fn(gen, 1, config["cnn"])
    rnn_cfg = config["rnn"]
    dec = _check_crf(config)
    if dec["type"] == "crf":
        h = rnn_cfg["hidden_num"]
        return {"cnn": cnn_params,
                "rnn": {"stack": R.init_alternating_stack(gen, c_out, h, rnn_cfg["layer_num"])},
                "crf": CRF.init_crf_head(gen, h, dec["state_len"])}
    if rnn_cfg["layer_num"] == 0:
        return {"cnn": cnn_params, "cnn_logit": init_cnn_logit(gen, c_out, class_n(config))}
    return {"cnn": cnn_params,
            "rnn": R.init_rnn_layers(gen, c_out, rnn_cfg["hidden_num"], rnn_cfg["layer_num"],
                                     class_n(config), rnn_cfg["cell_type"],
                                     rnn_cfg["layer_type"])}


def apply_model(params: Params, config: Dict[str, Any], signal: torch.Tensor,
                seq_len: torch.Tensor, training: bool = False,
                bf16: bool = False) -> torch.Tensor:
    """Forward pass: raw signal windows [B, T] -> CTC logits [B, T_out, C].

    ``seq_len`` [B] is each window's valid length IN LOGIT FRAMES (already
    divided by the model ratio, chiron/chiron_eval.py:337); the CNN-only
    head does not read it. ``training`` takes the differentiable path;
    otherwise the fused kernels under ``no_grad``. ``bf16`` selects bf16
    inference mode (see layers.py; the JAX package reads it from
    ``config["bf16"]``, which ``call --bf16`` sets); training ignores it. In
    that mode the window enters as bfloat16, as the pipeline uploads it
    (chiron_tpu/eval/pipeline.py:477-486): a float32 window is rounded
    first. The logits are float32 in both modes.

    The CNN runs in a ``model.front`` span; the RNN stack and the logit head
    (the CNN-only head's product alone) in a ``model.rnn`` span. A CRF model
    returns its head's scores, the head in a ``model.crf_head`` span.
    """
    if _check_crf(config)["type"] == "crf":
        fea = encode(params, config, signal, seq_len, training, bf16)
        with torch.set_grad_enabled(training and torch.is_grad_enabled()):
            return crf_scores(params, config, fea, L.bf16_compute(bf16, training))
    fea = _front_features(params, config, signal, training, bf16)
    with torch.set_grad_enabled(training and torch.is_grad_enabled()), span("model.rnn"):
        if config["rnn"]["layer_num"] == 0:
            return cnn_logit(params["cnn_logit"], fea)
        return R.rnn_head(params["rnn"]["head"],
                          _rnn_stack(params, config, fea, seq_len, training, bf16))


def encode(params: Params, config: Dict[str, Any], signal: torch.Tensor,
           seq_len: torch.Tensor, training: bool = False, bf16: bool = False) -> torch.Tensor:
    """The features that feed the logit head: the BiRNN stack's [B, T_out, 2H]
    (the CNN's [B, T_out, C] for the CNN-only head; an alternating stack's
    [B, T_out, H] for a CRF model's head). ``apply_model`` is the
    head over these; the attention decoder reads them as its encodings."""
    fea = _front_features(params, config, signal, training, bf16)
    if config["rnn"]["layer_num"] == 0:
        return fea
    with torch.set_grad_enabled(training and torch.is_grad_enabled()), span("model.rnn"):
        return _rnn_stack(params, config, fea, seq_len, training, bf16)


def crf_scores(params: Params, config: Dict[str, Any], fea: torch.Tensor,
               bf16: bool = False) -> torch.Tensor:
    """A CRF model's head over the stack's features: float32 scores
    [B, T, 4^(state_len + 1)], in a ``model.crf_head`` span."""
    with span("model.crf_head"):
        return CRF.crf_head(params["crf"], fea, decoder(config)["scale"], bf16)


def _front_features(params: Params, config: Dict[str, Any], signal: torch.Tensor,
                    training: bool, bf16: bool) -> torch.Tensor:
    """The CNN front's features [B, T_out, C], in a ``model.front`` span."""
    _, apply_fn = _front(config)
    bf16 = L.bf16_compute(bf16, training)
    with torch.set_grad_enabled(training and torch.is_grad_enabled()), span("model.front"):
        x = L.store_activation(signal, bf16)[..., None]
        return L.materialize(apply_fn(params["cnn"], x, config["cnn"], training=training,
                                      bf16=bf16), bf16)


def _rnn_stack(params: Params, config: Dict[str, Any], fea: torch.Tensor,
               seq_len: torch.Tensor, training: bool, bf16: bool) -> torch.Tensor:
    rnn_cfg = config["rnn"]
    if rnn_cfg["layer_type"] == "alternating":  # a CRF model: inference only (the stem)
        return R.alternating_stack(params["rnn"]["stack"], fea, seq_len, bf16=bf16)
    return R.birnn_stack(params["rnn"]["stack"], fea, seq_len, rnn_cfg["cell_type"],
                         rnn_cfg["layer_type"], training=training,
                         bf16=L.bf16_compute(bf16, training))
