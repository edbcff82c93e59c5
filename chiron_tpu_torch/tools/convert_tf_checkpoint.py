"""Convert reference TF1 checkpoints into chiron_tpu parameter pytrees.

The port of ``chiron_tpu/tools/convert_tf_checkpoint.py`` (numpy only): the
same name maps and transforms, writing the tree layout that the port's
checkpoints hold and ``params.from_jax_params`` loads; the tests hold the
converted trees of the two packages equal.

The reference ships `model/DNA_default` / `model/RNA_default` as TF1
`tf.train.Saver` checkpoints (chiron_eval.py:272-276). This module maps the
TF variable names produced by the reference graphs (chiron/cnn.py scoping,
chiron/rnn.py:63-65,140-145 cell stacks) onto chiron_tpu's pytree paths and
repacks the tensors:

* conv kernels [1, k, c_in, c_out] -> [k, c_in, c_out]
* fused LSTM kernels [c_in + H, 4H] -> split (wx [c_in, 4H], wh [H, 4H]);
  TF's gate order (i, j, f, o) equals ours (i, g, f, o), and both apply the
  +1 forget bias at run time, so no gate permutation is needed.
* GRU gates/candidate kernels split the same way (TF order r, u matches).
* BNLSTM xh/hh BN offsets fold into the bias; the f-gate bias drops by 1
  because our scan adds the TF LSTMCell forget bias the reference's custom
  cell does not (chiron/utils/lstm.py:90).

Two graph "dialects" exist:
* current source: `simple_global_bn` batch-statistics BN with variables
  `<conv>_bn/<conv>_bn_{scale,offset}` (chiron/cnn.py:166-188).
* shipped checkpoints (final.ckpt-158301 / -80000): the older `batchnorm`
  with population statistics `<conv>_bn/{scale,offset,pop_mean,pop_var}`
  (chiron/cnn.py:125-163) — pop stats map onto our conv params'
  bn_mean/bn_var (population-statistics inference BN, models/layers.py).
  The shipped RNA checkpoint additionally predates rna_model3's front conv:
  its CNN is a plain 3x residual stack (verified from the .index variable
  list), so it converts with a dna_model1-shaped map and an adjusted
  model.json.

Reading the TF tensor bundle requires TensorFlow (`tf.train.load_checkpoint`)
— not bundled in this image, and the reference mount is missing the
checkpoint data blobs anyway (.MISSING_LARGE_BLOBS) — so ``convert``
accepts any name->ndarray mapping, which the tests exercise with synthetic
checkpoints shaped exactly like the reference graph's variables. Variable
NAMES and shapes, however, are validated against the real graphs via
tools/tf_index.py (no TF needed).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from chiron_tpu_torch import config as C

# transforms: how a TF tensor lands in the pytree
#   copy          verbatim
#   conv          [1, k, i, o] -> [k, i, o]
#   lstm_kernel   [c_in+H, 4H] -> wx/wh split
#   gru_gates     [c_in+H, 2H] -> wx_g/wh_g split
#   gru_cand      [c_in+H, H]  -> wx_c/wh_c split
#   bnlstm_offx / bnlstm_offh  folded into the cell bias post-pass
#   drop          present in the graph but semantically unused here


def _conv_entries(
    tf_scope: str, our_path: str, conv_name: str,
    bn: bool = True, bias: bool = False, bn_dialect: str = "global",
) -> Dict[str, tuple]:
    out = {f"{tf_scope}/{conv_name}/weights": (f"{our_path}/w", "conv")}
    if bias:
        out[f"{tf_scope}/{conv_name}/bias"] = (f"{our_path}/b", "copy")
    if bn:
        bn_scope = f"{tf_scope}/{conv_name}_bn"
        if bn_dialect == "global":
            # simple_global_bn: vars named <conv>_bn_{scale,offset} inside
            # the <conv>_bn scope (chiron/cnn.py:186-191)
            out[f"{bn_scope}/{conv_name}_bn_scale"] = (
                f"{our_path}/bn_scale", "copy")
            out[f"{bn_scope}/{conv_name}_bn_offset"] = (
                f"{our_path}/bn_offset", "copy")
        else:  # "pop": the older batchnorm (chiron/cnn.py:131-138)
            out[f"{bn_scope}/scale"] = (f"{our_path}/bn_scale", "copy")
            out[f"{bn_scope}/offset"] = (f"{our_path}/bn_offset", "copy")
            out[f"{bn_scope}/pop_mean"] = (f"{our_path}/bn_mean", "copy")
            out[f"{bn_scope}/pop_var"] = (f"{our_path}/bn_var", "copy")
    return out


def _residual_entries(tf_scope, our_path, i_bn, bn_dialect="global"):
    out = {}
    out.update(_conv_entries(f"{tf_scope}/branch1", f"{our_path}/branch1",
                             "conv1", bn=i_bn, bn_dialect=bn_dialect))
    for name in ("conv2a", "conv2b", "conv2c"):
        out.update(_conv_entries(f"{tf_scope}/branch2", f"{our_path}/{name}",
                                 name, bn_dialect=bn_dialect))
    return out


def _wavenet_entries(tf_scope, our_path, bn_dialect="global"):
    """wavenet_layer scopes (chiron/cnn.py:299-331) -> init_wavenet params."""
    out = {}
    out.update(_conv_entries(f"{tf_scope}/identity_branch",
                             f"{our_path}/identity", "identity",
                             bn_dialect=bn_dialect))
    out.update(_conv_entries(f"{tf_scope}/dilate_branch/gate_branch",
                             f"{our_path}/gate", "gate",
                             bn_dialect=bn_dialect))
    out.update(_conv_entries(f"{tf_scope}/dilate_branch/filter_branch",
                             f"{our_path}/filter", "filter",
                             bn_dialect=bn_dialect))
    out.update(_conv_entries(f"{tf_scope}/dilate_branch",
                             f"{our_path}/proj", "identity",
                             bn_dialect=bn_dialect))
    return out


_INCEPTION_LAYOUT = (
    # (tf branch scope, tf conv name, our conv key) — chiron/cnn.py:191-231
    ("branch1_AvgPooling", "conv1a_1x1", "conv1a"),
    ("branch2_1x1", "conv0b_1x1", "conv0b"),
    ("branch3_1x3", "conv0c_1x1", "conv0c"),
    ("branch3_1x3", "conv1c_1x3", "conv1c"),
    ("branch4_1x5", "conv0d_1x1", "conv0d"),
    ("branch4_1x5", "conv1d_1x5", "conv1d"),
    ("branch5_1x3_dilate_2", "conv0e_1x1", "conv0e"),
    ("branch5_1x3_dilate_2", "conv1e_1x3_d2", "conv1e"),
    ("branch6_1x3_dilate_3", "conv0f_1x1", "conv0f"),
    ("branch6_1x3_dilate_3", "conv1f_1x3_d3", "conv1f"),
)


def _inception_entries(tf_scope, our_path, bn_dialect="global"):
    out = {}
    for branch, conv_name, our_key in _INCEPTION_LAYOUT:
        out.update(_conv_entries(f"{tf_scope}/{branch}",
                                 f"{our_path}/{our_key}", conv_name,
                                 bn_dialect=bn_dialect))
    return out


def _gated_conv_entries(tf_scope, our_path, bn_dialect="global"):
    """gated_conv_layer scopes (chiron/cnn.py:85-124)."""
    out = {}
    out.update(_conv_entries(tf_scope, f"{our_path}/gate", "gate",
                             bias=True, bn_dialect=bn_dialect))
    out.update(_conv_entries(tf_scope, f"{our_path}/conv", "conv",
                             bias=True, bn_dialect=bn_dialect))
    out.update(_conv_entries(f"{tf_scope}/identity_branch",
                             f"{our_path}/identity", "conv1",
                             bn_dialect=bn_dialect))
    return out


def _three_res_entries(our_paths, bn_dialect):
    """res_layer1 (i_bn) + res_layer2/3 — the dna_model1 trunk shape."""
    out = {}
    for i, path in enumerate(our_paths):
        out.update(_residual_entries(f"res_layer{i + 1}", path, i == 0,
                                     bn_dialect))
    return out


def _cnn_name_map(config: Dict, bn_dialect: str,
                  legacy_rna_cnn: bool = False) -> Dict[str, tuple]:
    cnn_model = config["cnn"]["model"]
    cnn_config = config["cnn"]
    out: Dict[str, tuple] = {}
    if legacy_rna_cnn or cnn_model == "dna_model1" or cnn_model == "rna_model1":
        # rna_model1 adds a (parameter-free) pool + strides; the shipped RNA
        # checkpoint's legacy graph is also a plain 3x residual stack
        out.update(_three_res_entries(
            ["cnn/res1", "cnn/res2", "cnn/res3"], bn_dialect))
    elif cnn_model in ("rna_model2", "rna_model3"):
        out.update(_conv_entries("conv_layer", "cnn/front", "conv1",
                                 bn_dialect=bn_dialect))
        out.update(_three_res_entries(
            ["cnn/res1", "cnn/res2", "cnn/res3"], bn_dialect))
    elif cnn_model == "res_x":
        # Res_x scopes start at res_layer2 (chiron/cnn.py:373-378 loops
        # range(1, layer_num)) and every block has i_bn=True
        layer_num = int(cnn_config.get("layer_num", 10))
        for i in range(layer_num - 1):
            out.update(_residual_entries(f"res_layer{i + 2}",
                                         f"cnn/blocks/[{i}]", True,
                                         bn_dialect))
    elif cnn_model == "rna_test":
        for i in range(5):
            out.update(_residual_entries(f"res_layer{i + 1}",
                                         f"cnn/blocks/[{i}]", i == 0,
                                         bn_dialect))
    elif cnn_model == "variant_wavnet":
        res_layer = int(cnn_config.get("res_layer", 1))
        dilate_layer = int(cnn_config.get("dilate_layer", 7))
        dilate_repeat = int(cnn_config.get("dilate_repeat", 1))
        for i in range(res_layer):
            out.update(_residual_entries(f"res_layer{i + 1}",
                                         f"cnn/res/[{i}]", i == 0,
                                         bn_dialect))
        for r in range(dilate_repeat):
            for i in range(dilate_layer):
                out.update(_wavenet_entries(
                    f"block{r + 1}dilate_layer{i + 1}",
                    f"cnn/wave/[{r * dilate_layer + i}]", bn_dialect))
    elif cnn_model == "incp_v2":
        for i in range(4):
            out.update(_conv_entries(f"conv_layer{i + 1}",
                                     f"cnn/conv{i + 1}", "conv",
                                     bn_dialect=bn_dialect))
        for i in range(9):
            out.update(_inception_entries(f"incp_layer{i + 1}",
                                          f"cnn/incp/[{i}]", bn_dialect))
    elif cnn_model.startswith("gate_conv_net"):
        out.update(_residual_entries("conv_1", "cnn/res1", True, bn_dialect))
        for i in range(4):
            out.update(_gated_conv_entries(f"gated_conv{i + 1}",
                                           f"cnn/gates/[{i}]", bn_dialect))
    elif cnn_model == "dynamic_net":
        # NOTE: the reference's dynamic_net compares the layer-type LIST to
        # each type string (chiron/cnn.py:428-432), so its graphs contain no
        # CNN variables at all; this map covers the intended per-layer
        # scoping ("<tp>_layer<i>") for checkpoints from fixed forks.
        for i, tp in enumerate(cnn_config.get("tp", [])):
            scope = f"{tp}_layer{i}"
            if tp == "res":
                out.update(_residual_entries(scope, f"cnn/blocks/[{i}]",
                                             False, bn_dialect))
            elif tp == "conv":
                out.update(_conv_entries(scope, f"cnn/blocks/[{i}]", "conv",
                                         bn_dialect=bn_dialect))
    elif cnn_model == "custom":
        pass
    else:
        raise NotImplementedError(
            f"No TF name mapping for cnn model {cnn_model!r}"
        )
    return out


def _cell_entries(base: str, our_cell: str, cell_type: str) -> Dict[str, tuple]:
    """One direction of one stacked RNN layer."""
    if cell_type == "LSTM":
        return {
            f"{base}/lstm_cell/kernel": (our_cell, "lstm_kernel"),
            f"{base}/lstm_cell/bias": (f"{our_cell}/b", "copy"),
        }
    if cell_type == "GRU":
        return {
            f"{base}/gru_cell/gates/kernel": (our_cell, "gru_gates"),
            f"{base}/gru_cell/gates/bias": (f"{our_cell}/b_g", "copy"),
            f"{base}/gru_cell/candidate/kernel": (our_cell, "gru_cand"),
            f"{base}/gru_cell/candidate/bias": (f"{our_cell}/b_c", "copy"),
        }
    if cell_type == "BNLSTM":
        scope = f"{base}/BNLSTMCell"
        out = {
            f"{scope}/W_xh": (f"{our_cell}/wx", "copy"),
            f"{scope}/W_hh": (f"{our_cell}/wh", "copy"),
            f"{scope}/bias": (f"{our_cell}/b", "copy"),
            f"{scope}/xh/scale": (f"{our_cell}/scale_x", "copy"),
            f"{scope}/hh/scale": (f"{our_cell}/scale_h", "copy"),
            f"{scope}/c/scale": (f"{our_cell}/scale_c", "copy"),
            f"{scope}/c/offset": (f"{our_cell}/offset_c", "copy"),
            f"{scope}/xh/offset": (f"{our_cell}/_offx", "bnlstm_off"),
            f"{scope}/hh/offset": (f"{our_cell}/_offh", "bnlstm_off"),
        }
        # population statistics of the per-step BN have no slot in our
        # batch-statistics recurrence; acknowledged and dropped
        for proj in ("xh", "hh", "c"):
            out[f"{scope}/{proj}/pop_mean"] = ("", "drop")
            out[f"{scope}/{proj}/pop_var"] = ("", "drop")
        return out
    raise NotImplementedError(f"No TF name mapping for cell {cell_type!r}")


def build_name_map(config: Dict, bn_dialect: str = "global",
                   legacy_rna_cnn: bool = False) -> Dict[str, tuple]:
    """TF variable name -> (pytree path, transform) for a model config.

    ``bn_dialect``: "global" for graphs built from the current reference
    source (simple_global_bn), "pop" for the shipped checkpoints (the older
    population-statistics batchnorm). ``legacy_rna_cnn`` converts the
    shipped RNA checkpoint's pre-rna_model3 residual-only CNN.
    """
    name_map = _cnn_name_map(config, bn_dialect, legacy_rna_cnn)
    rnn_cfg = config["rnn"]
    cell_type = rnn_cfg.get("cell_type", "LSTM")
    for i in range(rnn_cfg["layer_num"]):
        for d, dname in (("fw", "fw"), ("bw", "bw")):
            if rnn_cfg.get("layer_type") == "rna":
                # bidirectional_dynamic_rnn over MultiRNNCell
                # (chiron/rnn.py:140-145)
                base = f"BDGRU_rnn/{dname}/multi_rnn_cell/cell_{i}"
            else:
                # stack_bidirectional_dynamic_rnn with the BDLSTM_rnn scope
                # (chiron/rnn.py:63-65); verified against the shipped
                # DNA_default .index variable list
                base = f"BDLSTM_rnn/cell_{i}/bidirectional_rnn/{dname}"
            name_map.update(_cell_entries(
                base, f"rnn/stack/layers/[{i}]/{d}", cell_type))
    if rnn_cfg["layer_num"] > 0:
        name_map["rnn_fnn_layer/weights"] = ("rnn/head/w_dir", "copy")
        name_map["rnn_fnn_layer/bias"] = ("rnn/head/b_dir", "copy")
        name_map["rnn_fnn_layer/weights_class"] = ("rnn/head/w_class", "copy")
        name_map["rnn_fnn_layer/bias_class"] = ("rnn/head/b_class", "copy")
    return name_map


def detect_dialect(var_names) -> Tuple[str, bool]:
    """(bn_dialect, legacy_rna_cnn) from a checkpoint's variable names."""
    names = set(var_names)
    pop = any(n.endswith("_bn/pop_mean") for n in names)
    has_front = any(n.startswith("conv_layer/conv1/") for n in names)
    has_res = any(n.startswith("res_layer1/") for n in names)
    return ("pop" if pop else "global"), (has_res and not has_front)


def _set_path(tree: dict, path: str, value):
    parts = path.split("/")
    node = tree
    for i, p in enumerate(parts[:-1]):
        nxt = parts[i + 1]
        if p.startswith("[") and p.endswith("]"):
            idx = int(p[1:-1])
            while len(node) <= idx:
                node.append({})
            node = node[idx]
        else:
            if p not in node:
                node[p] = [] if nxt.startswith("[") else {}
            node = node[p]
    node[parts[-1]] = value


def _fold_bnlstm_offsets(tree) -> None:
    """Fold xh/hh BN offsets into the bias; cancel our +1 forget bias."""
    if isinstance(tree, dict):
        if "_offx" in tree:
            b = np.asarray(tree["b"], np.float64)
            b = b + np.asarray(tree.pop("_offx")) + np.asarray(tree.pop("_offh"))
            h = b.shape[0] // 4
            b[2 * h:3 * h] -= 1.0  # reference BNLSTM has no forget bias
            tree["b"] = b.astype(np.float32)
        for v in tree.values():
            _fold_bnlstm_offsets(v)
    elif isinstance(tree, list):
        for v in tree:
            _fold_bnlstm_offsets(v)


def convert(
    get_tensor: Callable[[str], np.ndarray],
    config: Dict,
    hidden: int | None = None,
    bn_dialect: str = "global",
    legacy_rna_cnn: bool = False,
) -> dict:
    """Convert a TF checkpoint (via a name->tensor getter) to a pytree."""
    hidden = hidden or config["rnn"]["hidden_num"]
    name_map = build_name_map(config, bn_dialect, legacy_rna_cnn)
    params: dict = {}
    for tf_name, (path, transform) in name_map.items():
        if transform == "drop":
            continue
        tensor = np.asarray(get_tensor(tf_name))
        if transform == "conv":
            assert tensor.ndim == 4 and tensor.shape[0] == 1, tensor.shape
            _set_path(params, path, tensor[0])
        elif transform == "lstm_kernel":
            c_in = tensor.shape[0] - hidden
            _set_path(params, path + "/wx", tensor[:c_in])
            _set_path(params, path + "/wh", tensor[c_in:])
        elif transform == "gru_gates":
            c_in = tensor.shape[0] - hidden
            _set_path(params, path + "/wx_g", tensor[:c_in])
            _set_path(params, path + "/wh_g", tensor[c_in:])
        elif transform == "gru_cand":
            c_in = tensor.shape[0] - hidden
            _set_path(params, path + "/wx_c", tensor[:c_in])
            _set_path(params, path + "/wh_c", tensor[c_in:])
        else:  # copy / bnlstm_off
            _set_path(params, path, tensor)
    _fold_bnlstm_offsets(params)
    return params


def validate_name_map(config: Dict, index_path: str) -> Dict[str, List[str]]:
    """Check a name map against a real checkpoint's .index variable list.

    Returns {"missing": vars in the checkpoint the map does not cover,
             "extra": mapped names absent from the checkpoint,
             "bn_dialect"/"legacy_rna_cnn": what was auto-detected}.
    """
    from chiron_tpu_torch.tools.tf_index import model_variables

    variables = model_variables(index_path)
    bn_dialect, legacy = detect_dialect(variables)
    name_map = build_name_map(config, bn_dialect, legacy)
    missing = sorted(set(variables) - set(name_map))
    extra = sorted(set(name_map) - set(variables))
    return {"missing": missing, "extra": extra,
            "bn_dialect": bn_dialect, "legacy_rna_cnn": legacy}


def convert_checkpoint_dir(model_dir: str, out_dir: str | None = None) -> str:
    """Convert a reference model folder (requires TensorFlow to read it)."""
    import glob
    import os

    try:
        import tensorflow as tf  # type: ignore
    except ImportError as e:
        raise ImportError(
            "Converting real TF checkpoints requires tensorflow "
            "(pip install tensorflow) to read the tensor bundle. "
            "Note: the reference mount's checkpoint data blobs are absent "
            "(.MISSING_LARGE_BLOBS), so only externally obtained "
            "checkpoints can be converted."
        ) from e
    config = C.read_config(os.path.join(model_dir, "model.json"))
    ckpt = tf.train.latest_checkpoint(model_dir)
    if ckpt is None:
        # the shipped `checkpoint` files point at "final.ckpt" while the
        # data sits in final.ckpt-<step>.*; fall back to globbing
        cands = sorted(glob.glob(os.path.join(model_dir, "*.index")))
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {model_dir}")
        ckpt = cands[-1][: -len(".index")]
    from chiron_tpu_torch.tools.tf_index import model_variables

    bn_dialect, legacy = detect_dialect(model_variables(ckpt + ".index"))
    reader = tf.train.load_checkpoint(ckpt)
    params = convert(reader.get_tensor, config, bn_dialect=bn_dialect,
                     legacy_rna_cnn=legacy)
    if legacy and config["cnn"]["model"] in ("rna_model2", "rna_model3"):
        # the legacy RNA graph is a plain residual trunk with no strided
        # front conv: the converted weights run under dna_model1's apply
        config = dict(config, cnn=dict(config["cnn"], model="dna_model1"))
    from chiron_tpu_torch.train.checkpoint import save_checkpoint

    out_dir = out_dir or model_dir
    path = save_checkpoint(out_dir, params, 0, prefix="converted")
    C.save_config(os.path.join(out_dir, "model.json"), config)
    return path


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Convert a reference TF model folder (checkpoint + "
        "model.json) into this framework's npz checkpoint format, or "
        "validate name-map coverage against its .index (no TF needed)."
    )
    parser.add_argument("-m", "--model_dir", required=True,
                        help="Reference model folder (TF checkpoint + model.json).")
    parser.add_argument("-o", "--out_dir", default=None,
                        help="Output folder (default: alongside the input).")
    parser.add_argument("--validate", action="store_true",
                        help="Only check name-map coverage against the "
                             ".index variable list (works without TF).")
    args = parser.parse_args(argv)
    if args.validate:
        import glob
        import os

        config = C.read_config(os.path.join(args.model_dir, "model.json"))
        idx = sorted(glob.glob(os.path.join(args.model_dir, "*.index")))[-1]
        report = validate_name_map(config, idx)
        print(f"bn_dialect={report['bn_dialect']} "
              f"legacy_rna_cnn={report['legacy_rna_cnn']}")
        for key in ("missing", "extra"):
            print(f"{key}: {len(report[key])}")
            for name in report[key]:
                print(f"  {name}")
        return 1 if report["missing"] else 0
    out = convert_checkpoint_dir(args.model_dir, args.out_dir)
    print(f"Converted checkpoint written to: {out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
