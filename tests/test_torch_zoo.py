"""The port's CNN zoo and CNN-only logit head (chiron_tpu_torch/models) against
the JAX package on the CPU: every front of ``chiron_tpu/models/model.py``'s
``CNN_ZOO`` with JAX ``init_model`` weights carried across by
``from_jax_params``, the general conv, the pooling layers, the fusion gate,
the parameter trees and checkpoints, one train step, and ``call`` and
``train`` through the CLI.

Tolerances, and why:
- float32 logits: within 5e-4 of max |logit| (``tests/test_torch_model.py``'s
  bar): the port's fused convs take one-pass moments, JAX's CPU path two-pass
  ones, and the sums run in another order;
- bf16 logits against the JAX package's fused path (its TPU path, every
  Pallas kernel in interpret mode, as ``tests/test_torch_bf16.py`` runs it):
  within 1e-2 of max |logit|, and closer to it than the port's float32
  logits are (the bar alone would pass most fronts run in float32).
  ``incp_v2`` normalises through 94 batch-stat convs, and each bfloat16
  rounding flip that a float32 sum-order residue causes propagates through
  the rest: the JAX package's own bf16 logits move by 4.5-9.3% of max
  |logit| when 1% of the window's samples move one bfloat16 ulp (measured at
  these shapes), so it is held within that spread, measured in the test on
  the JAX side and capped at 9.3%; the port's float32 logits must fall
  outside the bar;
- the unfused conv chain: float32 within 1e-5 (sum order); bf16 outputs
  equal or one bfloat16 ulp apart and at least 99% identical (a float32 sum
  order residue straddling a rounding midpoint flips one ulp, and the BN
  statistics carry it to a few more elements);
- pooling: bit for bit in both dtypes (the same adds in the same order, each
  rounded to bfloat16 as XLA rounds them);
- one train step: loss rtol 1e-5; each gradient leaf within 1e-4 of its own
  max |grad| plus 1e-4 of the largest gradient of the model, as
  ``chip_smoke.py``'s train check: a bias ahead of a batch-stat BN (the
  gated convs' ``b``) has an exact gradient of zero, so its float32 residue
  (~1e-9) has no scale of its own.
"""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.models.rnn as jrnn
from chiron_tpu.eval import pipeline as jpipe
from chiron_tpu.models import layers as JL
from chiron_tpu.models import model as jmodel
from chiron_tpu.ops.ctc_loss import ctc_focal_loss as j_ctc_focal_loss
from chiron_tpu.ops.pallas import convbn as jconvbn
from chiron_tpu.ops.pallas import lstm as jlstm
from chiron_tpu.train import checkpoint as jckpt
from chiron_tpu_torch import cli
from chiron_tpu_torch.models import layers as TL
from chiron_tpu_torch.models import model as tmodel
from chiron_tpu_torch.ops import conv_bn as tconv
from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
from chiron_tpu_torch.train import checkpoint as tckpt
from chiron_tpu_torch.train import loop as tloop
from synth import make_training_dir

BF16 = torch.bfloat16
LOGIT_TOL = 5e-4
BF16_LOGIT_TOL = 1e-2
# incp_v2's bf16 bar: the JAX side's spread under one-ulp input moves, at most
# the largest spread measured at these shapes
INCP_BF16_CAP = 0.093

# a dynamic_net with every layer type, SAME and VALID layers, odd widths
DYNAMIC = {"model": "dynamic_net", "tp": ["res", "conv", "p_avg", "conv", "p_max"],
           "hu": [16, 24, 0, 20, 0], "kw": [5, 3, 3, 4, 2], "st": [2, 1, 2, 1, 2],
           "pd": ["SAME", "VALID", "SAME", "SAME", "VALID"]}
# the form tools/grid_search.py writes (its 15/3/3 kernels, 5/1/1 strides), narrower
DYNAMIC_GRID = {"model": "dynamic_net", "tp": ["res"] * 3, "hu": [32] * 3, "kw": [15, 3, 3],
                "st": [5, 1, 1], "pd": ["SAME"] * 3}

# name -> (cnn config, window): small widths where the JAX defaults allow;
# incp_v2 and the gate_conv_net family are fixed in the JAX code
FRONTS = {
    "dna_model1": ({"model": "dna_model1"}, 48),
    "res_x": ({"model": "res_x", "layer_num": 3}, 48),
    "rna_model1": ({"model": "rna_model1"}, 64),
    "rna_model2": ({"model": "rna_model2"}, 100),
    "rna_model3": ({"model": "rna_model3"}, 98),
    "slow_model1": ({"model": "slow_model1"}, 64),
    "rna_test": ({"model": "rna_test"}, 40),
    "variant_wavnet": ({"model": "variant_wavnet", "dilate_layer": 2, "dilate_repeat": 2}, 48),
    "incp_v2": ({"model": "incp_v2"}, 48),
    "gate_conv_net": ({"model": "gate_conv_net"}, 100),
    "gate_conv_net_low": ({"model": "gate_conv_net_low"}, 100),
    "gate_conv_net_high": ({"model": "gate_conv_net_high"}, 180),
    "dynamic_net": (DYNAMIC, 64),
    "dynamic_net_grid": (DYNAMIC_GRID, 100),
    "custom": ({"model": "custom"}, 40),
}
# the fronts this file holds one by one: every front but the three bundled ones,
# which tests/test_torch_model.py and tests/test_torch_bf16.py hold with each
# cell type
ZOO = sorted(set(FRONTS) - {"dna_model1", "rna_model2", "slow_model1"})


def _config(front, layer_num=0, hidden=16):
    cnn, _ = FRONTS[front]
    return {"cnn": dict(cnn), "rnn": {"layer_num": layer_num, "hidden_num": hidden,
                                      "cell_type": "LSTM", "layer_type": "normal"}}


def _inputs(config, seg, seed, bsz=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, seg).astype(np.float32)
    t_out = tmodel.output_len(config, seg)  # == JAX's (test_output_len_and_ratio_match_jax)
    return x, np.array([t_out] * (bsz - 3) + [t_out - 3, 1, t_out // 2], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params(front, layer_num=0, hidden=16):
    """JAX init_model weights for a config, drawn once for the file and
    shared by every test that reads them (nothing writes to them: the port
    copies them): JAX compiles a random draw for each new weight shape,
    ~0.25 s each on the CPU, a few seconds for incp_v2 or
    gate_conv_net_high."""
    return jmodel.init_model(jax.random.PRNGKey(1), _config(front, layer_num, hidden))


def _port(params, config):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), config, "cpu")


def _is_int_leaf(v):
    """A Python int leaf, or what jax.eval_shape makes of one: a weak-typed
    integer scalar (an init draws no integer arrays)."""
    return isinstance(v, int) or (isinstance(v, jax.ShapeDtypeStruct) and v.weak_type
                                  and v.shape == () and jnp.issubdtype(v.dtype, jnp.integer))


def _shapes(tree):
    return {jax.tree_util.keystr(k): ("int" if _is_int_leaf(v) else tuple(np.shape(v)))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread, as tests/test_torch_accuracy.py
    does: under the suite's test workers, torch's thread pools competing for
    the cores made one CLI train case here 40x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_fused_path(monkeypatch):
    """The JAX package's TPU inference path on the CPU: Pallas on, the conv+BN
    and BiLSTM kernels in interpret mode (nothing in chiron_tpu changes)."""
    monkeypatch.setattr(jrnn, "_use_pallas", lambda: True)
    for mod, name in ((jconvbn, "conv_bn_pallas"), (jlstm, "bilstm_layer_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


def _split_ints(params):
    """(the tree without its int leaves, a function that puts them back): JAX's
    jit and grad refuse variant_wavnet's int ``dilate_layer`` (ROADMAP C), so
    the JAX side closes over it."""
    ints = {k: v for k, v in params["cnn"].items() if isinstance(v, int)}
    floats = {**params, "cnn": {k: v for k, v in params["cnn"].items() if k not in ints}}
    return floats, lambda p: {**p, "cnn": {**p["cnn"], **ints}}


_JITTED = {}


def _jax_logits(params, config, x, seq_len, bf16=False):
    """JAX apply_model, jitted (compiling the whole forward once is several
    times faster on the CPU than dispatching it op by op), one jitted
    function a (config, int leaves, mode, path) shared across tests: the
    path is part of the key, since the fused one is traced under the
    jax_fused_path fixture. In bf16 mode the window enters as bfloat16, as
    the JAX pipeline uploads it."""
    floats, full = _split_ints(params)
    cfg = dict(config, bf16=True) if bf16 else config
    key = (json.dumps(cfg, sort_keys=True), repr(full({"cnn": {}})), jrnn._use_pallas())
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, s, n: jmodel.apply_model(full(p), cfg, s, n))
    return np.asarray(_JITTED[key](floats, jnp.asarray(x, dtype=jnp.bfloat16 if bf16
                                                       else jnp.float32),
                                   jnp.asarray(seq_len)))


def _jax_bf16(params, config, x, seq_len):
    return _jax_logits(params, config, x, seq_len, bf16=True)


def _one_ulp_moved(x: np.ndarray, share: float = 0.01) -> np.ndarray:
    """x rounded to bfloat16 with the last mantissa bit of a seeded share of
    the samples flipped."""
    bits = torch.tensor(x).to(BF16).view(torch.int16).clone()
    bits[torch.rand(bits.shape, generator=torch.Generator().manual_seed(0)) < share] ^= 1
    return bits.view(BF16).float().numpy()


# ---- every front and the CNN-only head against JAX apply_model --------------

@pytest.mark.parametrize("front", ZOO)
def test_front_with_cnn_logit_head_matches_jax(front):
    config, params = _config(front), _jax_params(front)
    x, seq_len = _inputs(config, FRONTS[front][1], 0)
    want = _jax_logits(params, config, x, seq_len)
    got = _port(params, config)(torch.tensor(x), torch.tensor(seq_len))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("front", ZOO)
def test_front_bf16_matches_jax_fused_path(jax_fused_path, front):
    config, params = _config(front), _jax_params(front)
    x, seq_len = _inputs(config, FRONTS[front][1], 4, bsz=8)
    want = _jax_bf16(params, config, x, seq_len)
    model = _port(params, config)
    got = model(torch.tensor(x), torch.tensor(seq_len), bf16=True)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    err_f32 = float(np.abs(model(torch.tensor(x), torch.tensor(seq_len)).numpy() - want).max())
    scale = float(np.abs(want).max())
    tol = BF16_LOGIT_TOL * scale
    if front == "incp_v2":  # the JAX side's own spread under one-ulp input moves
        spread = float(np.abs(_jax_bf16(params, config, _one_ulp_moved(x), seq_len)
                              - want).max())
        tol = min(max(tol, spread), INCP_BF16_CAP * scale)
        assert err_f32 > tol  # the bar tells bf16 from float32
    assert err <= tol
    assert err < err_f32  # bf16 mode rounds as JAX's does, not as float32


# the RNN stack at the zoo's feature widths: 1 (custom), 288 (incp_v2), 800
# (gate_conv_net_high), a grid_search dynamic_net
RNN_FRONTS = ["custom", "incp_v2", "gate_conv_net_high", "dynamic_net_grid"]


@pytest.mark.parametrize("front", RNN_FRONTS)
def test_front_with_lstm_stack_matches_jax(front):
    config, params = _config(front, layer_num=1), _jax_params(front, 1)
    x, seq_len = _inputs(config, FRONTS[front][1], 1)
    want = _jax_logits(params, config, x, seq_len)
    got = _port(params, config)(torch.tensor(x), torch.tensor(seq_len)).numpy()
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("front", ["custom", "gate_conv_net_high"])
def test_front_with_lstm_stack_bf16_matches_jax_fused_path(jax_fused_path, front):
    config, params = _config(front, layer_num=1, hidden=20), _jax_params(front, 1, 20)
    x, seq_len = _inputs(config, FRONTS[front][1], 2, bsz=8)
    want = _jax_bf16(params, config, x, seq_len)
    got = _port(params, config)(torch.tensor(x), torch.tensor(seq_len), bf16=True).numpy()
    assert float(np.abs(got - want).max()) <= BF16_LOGIT_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("front", ["dna_model1", "incp_v2", "rna_model2", "rna_model3"])
def test_fused_fronts_match_jax_fused_path(jax_fused_path, front):
    """The fronts tests/test_convbn.py runs fused, against JAX's fused path in
    float32 (its conv_bn_pallas in interpret mode under fused_cnn)."""
    config, params = _config(front), _jax_params(front)
    x, seq_len = _inputs(config, FRONTS[front][1], 5, bsz=4)
    want = _jax_logits(params, config, x, seq_len)
    got = _port(params, config)(torch.tensor(x), torch.tensor(seq_len)).numpy()
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * float(np.abs(want).max())


def test_dynamic_net_valid_layers_keep_jax_output_len():
    """JAX's output_len assumes SAME padding; the port gives its numbers, quirk
    included (ROADMAP C4): a VALID dynamic_net window has fewer frames."""
    config, params = _config("dynamic_net", layer_num=1), _jax_params("dynamic_net", 1)
    seg = FRONTS["dynamic_net"][1]
    assert tmodel.output_len(config, seg) == jmodel.output_len(config, seg) == 8
    assert tmodel.model_ratio(config, seg) == jmodel.model_ratio(config, seg)
    x, _ = _inputs(config, seg, 3)
    seq_len = np.array([7, 7, 5, 1, 0, 6], np.int32)  # within the 7 frames a window has
    want = _jax_logits(params, config, x, seq_len)
    got = _port(params, config)(torch.tensor(x), torch.tensor(seq_len)).numpy()
    assert got.shape == want.shape == (6, 7, 5)
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("front", ZOO)
def test_output_len_and_ratio_match_jax(front):
    config = _config(front)
    for seg in (FRONTS[front][1], 400, 2001):
        assert tmodel.output_len(config, seg) == jmodel.output_len(config, seg)
        assert tmodel.model_stride(config) == jmodel.model_stride(config)


def test_unknown_front_raises():
    config = {"cnn": {"model": "no_such_net"}, "rnn": {"layer_num": 0}}
    with pytest.raises(ValueError, match="Unknown CNN model"):
        tmodel.init_model(torch.Generator().manual_seed(0), config)
    with pytest.raises(ValueError, match="Unknown CNN model"):
        tmodel.output_len(config, 400)


# ---- parameter trees and checkpoints ----------------------------------------

@pytest.mark.parametrize("layer_num", [0, 2])
@pytest.mark.parametrize("front", ZOO)
def test_init_model_matches_jax_shapes(front, layer_num):
    config = _config(front, layer_num)
    got = tmodel.init_model(torch.Generator().manual_seed(0), config)
    # the shapes JAX's init gives, traced without drawing (or compiling) a weight
    want = jax.eval_shape(lambda key: jmodel.init_model(key, config), jax.random.PRNGKey(0))
    assert _shapes(got) == _shapes(want)
    assert ("cnn_logit" in got) == (layer_num == 0) == ("rnn" not in got)


@pytest.mark.parametrize("front", ZOO)
def test_checkpoint_round_trip_both_ways(tmp_path, front):
    """Lists, int leaves and empty dicts survive each package's checkpoints
    and from_jax_params; the int leaf stays a Python int, never a Parameter."""
    config = _config(front, layer_num=0)
    tree = tmodel.init_model(torch.Generator().manual_seed(1), config)
    numpy_tree = jax.tree_util.tree_map(lambda a: a.numpy() if isinstance(a, torch.Tensor)
                                        else a, tree)
    tckpt.save_checkpoint(str(tmp_path / "t"), numpy_tree, 1)
    by_jax, _ = jckpt.restore_latest(str(tmp_path / "t"))
    jparams = _jax_params(front)
    jckpt.save_checkpoint(str(tmp_path / "j"), jax.tree_util.tree_map(np.asarray, jparams), 1)
    by_port, _ = tckpt.restore_latest(str(tmp_path / "j"))
    for loaded, src in ((by_jax, numpy_tree), (by_port, jparams)):
        assert _shapes(loaded) == _shapes(src)
        model = from_jax_params(loaded, config, "cpu")
        back = to_numpy_tree(model)
        assert _shapes(back) == _shapes(src)
        for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                  jax.tree_util.tree_flatten_with_path(src)[0]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(k))
        assert len(model.flat) == sum(not isinstance(v, int)
                                      for v in jax.tree_util.tree_leaves(src))
    if front == "variant_wavnet":
        assert by_port["cnn"]["dilate_layer"] == 2 and isinstance(by_port["cnn"]["dilate_layer"],
                                                                   int)
        port = _port(jparams, config)  # numpy 0-d int leaf in, Python int out
        assert type(port.params["cnn"]["dilate_layer"]) is int
    if front == "dynamic_net":
        assert by_port["cnn"]["blocks"][2] == {} and by_jax["cnn"]["blocks"][4] == {}


# ---- the layers: conv chain, fusion gate, pooling ---------------------------

@pytest.mark.parametrize("active", ["relu", None, "sigmoid", "tanh", "elu"])
def test_fusion_gate_matches_jax(active):
    """A conv takes the fused kernel exactly where JAX's _fused_conv_ok (fused
    flag on) sends it, and the port's conv returns a LazyBN exactly then."""
    x = torch.randn(2, 12, 8, generator=torch.Generator().manual_seed(0))
    for bias in (False, True):
        params = TL.init_conv(torch.Generator().manual_seed(1), 3, 8, 8, bias=bias)
        jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
        for dilation in (1, 2):
            for padding in ("SAME", "VALID"):
                with JL.fused_cnn(True):
                    want = JL._fused_conv_ok(jparams, 1, dilation, padding, active)
                got = TL.fused_conv_ok(params, dilation, padding, active)
                assert got == want
                out = TL.conv(params, x, dilation=dilation, padding=padding, active=active)
                assert isinstance(out, TL.LazyBN) == want
                train_out = TL.conv(params, x, dilation=dilation, padding=padding,
                                    active=active, training=True)
                assert isinstance(train_out, torch.Tensor)


# stride, dilation, padding, activation, bias, pop-stats BN, k, t
CONV_CASES = [
    (1, 2, "SAME", "sigmoid", True, False, 2, 40),
    (1, 3, "SAME", "tanh", True, False, 3, 33),
    (2, 1, "VALID", "relu", False, False, 4, 41),
    (3, 2, "VALID", "elu", True, False, 3, 30),
    (1, 1, "SAME", "elu", False, True, 5, 24),
    (5, 1, "VALID", None, True, False, 13, 60),
]


@pytest.mark.parametrize("stride,dilation,padding,active,bias,pop,k,t", CONV_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_unfused_conv_matches_jax(stride, dilation, padding, active, bias, pop, k, t, bf16):
    rng = np.random.RandomState(k + t)
    c_in, c_out = 12, 16
    x = rng.randn(3, t, c_in).astype(np.float32)
    params = {"w": (rng.randn(k, c_in, c_out) * 0.3).astype(np.float32),
              "bn_scale": (0.5 + rng.rand(c_out)).astype(np.float32),
              "bn_offset": rng.randn(c_out).astype(np.float32)}
    if bias:
        params["b"] = rng.randn(c_out).astype(np.float32)
    if pop:
        params["bn_mean"] = rng.randn(c_out).astype(np.float32)
        params["bn_var"] = (0.5 + rng.rand(c_out)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    with JL.bf16_compute(bf16):
        want = np.asarray(JL.conv({k_: jnp.asarray(v) for k_, v in params.items()}, jx,
                                  stride=stride, dilation=dilation, padding=padding,
                                  active=active).astype(jnp.float32))
    tx = torch.tensor(x).to(BF16 if bf16 else torch.float32)
    got = TL.conv({k_: torch.tensor(v) for k_, v in params.items()}, tx, stride=stride,
                  dilation=dilation, padding=padding, active=active, bf16=bf16)
    assert got.dtype == (BF16 if bf16 else torch.float32) and got.shape == want.shape
    got = got.float().numpy()
    if not bf16:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = np.abs(torch.tensor(want).to(BF16).float().numpy()) * 2.0 ** -7
        assert (np.abs(got - want) <= ulp + 1e-30).all()
        assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("t,k,stride,dilation,padding", [
    (20, 3, 1, 2, "SAME"), (21, 4, 2, 3, "SAME"), (20, 5, 3, 1, "VALID"),
    (19, 3, 2, 4, "VALID"), (5, 4, 2, 2, "VALID"), (1, 17, 9, 1, "SAME")])
def test_conv1d_matches_xla(t, k, stride, dilation, padding):
    rng = np.random.RandomState(t * k)
    x = rng.randn(2, t, 6).astype(np.float32)
    w = rng.randn(k, 6, 5).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(stride,), padding=padding,
        rhs_dilation=(dilation,), dimension_numbers=("NWC", "WIO", "NWC")))
    got = tconv.conv1d(torch.tensor(x), torch.tensor(w), stride, dilation, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", ["avg_pool", "max_pool"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooling_matches_jax_bit_for_bit(pool, dtype):
    rng = np.random.RandomState(0)
    jf, tf = getattr(JL, pool), getattr(TL, pool)
    for t in (51, 7):
        for k, stride, padding in ((3, 1, "SAME"), (3, 2, "SAME"), (4, 2, "SAME"),
                                   (5, 3, "VALID"), (9, 2, "VALID")):
            x = rng.randn(3, t, 6).astype(np.float32)
            want = np.asarray(jf(jnp.asarray(x, dtype=dtype), k, stride, padding)
                              .astype(jnp.float32))
            got = tf(torch.tensor(x).to(getattr(torch, dtype)), k, stride, padding)
            assert str(got.dtype) == f"torch.{dtype}"
            np.testing.assert_array_equal(got.float().numpy(), want)


# ---- training ----------------------------------------------------------------

def _train_batch(rng, t, b=8, u=14):
    seq_len = np.array([64, 64, 60, 52, 40, 33, 20, 6], np.int32)[:b]
    label_len = rng.randint(3, u + 1, size=b).astype(np.int32)
    labels = np.full((b, u), -1, np.int32)
    for i in range(b):
        labels[i, :label_len[i]] = rng.randint(0, 4, label_len[i])
    return {"signal": rng.randn(b, t).astype(np.float32), "seq_len": seq_len,
            "label": labels, "label_len": label_len}


def _jax_loss_and_grads(params, config, batch):
    """JAX's train loss (chiron_tpu/train/loop.py:79-88) and its gradient, the
    int leaves closed over (JAX's make_train_step cannot train
    variant_wavnet: see _split_ints)."""
    floats, full = _split_ints(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits = jmodel.apply_model(full(p), config, jb["signal"], jb["seq_len"],
                                    training=True)
        return j_ctc_focal_loss(logits, jb["seq_len"], jb["label"], jb["label_len"],
                                fl_gamma=2.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(floats)
    return float(loss), {jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]}


@pytest.mark.parametrize("front,layer_num,t", [("gate_conv_net", 1, 320),
                                               ("variant_wavnet", 1, 64), ("custom", 0, 64)])
def test_train_step_matches_jax(front, layer_num, t):
    config = {**_config(front, layer_num), "opt_method": "Adam", "fl_gamma": 2}
    params = jmodel.init_model(jax.random.PRNGKey(3), config)
    batch = _train_batch(np.random.RandomState(2), t)
    jloss, jgrads = _jax_loss_and_grads(params, config, batch)
    model = _port(params, config).requires_grad_(True)
    ema = _port(params, config)
    opt = tloop.make_optimizer("Adam", 1e-3, 100, model.parameters())
    loss = tloop.make_train_step(config, 2.0)(model, ema, opt,
                                              {k: torch.tensor(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    grads = {"".join(f"[{p!r}]" if not p.startswith("[") else p for p in key.split("/")):
             p_.grad.numpy() for key, p_ in model.flat.items()}
    assert grads.keys() == jgrads.keys()
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    for key, g in grads.items():
        want = jgrads[key]
        assert float(np.abs(g - want).max()) <= 1e-4 * (float(np.abs(want).max()) + top), key


# ---- the CLI: call and train on the CPU --------------------------------------

def test_cli_call_with_a_zoo_model_matches_jax_pipeline(tmp_path):
    """A dynamic_net of tools/grid_search.py's form, its checkpoint written by
    the port: `call` through the port's CLI and the JAX pipeline write the
    same fastq."""
    config = _config("dynamic_net_grid", layer_num=1)
    model_dir = str(tmp_path / "model")
    tree = tmodel.init_model(torch.Generator().manual_seed(3), config)
    tckpt.save_checkpoint(model_dir, jax.tree_util.tree_map(lambda a: a.numpy(), tree), 1)
    with open(os.path.join(model_dir, "model.json"), "w") as f:
        json.dump(config, f)
    sig = tmp_path / "sig"
    sig.mkdir()
    rng = np.random.RandomState(5)
    for i in range(2):
        np.savetxt(sig / f"read{i}.signal", rng.randint(300, 700, 700 + 130 * i), fmt="%d")
    tout, jout = str(tmp_path / "torch"), str(tmp_path / "jax")
    res = cli.main(["call", "-i", str(sig), "-o", tout, "-m", model_dir, "-b", "8", "-l",
                    "120", "-j", "110", "--beam", "0", "--device", "cpu"])
    assert res["n_files"] == 2 and res["total_windows"] > 8
    jpipe.run(types.SimpleNamespace(
        input=str(sig), output=jout, model=model_dir, start=0, batch_size=8, segment_len=120,
        jump=110, threads=0, beam=0, extension="fastq", concise=False, mode="dna",
        reverse_fast5=False, recursive=False, sig_norm=None))
    for name in ("read0.fastq", "read1.fastq"):
        with open(os.path.join(tout, "result", name)) as a, \
                open(os.path.join(jout, "result", name)) as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("front", ["custom", "variant_wavnet"])
def test_cli_train_then_call_cnn_only_head(tmp_path, front):
    """`layer_num: 0`: train through the CLI, then call with the model it
    wrote (variant_wavnet: its int leaf through the checkpoint and both entry
    points, which the JAX package's jitted steps refuse)."""
    data = str(tmp_path / "train")
    make_training_dir(data, n_files=2, n_bases=200, seed=2)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({**_config(front, 0), "opt_method": "Adam", "fl_gamma": 2}, f)
    result = cli.main(["train", "-i", data, "-o", str(tmp_path / "log"), "-m", "m", "-s", "120",
                       "-b", "16", "-t", "1e-2", "-x", "5", "--configure", cfg_path,
                       "--device", "cpu"])
    assert len(result["losses"]) == 1 and np.isfinite(result["losses"][0])
    tree, step = tckpt.restore_latest(result["model_dir"])
    assert step == 5 and set(tree) == {"cnn", "cnn_logit"}
    assert tree["cnn"] == {} if front == "custom" else tree["cnn"]["dilate_layer"] == 2
    out = str(tmp_path / "out")
    res = cli.main(["call", "-i", data, "-o", out, "-m", result["model_dir"], "-b", "8", "-l",
                    "120", "-j", "110", "--beam", "5", "--device", "cpu"])
    assert res["n_files"] == 2 and res["total_windows"] > 0
    assert len(os.listdir(os.path.join(out, "result"))) == 2


# ---- what the card runs: chip_smoke.py's zoo phase and the on-card tests ------

def test_chip_smoke_zoo_covers_every_front_and_counts_its_convs(monkeypatch):
    """chip_smoke.py's ZOO drives every front of the JAX package's zoo that no
    bundled model runs, plus the CNN-only head; the conv_bn launches it expects
    a batch (fused_convs, from the config) are the launches the port makes; and
    the conv shapes those fronts give at a dna-pre window are the ones
    tests/test_torch_cuda.py holds on the card at full size."""
    import chip_smoke
    from test_torch_cuda import ZOO_CONV_SHAPES

    bundled = {"dna_model1", "rna_model2", "slow_model1"}
    assert set(jmodel.CNN_ZOO) - bundled == {c["model"] for n, c in chip_smoke.ZOO.items()
                                             if n != "cnn_logit"}
    assert chip_smoke.ZOO["cnn_logit"]["model"] in bundled
    shapes, conv_bn = set(), tconv.conv_bn

    def recording(terms, w, relu_in, stride=1, out_dtype=torch.float32):
        calls.append(1)
        shapes.add((w.shape[0], stride, terms[0][0].shape[1], w.shape[1], w.shape[2],
                    len(terms), bool(relu_in)))
        return conv_bn(terms, w, relu_in, stride=stride, out_dtype=out_dtype)

    monkeypatch.setattr(TL, "conv_bn", recording)
    for name, cnn in chip_smoke.ZOO.items():
        config = {"cnn": cnn, "rnn": {"layer_num": 0}}
        params = tmodel.init_model(torch.Generator().manual_seed(0), config)
        calls = []
        with torch.no_grad():
            tmodel.apply_model(params, config, torch.randn(2, 400),
                               torch.zeros(2, dtype=torch.int32))
        assert len(calls) == chip_smoke.fused_convs(cnn), name
    dna_model1 = {(1, 1, 400, 1, 256, 1, False), (1, 1, 400, 256, 256, 2, True),
                  (1, 1, 400, 256, 256, 1, True), (3, 1, 400, 256, 256, 1, True)}
    assert shapes - dna_model1 == set(ZOO_CONV_SHAPES)
