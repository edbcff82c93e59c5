"""bf16 inference mode of the port (``bf16=True``, ``call --bf16``) against the
JAX package's fused (TPU) path, on the CPU.

The reference is the JAX package's Pallas kernels in interpret mode, not its
CPU path: on the CPU the JAX package takes the unfused conv (which rounds w to
bfloat16) and the LSTM scan (float32 xw), another function. For the whole
model the tests turn the fused path on the way a TPU would
(``chiron_tpu.models.rnn._use_pallas`` returns True) and run every Pallas
kernel it reaches with ``interpret=True``; nothing in ``chiron_tpu`` changes.

Tolerances, and why:
- a kernel's bfloat16 outputs against the Pallas kernel's: every element
  equal or one bfloat16 ulp apart, and at least 99.9% identical. The two
  float32 values agree to ~1e-7 (sum order); they round to different
  bfloat16 values only where they straddle a rounding midpoint. Near zero
  that residue spans several ulps of a tiny value (an LSTM h of -1.8e-6
  landed 7 ulps, 5e-8, apart), so an element may also differ by no more
  than the kernel's float32 gate (1e-5 for the LSTM, 1e-4 for the conv);
- float32 moments: 1e-4 (rtol and atol), as the float32 conv tests;
- the model's logits: within 1e-2 of max |logit|. Each bf16 rounding flip
  moves an activation by 2^-8 relative, and the flips propagate through 12
  batch-stat convs (at the CNN's end ~20% of the features sit one ulp apart)
  and the recurrent stack. A BNLSTM stack normalises every step by the
  batch's moments and amplifies them further: the JAX package's own bf16
  logits move by 2-3.5% of max |logit| when 1% of the window's samples move
  by one bf16 ulp. So a BNLSTM model is held within that spread, measured in
  the test on the JAX side, and every stack, the BNLSTM's too, is also held
  on identical bf16 input features within 1e-2 of max |logit|;
- bf16 against the port's own float32 mode: within JAX's own 0.15
  (tests/test_model.py:107), and not equal (the mode is engaged).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiron_tpu.models.rnn as jrnn
from chiron_tpu.models import model as jmodel
from chiron_tpu.ops.pallas import bnlstm as jbnlstm
from chiron_tpu.ops.pallas import convbn as jconvbn
from chiron_tpu.ops.pallas import gru as jgru
from chiron_tpu.ops.pallas import lstm as jlstm
from chiron_tpu_torch import cli as tcli
from chiron_tpu_torch.models import layers as TL
from chiron_tpu_torch.models import rnn as trnn
from chiron_tpu_torch.ops import bilstm as tbl
from chiron_tpu_torch.ops import conv_bn as tconv
from chiron_tpu_torch.ops import lstm as tlstm
from chiron_tpu_torch.params import from_jax_params

BF16 = torch.bfloat16
MIN_SAME = 0.999  # share of bfloat16 outputs identical to the reference's
LOGIT_TOL = 1e-2  # model logits, relative to max |logit|
MOM_TOL = dict(rtol=1e-4, atol=1e-4)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (int16) -> integers in the order of the values,
    so that two values one ulp apart differ by 1 (+0 and -0 both map to 0)."""
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _as_float(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def assert_bf16_close(got, want, atol, min_same=MIN_SAME):
    """Equal or one bfloat16 ulp apart (or within the float32 gate ``atol``)
    everywhere, identical on >= min_same."""
    g, w = _ordered(_bf16_bits(got)), _ordered(_bf16_bits(want))
    assert g.shape == w.shape
    ulps = np.abs(g - w)
    off = (ulps > 1) & (np.abs(_as_float(got) - _as_float(want)) > atol)
    assert not off.any(), f"{int(off.sum())} elements more than 1 ulp and {atol} apart"
    same = float((ulps == 0).mean()) if ulps.size else 1.0
    assert same >= min_same, f"only {same:.5f} identical"


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    return torch.tensor(a).to(BF16).float().numpy()


# ---- conv_bn: the bf16 instance's function against conv_bn_pallas(out_dtype=bf16)

CONV_CASES = [
    # k, stride, t, c_in, c_out, n_terms, relu_in, bsz
    (1, 1, 24, 1, 16, 1, False, 4),    # first-layer C_in = 1, the bf16 window
    (1, 1, 24, 16, 8, 2, True, 4),
    (3, 1, 32, 16, 32, 2, True, 3),
    (3, 1, 20, 8, 8, 1, False, 2),
    (9, 5, 50, 1, 16, 1, False, 4),    # rna_model2 front
    (8, 4, 64, 1, 16, 1, False, 3),    # slow_model1 front
    (9, 5, 51, 8, 8, 2, True, 2),      # t % stride != 0, two terms
    (8, 4, 30, 4, 8, 1, True, 4),
]


def _conv_inputs(seed, bsz, t, c_in, c_out, k, n_terms):
    rng = np.random.RandomState(seed)
    terms = [(_bf16_round(rng.randn(bsz, t, c_in).astype(np.float32)),
              (0.5 + rng.rand(c_in)).astype(np.float32),
              (rng.randn(c_in) * 0.2).astype(np.float32)) for _ in range(n_terms)]
    w = (rng.randn(k, c_in, c_out) * 0.3).astype(np.float32)
    return terms, w


def _torch_terms(terms):
    return [(torch.tensor(r).to(BF16), torch.tensor(a), torch.tensor(b)) for r, a, b in terms]


@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,relu_in,bsz", CONV_CASES)
def test_conv_bn_bf16_matches_pallas_interpret(k, stride, t, c_in, c_out, n_terms, relu_in,
                                               bsz):
    terms, w = _conv_inputs(k * 100 + stride + c_in, bsz, t, c_in, c_out, k, n_terms)
    jy, js, jq = jconvbn.conv_bn_pallas(
        tuple((jnp.asarray(r, dtype=jnp.bfloat16), jnp.asarray(a), jnp.asarray(b))
              for r, a, b in terms),
        jnp.asarray(w), k, relu_in, stride=stride, out_dtype=jnp.bfloat16, interpret=True)
    ty, ts, tq = tconv.conv_bn(_torch_terms(terms), torch.tensor(w), relu_in, stride,
                               out_dtype=BF16)
    assert ty.dtype == BF16 and ts.dtype == tq.dtype == torch.float32
    assert_bf16_close(ty, jy, 1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **MOM_TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **MOM_TOL)


@pytest.mark.parametrize("n_terms", [1, 2])
def test_conv_bn_bf16_is_the_f32_function_rounded(n_terms):
    """The bf16 instance's arithmetic: the float32 function on the upcast raws,
    y rounded to nearest even afterwards, moments identical (bit for bit)."""
    terms, w = _conv_inputs(5 + n_terms, 3, 40, 16, 24, 3, n_terms)
    tt = _torch_terms(terms)
    y, s, q = tconv.conv_bn(tt, torch.tensor(w), True, 1, out_dtype=BF16)
    y32, s32, q32 = tconv.conv_bn([(r.float(), a, b) for r, a, b in tt], torch.tensor(w), True, 1)
    assert torch.equal(y, y32.to(BF16)) and torch.equal(s, s32) and torch.equal(q, q32)


# ---- the LSTM inference kernels (rows 2 and 5) on bf16 xw --------------------

def _lstm_inputs(seed, t, b, h):
    rng = np.random.RandomState(seed)
    xw_f = _bf16_round(rng.randn(t, b, 4 * h).astype(np.float32))
    xw_b = _bf16_round(rng.randn(t, b, 4 * h).astype(np.float32))
    wh_f = (rng.randn(h, 4 * h) * 0.3).astype(np.float32)
    wh_b = (rng.randn(h, 4 * h) * 0.3).astype(np.float32)
    lengths = rng.randint(1, t, size=b).astype(np.int32)
    lengths[0], lengths[-1] = 0, t  # empty and full rows
    return xw_f, xw_b, wh_f, wh_b, lengths


def _padded_wh(wh, h):
    return jlstm.pad_lstm_weights(jnp.zeros((1, 4 * h)), jnp.asarray(wh),
                                  np.zeros(4 * h, np.float32), h)[1]


def _jax_xw(xw, h):
    return jlstm.pad_gate_cols(jnp.asarray(xw, dtype=jnp.bfloat16), h)


# H = 20 and 12: gate widths that are no multiple of 8 (a 16-byte chunk of
# bf16 xw would straddle two gates on the card)
@pytest.mark.parametrize("h,t,b,seed", [(20, 12, 5, 0), (12, 20, 8, 1)])
def test_bilstm_bf16_matches_pallas_interpret(h, t, b, seed):
    xw_f, xw_b, wh_f, wh_b, lengths = _lstm_inputs(seed, t, b, h)
    jf, jb = jlstm.bilstm_layer_pallas(
        _jax_xw(xw_f, h), _jax_xw(xw_b, h), _padded_wh(wh_f, h), _padded_wh(wh_b, h),
        jnp.asarray(lengths), jnp.asarray(t - lengths), hidden=h, interpret=True)
    assert jf.dtype == jnp.bfloat16
    tf, tb = tbl.bilstm_layer(torch.tensor(xw_f).to(BF16), torch.tensor(xw_b).to(BF16),
                              torch.tensor(wh_f), torch.tensor(wh_b), torch.tensor(lengths),
                              torch.tensor((t - lengths).astype(np.int32)))
    assert tf.dtype == tb.dtype == BF16
    assert_bf16_close(tf, jf, 1e-5)
    assert_bf16_close(tb, jb, 1e-5)


@pytest.mark.parametrize("h", [20, 12])
@pytest.mark.parametrize("with_starts", [False, True])
def test_lstm_layer_bf16_matches_pallas_interpret(h, with_starts):
    t, b = 12, 16
    xw, _, wh, _, lengths = _lstm_inputs(10 + h, t, b, h)
    lengths[4:8] = 5
    starts = (t - lengths).astype(np.int32) if with_starts else None
    want = jlstm.lstm_layer_pallas(
        _jax_xw(xw, h), _padded_wh(wh, h), jnp.asarray(lengths), hidden=h, interpret=True,
        starts=None if starts is None else jnp.asarray(starts))
    got = tlstm.lstm_layer(torch.tensor(xw).to(BF16), torch.tensor(wh), torch.tensor(lengths),
                           None if starts is None else torch.tensor(starts))
    assert got.dtype == BF16
    assert_bf16_close(got, want, 1e-5)


def test_lstm_bf16_is_the_f32_function_rounded():
    """bf16 xw: the float32 recurrence on the upcast xw, h rounded afterwards,
    bit for bit (the card's bf16 instance is held to the same)."""
    t = 10
    xw_f, xw_b, wh_f, wh_b, lengths = _lstm_inputs(3, t, 6, 20)
    lens, starts = torch.tensor(lengths), torch.tensor((t - lengths).astype(np.int32))
    args = (torch.tensor(wh_f), torch.tensor(wh_b), lens, starts)
    got = tbl.bilstm_layer(torch.tensor(xw_f).to(BF16), torch.tensor(xw_b).to(BF16), *args)
    want = tbl.bilstm_layer(torch.tensor(xw_f), torch.tensor(xw_b), *args)
    assert all(torch.equal(g, w.to(BF16)) for g, w in zip(got, want))
    one = tlstm.lstm_layer(torch.tensor(xw_b).to(BF16), torch.tensor(wh_b), lens, starts)
    assert torch.equal(one, got[1])


# ---- the wrappers refuse what no kernel instance takes -----------------------

def _bad_recurrent_calls():
    t, b, h = 3, 2, 8
    xw32 = torch.zeros(t, b, 4 * h)
    xw16 = xw32.to(BF16)
    wh32 = torch.zeros(h, 4 * h)
    lens = torch.ones(b, dtype=torch.int32)
    return {
        "bilstm_mixed_directions": lambda: tbl.bilstm_layer(xw16, xw32, wh32, wh32, lens, lens),
        "bilstm_bf16_wh": lambda: tbl.bilstm_layer(xw16, xw16, wh32.to(BF16), wh32, lens, lens),
        "bilstm_float16": lambda: tbl.bilstm_layer(xw32.half(), xw32.half(), wh32, wh32, lens,
                                                   lens),
        "lstm_layer_bf16_wh": lambda: tlstm.lstm_layer(xw16, wh32.to(BF16), lens),
    }


def _bad_conv_calls():
    raw = torch.zeros(2, 8, 4)
    one, w = torch.ones(4), torch.zeros(3, 4, 4)
    return {
        "conv_mixed_terms": lambda: tconv.conv_bn([(raw.to(BF16), one, one), (raw, one, one)],
                                                  w, False, out_dtype=BF16),
        "conv_bf16_raw_to_f32_y": lambda: tconv.conv_bn([(raw.to(BF16), one, one)], w, False),
        "conv_f32_raw_to_bf16_y": lambda: tconv.conv_bn([(raw, one, one)], w, False,
                                                        out_dtype=BF16),
        "conv_bf16_w": lambda: tconv.conv_bn([(raw.to(BF16), one, one)], w.to(BF16), False,
                                             out_dtype=BF16),
        "conv_bf16_affine": lambda: tconv.conv_bn([(raw.to(BF16), one.to(BF16), one)], w,
                                                  False, out_dtype=BF16),
    }


@pytest.mark.parametrize("case", sorted(_bad_recurrent_calls()) + sorted(_bad_conv_calls()))
def test_wrappers_refuse_mixed_or_unsupported_dtypes(case):
    calls = {**_bad_recurrent_calls(), **_bad_conv_calls()}
    with pytest.raises(ValueError):
        calls[case]()


def test_cpu_bf16_calls_count_no_launch():
    before = (dict(tconv.launches_by_dtype), dict(tbl.launches_by_dtype),
              dict(tlstm.launches_by_dtype))
    terms, w = _conv_inputs(0, 2, 8, 4, 4, 3, 1)
    tconv.conv_bn(_torch_terms(terms), torch.tensor(w), True, out_dtype=BF16)
    xw_f, xw_b, wh_f, wh_b, lengths = _lstm_inputs(0, 5, 3, 8)
    lens = torch.tensor(lengths)
    tbl.bilstm_layer(torch.tensor(xw_f).to(BF16), torch.tensor(xw_b).to(BF16),
                     torch.tensor(wh_f), torch.tensor(wh_b), lens, lens)
    tlstm.lstm_layer(torch.tensor(xw_f).to(BF16), torch.tensor(wh_f), lens)
    assert (tconv.launches_by_dtype, tbl.launches_by_dtype, tlstm.launches_by_dtype) == before


# ---- the whole model against the JAX package's fused path --------------------

def _config(front, cell_type="LSTM", layer_type="normal", hidden=20):
    return {"cnn": {"model": front},
            "rnn": {"layer_num": 2, "hidden_num": hidden, "cell_type": cell_type,
                    "layer_type": layer_type}}


@pytest.fixture
def jax_fused_path(monkeypatch):
    """The JAX package's TPU inference path on the CPU: Pallas on, each Pallas
    kernel that apply_model reaches run in interpret mode (they are imported
    inside the model functions at call time, so patching the modules works)."""
    monkeypatch.setattr(jrnn, "_use_pallas", lambda: True)
    for mod, name in ((jconvbn, "conv_bn_pallas"), (jlstm, "bilstm_layer_pallas"),
                      (jlstm, "lstm_layer_pallas"), (jgru, "bigru_layer_pallas"),
                      (jgru, "gru_layer_pallas"), (jbnlstm, "bibnlstm_layer_pallas"),
                      (jbnlstm, "bnlstm_layer_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


def _model_inputs(config, seg, seed, bsz=8):
    """Seeded windows, most of them full (BNLSTM's per-step batch moments over
    two or three active rows are ill-conditioned in any precision)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, seg).astype(np.float32)
    t_out = jmodel.output_len(config, seg)
    return x, np.array([t_out] * (bsz - 3) + [t_out - 3, 1, t_out // 2], np.int32)


def _jax_bf16_logits(params, config, x, seq_len):
    # the JAX pipeline uploads bf16 mode's windows as bfloat16
    return np.asarray(jmodel.apply_model(params, dict(config, bf16=True),
                                         jnp.asarray(x, dtype=jnp.bfloat16),
                                         jnp.asarray(seq_len)))


def _one_ulp_moved(x: np.ndarray, share: float = 0.01) -> np.ndarray:
    """x rounded to bfloat16 with the last mantissa bit of a seeded ``share``
    of the samples flipped (each moves one bfloat16 ulp)."""
    bits = torch.tensor(x).to(BF16).view(torch.int16).clone()
    moved = torch.rand(bits.shape, generator=torch.Generator().manual_seed(0)) < share
    bits[moved] ^= 1
    return bits.view(BF16).float().numpy()


MODEL_CASES = [
    # front, window, cell, layer type
    ("dna_model1", 48, "LSTM", "normal"),
    ("slow_model1", 64, "LSTM", "normal"),
    ("rna_model2", 100, "LSTM", "normal"),
    ("dna_model1", 48, "GRU", "normal"),
    ("dna_model1", 48, "BNLSTM", "normal"),
    ("rna_model2", 100, "GRU", "normal"),
    ("slow_model1", 64, "BNLSTM", "normal"),
    ("dna_model1", 48, "LSTM", "rna"),
    ("dna_model1", 48, "GRU", "rna"),
    ("dna_model1", 48, "BNLSTM", "rna"),
]


@pytest.mark.parametrize("front,seg,cell,layer_type", MODEL_CASES)
def test_apply_model_bf16_matches_jax_fused_path(jax_fused_path, front, seg, cell, layer_type):
    config = _config(front, cell, layer_type)
    params = jmodel.init_model(jax.random.PRNGKey(3), config)
    x, seq_len = _model_inputs(config, seg, 4)
    want = _jax_bf16_logits(params, config, x, seq_len)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), config, "cpu")
    got = model(torch.tensor(x), torch.tensor(seq_len), bf16=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    tol = LOGIT_TOL * scale
    if cell == "BNLSTM":  # the JAX side's own spread under one-ulp input moves
        moved = _jax_bf16_logits(params, config, _one_ulp_moved(x), seq_len)
        tol = max(tol, float(np.abs(moved - want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= tol


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "BNLSTM"])
@pytest.mark.parametrize("layer_type", ["normal", "rna"])
def test_rnn_layers_bf16_match_jax_fused_path_on_identical_features(jax_fused_path, cell,
                                                                      layer_type):
    """The recurrent stack and head on the same bf16 CNN features: within 1e-2
    of max |logit| (only the stack's own flips: an LSTM layer's bf16 h)."""
    from chiron_tpu.models import layers as JL

    config = _config("dna_model1", cell, layer_type)
    params = jmodel.init_model(jax.random.PRNGKey(6), config)
    rng = np.random.RandomState(8)
    t, bsz = 24, 8
    fea = torch.tensor(rng.randn(bsz, t, 256).astype(np.float32)).to(BF16)
    lengths = np.array([t] * 5 + [t - 3, 1, t // 2], np.int32)
    with JL.bf16_compute(True):
        want = np.asarray(jrnn.rnn_layers(params["rnn"], jnp.asarray(fea.float().numpy(),
                                                                     dtype=jnp.bfloat16),
                                          jnp.asarray(lengths), cell, layer_type))
    tparams = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), params["rnn"])
    got = trnn.rnn_layers(tparams, fea, torch.tensor(lengths), cell, layer_type, bf16=True)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "BNLSTM"])
def test_unirnn_layers_bf16_matches_jax_fused_path(jax_fused_path, cell):
    from chiron_tpu.models import layers as JL

    rng = np.random.RandomState(7)
    t, b, c, h = 12, 6, 16, 20
    params = jrnn.init_unirnn_layers(jax.random.PRNGKey(5), c, h, 2, 5, cell)
    x = _bf16_round(rng.randn(b, t, c).astype(np.float32))
    lengths = np.array([t, t - 2, 1, t, 5, t], np.int32)
    with JL.bf16_compute(True):
        want = np.asarray(jrnn.unirnn_layers(params, jnp.asarray(x, dtype=jnp.bfloat16),
                                             jnp.asarray(lengths), cell))
    tparams = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), params)
    got = trnn.unirnn_layers(tparams, torch.tensor(x).to(BF16), torch.tensor(lengths), cell,
                             bf16=True)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "BNLSTM"])
def test_bf16_mode_close_to_f32_and_engaged(cell):
    """The port's bf16 mode against its float32 mode: within JAX's own 0.15
    (tests/test_model.py:107), and not equal."""
    config = _config("dna_model1", cell, hidden=32)
    params = jmodel.init_model(jax.random.PRNGKey(0), config)
    x, seq_len = _model_inputs(config, 64, 0)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), config, "cpu")
    ref = model(torch.tensor(x), torch.tensor(seq_len)).numpy()
    out = model(torch.tensor(x), torch.tensor(seq_len), bf16=True).numpy()
    assert not np.array_equal(out, ref)
    np.testing.assert_allclose(out, ref, rtol=0.15, atol=0.15)


def test_training_ignores_bf16():
    config = _config("dna_model1", hidden=16)
    params = jmodel.init_model(jax.random.PRNGKey(0), config)
    x, seq_len = _model_inputs(config, 48, 1)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), config, "cpu")
    ref = model(torch.tensor(x), torch.tensor(seq_len), training=True)
    out = model(torch.tensor(x), torch.tensor(seq_len), training=True, bf16=True)
    assert torch.equal(ref, out)
    assert not TL.bf16_compute(True, training=True)
    assert TL.bf16_compute(True) and not TL.bf16_compute(False)


def test_matmul_inputs_round_to_nearest_even():
    # 1 + 2^-8 is a tie between 1 and 1 + 2^-7: to nearest even gives 1;
    # 1 + 3 * 2^-8 ties between 1 + 2^-7 and 1 + 2^-6: even gives 1 + 2^-6
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)])
    (r,) = TL.matmul_inputs(x, bf16=True)
    assert r.dtype == torch.float32
    assert r.tolist() == [1.0, 1 + 2 ** -6, -1.0]
    assert TL.matmul_inputs(x)[0] is x
    assert TL.store_activation(x, True).dtype == BF16 and TL.store_activation(x) is x


# ---- the entry point ------------------------------------------------------------

def test_cli_call_bf16_on_signal_files(tmp_path):
    sig_dir = tmp_path / "sig"
    sig_dir.mkdir()
    rng = np.random.RandomState(3)
    for i in range(2):
        np.savetxt(sig_dir / f"read{i}.signal", rng.randint(300, 700, 1200), fmt="%d")
    results = {}
    for mode in ("f32", "bf16"):
        out = tmp_path / mode
        args = ["call", "-i", str(sig_dir), "-o", str(out), "-p", "dna-pre", "-b", "8",
                "--beam", "4", "--device", "cpu"] + (["--bf16"] if mode == "bf16" else [])
        results[mode] = tcli.main(args)
        for i in range(2):
            fq = (out / "result" / f"read{i}.fastq").read_text().splitlines()
            assert fq[0] == f"@read{i}" and len(fq[1]) == len(fq[3]) > 0
            assert not set(fq[1]) - set("ACGT")
    assert results["bf16"]["n_files"] == 2 and results["bf16"]["total_windows"] == 8
    assert results["bf16"]["total_windows"] == results["f32"]["total_windows"]
