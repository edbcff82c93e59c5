"""The port's recurrent-BN LSTM layers (chiron_tpu_torch/ops/bnlstm.py)
against the JAX package: the Pallas kernels in interpret mode and the XLA
scan (rnn._bnlstm_scan), and the training branch's gradients against
jax.grad.

Inputs are made with numpy from a seed. Tolerance 3e-5 for outputs (the
JAX tests' own: the per-step batch moments are reassociated sums);
gradients within 2e-4 of each leaf's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.models import rnn as jrnn
from chiron_tpu.ops.pallas import bnlstm as jbn
from chiron_tpu_torch.models import rnn as trnn
from chiron_tpu_torch.ops import bnlstm as tbn

TOL = 3e-5
KEYS = ("wh", "b", "scale_x", "scale_h", "scale_c", "offset_c")


def _cell(rng, c_in, h):
    """A BNLSTM cell with every learned piece randomised (BN scales kept
    positive), numpy leaves in the JAX package's layout."""
    f32 = np.float32
    return {
        "wx": (rng.randn(c_in, 4 * h) * 0.3).astype(f32),
        "wh": (rng.randn(h, 4 * h) * 0.3).astype(f32),
        "b": (rng.randn(4 * h) * 0.1).astype(f32),
        "scale_x": (0.1 + rng.rand(4 * h) * 0.2).astype(f32),
        "scale_h": (0.1 + rng.rand(4 * h) * 0.2).astype(f32),
        "scale_c": (0.1 + rng.rand(h) * 0.2).astype(f32),
        "offset_c": (rng.randn(h) * 0.1).astype(f32),
    }


def _to(a):
    return torch.tensor(np.asarray(a))


def _weights(cell):
    return tuple(_to(cell[k]) for k in KEYS)


def _jcell(cell):
    return {k: jnp.asarray(v) for k, v in cell.items()}


def _pallas_single(x, cell, lengths, h):
    wx_p, *rest = jbn.pad_bnlstm_weights(_jcell(cell), h)
    return jbn.bnlstm_layer_pallas(jnp.asarray(x) @ wx_p, *rest, jnp.asarray(lengths), hidden=h,
                                   interpret=True)


@pytest.mark.parametrize("h", [100, 128])
def test_bnlstm_layer_matches_pallas_interpret(h):
    rng = np.random.RandomState(1)
    t, b, c_in = 10, 16, 8
    cell = _cell(rng, c_in, h)
    x = rng.randn(t, b, c_in).astype(np.float32)
    lengths = np.array([t] * 8 + [4] * 4 + [0] * 4, np.int32)
    want = _pallas_single(x, cell, lengths, h)
    got = tbn.bnlstm_layer(_to(x @ cell["wx"]), *_weights(cell), _to(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert (got.numpy()[np.arange(t)[:, None] >= lengths[None, :]] == 0).all()


@pytest.mark.parametrize("h", [100, 128])
def test_bnlstm_layer_matches_xla_scan(h):
    rng = np.random.RandomState(2)
    t, b, c_in = 10, 16, 8
    cell = _cell(rng, c_in, h)
    x = rng.randn(t, b, c_in).astype(np.float32)
    lengths = np.array([t] * 8 + [4] * 4 + [0] * 4, np.int32)
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)[..., None]
    want = jrnn._bnlstm_scan(_jcell(cell), jnp.asarray(x @ cell["wx"]), jnp.asarray(mask))
    got = tbn.bnlstm_layer(_to(x @ cell["wx"]), *_weights(cell), _to(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h", [100, 128])
def test_bibnlstm_layer_matches_pallas_interpret(h):
    rng = np.random.RandomState(11)
    t, b, c_in = 12, 12, 6
    # six full rows: with only two rows active a column's variance can fall
    # far below eps, and rsqrt(var + 1e-5) then amplifies float32 rounding
    lengths = np.array([t] * 6 + [9, 7, 5, 3, 1, 0], np.int32)
    x = rng.randn(t, b, c_in).astype(np.float32)
    xb = np.asarray(jrnn.reverse_sequence(jnp.asarray(x), jnp.asarray(lengths)))
    fw, bw = _cell(rng, c_in, h), _cell(rng, c_in, h)
    wx_f, *rest_f = jbn.pad_bnlstm_weights(_jcell(fw), h)
    wx_b, *rest_b = jbn.pad_bnlstm_weights(_jcell(bw), h)
    want_f, want_b = jbn.bibnlstm_layer_pallas(
        jnp.asarray(x) @ wx_f, jnp.asarray(xb) @ wx_b, tuple(rest_f), tuple(rest_b),
        jnp.asarray(lengths), hidden=h, interpret=True)
    got_f, got_b = tbn.bibnlstm_layer(_to(x @ fw["wx"]), _to(xb @ bw["wx"]), _weights(fw),
                                      _weights(bw), _to(lengths))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=TOL, atol=TOL)
    # the fused layer is two single directions
    one_b = tbn.bnlstm_layer(_to(xb @ bw["wx"]), *_weights(bw), _to(lengths))
    assert torch.equal(got_b, one_b)


def test_bnlstm_zero_length_batch_is_exact_zero():
    rng = np.random.RandomState(3)
    t, b, h = 6, 8, 100
    cell = _cell(rng, 4, h)
    x = rng.randn(t, b, 4).astype(np.float32)
    out = tbn.bnlstm_layer(_to(x @ cell["wx"]), *_weights(cell), torch.zeros(b, dtype=torch.int32))
    assert out.shape == (t, b, h) and not out.any()


@pytest.mark.parametrize("layer_type", ["normal", "rna"])
def test_bnlstm_training_gradients_match_jax(layer_type):
    rng = np.random.RandomState(4)
    b, t, c_in, h = 6, 9, 5, 12
    params = jrnn.init_rnn_layers(jax.random.PRNGKey(3), c_in, h, 2, 5, "BNLSTM", layer_type)
    x = rng.randn(b, t, c_in).astype(np.float32)
    lengths = np.array([t, 2, 6, 3, t, 2], np.int32)
    w = rng.randn(b, t, 5).astype(np.float32)

    def jloss(p):
        out = jrnn.rnn_layers(p, jnp.asarray(x), jnp.asarray(lengths), "BNLSTM", layer_type,
                              training=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss)(params)
    tparams = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(True), params)
    out = trnn.rnn_layers(tparams, torch.tensor(x), torch.tensor(lengths), "BNLSTM", layer_type,
                          training=True)
    (out * torch.tensor(w)).sum().backward()
    leaves = jax.tree_util.tree_leaves_with_path(want)
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda p: p.grad.numpy(), tparams)))
    assert len(leaves) == len(got)
    for path, g in leaves:
        g = np.asarray(g)
        np.testing.assert_allclose(got[path], g, rtol=0, atol=2e-4 * max(np.abs(g).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))


def test_wrappers_reject_bad_inputs():
    rng = np.random.RandomState(5)
    t, b, h = 5, 3, 16
    cell = _cell(rng, 4, h)
    xw = _to(rng.randn(t, b, 4 * h).astype(np.float32))
    lens = torch.full((b,), t, dtype=torch.int32)
    w = _weights(cell)
    with pytest.raises(ValueError):
        tbn.bnlstm_layer(xw, *w, lens.to(torch.int64))
    with pytest.raises(ValueError):  # scale_c of the wrong length
        tbn.bnlstm_layer(xw, *w[:4], w[4][:8], w[5], lens)
    with pytest.raises(ValueError):
        tbn.bibnlstm_layer(xw, xw, w, w[:5], lens)
