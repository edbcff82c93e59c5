"""The port's GRU layers (chiron_tpu_torch/ops/gru.py) against the JAX
package: the Pallas kernels in interpret mode and the XLA scan
(rnn._gru_scan), and the training branch's gradients against jax.grad.

Inputs are made with numpy from a seed. Tolerance 2e-5 for outputs (the
JAX tests' own: the recurrent products sum in another order than XLA's);
gradients within 2e-4 of each leaf's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.models import rnn as jrnn
from chiron_tpu.ops.pallas import gru as jgru
from chiron_tpu_torch.models import rnn as trnn
from chiron_tpu_torch.ops import gru as tgru

TOL = 2e-5


def _cell(rng, c_in, h):
    """A GRU cell with random weights (numpy), in the JAX package's layout."""
    shapes = jrnn.init_gru_cell(jax.random.PRNGKey(0), c_in, h)
    return {k: (rng.randn(*v.shape) * 0.3).astype(np.float32) for k, v in shapes.items()}


def _lengths(t, b):
    lengths = np.array([t] * (b // 2) + [5] * (b // 4) + [0] * (b - b // 2 - b // 4), np.int32)
    return lengths


def _proj(x, cell):
    return x @ cell["wx_g"] + cell["b_g"], x @ cell["wx_c"] + cell["b_c"]


def _to(a):
    return torch.tensor(np.asarray(a))


def _pallas_single(x, cell, lengths, h, starts=None):
    jc = {k: jnp.asarray(v) for k, v in cell.items()}
    wxg, whg, bg, wxc, whc, bc = jgru.pad_gru_weights(jc, h)
    xj = jnp.asarray(x)
    return jgru.gru_layer_pallas(xj @ wxg + bg, xj @ wxc + bc, whg, whc, jnp.asarray(lengths),
                                 hidden=h, interpret=True,
                                 starts=None if starts is None else jnp.asarray(starts))


@pytest.mark.parametrize("h", [100, 128])
@pytest.mark.parametrize("with_starts", [False, True])
def test_gru_layer_matches_pallas_interpret(h, with_starts):
    rng = np.random.RandomState(0)
    t, b, c_in = 12, 16, 8
    cell = _cell(rng, c_in, h)
    x = rng.randn(t, b, c_in).astype(np.float32)
    lengths = _lengths(t, b)
    starts = (t - lengths).astype(np.int32) if with_starts else None
    want = _pallas_single(x, cell, lengths, h, starts)
    gx, cx = _proj(x, cell)
    got = tgru.gru_layer(_to(gx), _to(cx), _to(cell["wh_g"]), _to(cell["wh_c"]), _to(lengths),
                         None if starts is None else _to(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h", [100, 128])
def test_gru_layer_matches_xla_scan(h):
    rng = np.random.RandomState(1)
    t, b, c_in = 12, 16, 8
    cell = _cell(rng, c_in, h)
    x = rng.randn(t, b, c_in).astype(np.float32)
    lengths = _lengths(t, b)
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)[..., None]
    want = jrnn._gru_scan({k: jnp.asarray(v) for k, v in cell.items()}, jnp.asarray(x),
                          jnp.asarray(mask))
    gx, cx = _proj(x, cell)
    got = tgru.gru_layer(_to(gx), _to(cx), _to(cell["wh_g"]), _to(cell["wh_c"]), _to(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h", [100, 128])
def test_bigru_layer_matches_pallas_interpret(h):
    rng = np.random.RandomState(2)
    t, b, c_in = 12, 8, 8
    lengths = np.array([t, t, 9, 5, 3, 1, 0, 7], np.int32)
    starts = (t - lengths).astype(np.int32)
    x = rng.randn(t, b, c_in).astype(np.float32)
    xb = np.ascontiguousarray(x[::-1])
    fw, bw = _cell(rng, c_in, h), _cell(rng, c_in, h)
    pads = [jgru.pad_gru_weights({k: jnp.asarray(v) for k, v in c.items()}, h) for c in (fw, bw)]
    (wxg_f, whg_f, bg_f, wxc_f, whc_f, bc_f), (wxg_b, whg_b, bg_b, wxc_b, whc_b, bc_b) = pads
    xj, xbj = jnp.asarray(x), jnp.asarray(xb)
    want_f, want_b = jgru.bigru_layer_pallas(
        xj @ wxg_f + bg_f, xj @ wxc_f + bc_f, xbj @ wxg_b + bg_b, xbj @ wxc_b + bc_b,
        (whg_f, whc_f), (whg_b, whc_b), jnp.asarray(lengths), jnp.asarray(starts), hidden=h,
        interpret=True)
    got_f, got_b = tgru.bigru_layer(
        *map(_to, _proj(x, fw)), *map(_to, _proj(xb, bw)), (_to(fw["wh_g"]), _to(fw["wh_c"])),
        (_to(bw["wh_g"]), _to(bw["wh_c"])), _to(lengths), _to(starts))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=TOL, atol=TOL)
    # zero outside each row's window, in both directions
    tt = np.arange(t)[:, None]
    assert (got_f.numpy()[tt >= lengths[None, :]] == 0).all()
    assert (got_b.numpy()[tt < starts[None, :]] == 0).all()


def test_gru_zero_length_batch_is_exact_zero():
    rng = np.random.RandomState(3)
    t, b, h = 6, 8, 100
    cell = _cell(rng, 4, h)
    gx, cx = _proj(rng.randn(t, b, 4).astype(np.float32), cell)
    out = tgru.gru_layer(_to(gx), _to(cx), _to(cell["wh_g"]), _to(cell["wh_c"]),
                         torch.zeros(b, dtype=torch.int32))
    assert out.shape == (t, b, h) and not out.any()


@pytest.mark.parametrize("layer_type", ["normal", "rna"])
def test_gru_training_gradients_match_jax(layer_type):
    rng = np.random.RandomState(4)
    b, t, c_in, h = 6, 9, 5, 12
    params = jrnn.init_rnn_layers(jax.random.PRNGKey(2), c_in, h, 2, 5, "GRU", layer_type)
    x = rng.randn(b, t, c_in).astype(np.float32)
    lengths = np.array([t, 0, 6, 3, t, 1], np.int32)
    w = rng.randn(b, t, 5).astype(np.float32)

    def jloss(p):
        out = jrnn.rnn_layers(p, jnp.asarray(x), jnp.asarray(lengths), "GRU", layer_type,
                              training=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss)(params)
    tparams = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(True), params)
    out = trnn.rnn_layers(tparams, torch.tensor(x), torch.tensor(lengths), "GRU", layer_type,
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
    gx, cx = map(_to, _proj(rng.randn(t, b, 4).astype(np.float32), cell))
    whg, whc = _to(cell["wh_g"]), _to(cell["wh_c"])
    lens = torch.full((b,), t, dtype=torch.int32)
    with pytest.raises(ValueError):
        tgru.gru_layer(gx, cx, whg, whc, lens.to(torch.int64))
    with pytest.raises(ValueError):
        tgru.gru_layer(gx, cx[:, :, :8], whg, whc, lens)
    with pytest.raises(ValueError):
        tgru.bigru_layer(gx, cx, gx, cx, (whg, whc), (whg, whc.double()), lens, lens)
