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


# ---- the card's geometry (ops/bnlstm.py:geometry), pure Python ----------------

# (B, H) -> (clusters a direction, cluster, row groups, unit slices) of the
# cluster instance wherever clusters' shared memory holds wh and the rows,
# else _C: the cooperative kernel. 1000 rows are past every cluster at H >=
# 128, 2000 rows at H = 100.
_C = "cooperative"
_GEOMETRY_CASES = {
    (1, 100): (1, 8, 1, 8), (1, 128): (1, 8, 1, 8), (1, 256): (1, 16, 1, 16),
    (1, 384): (1, 16, 1, 16), (1, 512): _C,
    (11, 100): (1, 8, 1, 8), (11, 128): (1, 8, 1, 8), (11, 256): (1, 16, 1, 16),
    (11, 384): (1, 16, 1, 16), (11, 512): _C,
    (64, 100): (1, 16, 4, 4), (64, 128): (1, 16, 4, 4), (64, 256): (2, 16, 2, 8), (64, 384): _C,
    (64, 512): _C,
    (300, 100): (2, 16, 4, 4), (300, 128): (2, 16, 4, 4), (300, 256): _C, (300, 384): _C,
    (300, 512): _C,
    (301, 100): (2, 16, 4, 4), (301, 128): (2, 16, 4, 4), (301, 256): _C, (301, 384): _C,
    (301, 512): _C,
    (400, 100): (2, 16, 4, 4), (400, 128): (2, 16, 4, 4), (400, 256): _C, (400, 384): _C,
    (400, 512): _C,
    (1000, 100): (2, 16, 8, 2), (1000, 128): _C, (1000, 256): _C, (1000, 384): _C,
    (1000, 512): _C,
    (2000, 100): _C, (2000, 128): _C, (2000, 256): _C,
}


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("bsz,h", sorted(_GEOMETRY_CASES))
def test_geometry_routes_and_fits(bsz, h, dirs):
    g = tbn.geometry(bsz, h, dirs)
    want = _GEOMETRY_CASES[(bsz, h)]
    if want == _C:
        assert g.instance == "cooperative" and g.cluster == g.unit_slices == g.units == 1
    else:
        assert g.instance == "cluster" and (g.split, g.cluster, g.row_groups, g.unit_slices) == want
    assert g.smem_bytes <= tbn.MAX_SHARED_BYTES and 1 <= g.cluster <= tbn.MAX_CLUSTER
    assert g.threads % 32 == 0 and g.threads <= 1024
    if g.instance == "cluster":
        assert g.row_groups * g.unit_slices == g.cluster
        assert (g.rows, g.units) in ((4, 1), (8, 1), (8, 2))
        assert g.threads <= tbn.cluster_max_threads(g.rows, g.units)
        assert g.smem_bytes == tbn.cluster_smem_bytes(bsz, h, g.row_groups, g.unit_slices,
                                                      g.rows, g.units, g.split)
        # a direction over several clusters combines row groups in each
        assert g.split in (1, 2) and (g.split == 1 or g.row_groups >= 2)
        # every row and hidden unit has a block, and no block is empty
        groups = g.row_groups * g.split
        rb, hs = -(-bsz // groups), -(-h // g.unit_slices)
        assert rb * groups >= bsz > rb * (groups - 1)
        assert hs * g.unit_slices >= h > hs * (g.unit_slices - 1)
        # each direction is its own cluster: the fused layer is two single ones
        assert tbn.geometry(bsz, h, 3 - dirs) == g
    else:
        # the smallest row tile whose grid is resident at one block an SM
        fits = [r for r in (8, 16, 32, 64)
                if -(-bsz // r) * dirs <= 132 and tbn.coop_smem_bytes(h, r) <= 232448]
        assert g.rows == fits[0] and g.row_groups == -(-bsz // g.rows)
        assert g.smem_bytes == tbn.coop_smem_bytes(h, g.rows)


def test_geometry_of_the_main_path():
    # dna-pre's BNLSTM layer: 2 clusters of 16 per direction, each 4 row groups
    # of 50 rows x 4 slices of 32 units, a thread 8 rows x 1 unit
    g = tbn.geometry(400, 128, 2)
    assert g == tbn.Geometry("cluster", 16, 4, 4, 8, 1, 224, g.smem_bytes, 2)
    assert g.smem_bytes <= tbn.MAX_SHARED_BYTES
    # the cheapest candidate by the model fitted to the probe's clocks
    assert tbn.cluster_candidates(400, 128)[0][1:] == (16, 4, 4, 8, 1, 224, g.smem_bytes, 2)
    # a card without clusters of 16 takes 8 (the largest portable size), one
    # that holds too few clusters at once keeps a direction in one cluster
    g8 = tbn.geometry(400, 128, 2, max_cluster=8)
    assert g8.instance == "cooperative" or g8.cluster <= 8
    assert tbn.geometry(400, 128, 2, max_split=1).split == 1


@pytest.mark.parametrize("h", [1, 7, 16, 63, 100, 128, 200, 256, 333, 384, 470, 511, 512])
def test_geometry_gives_every_width_an_instance(h):
    for bsz in (1, 2, 11, 64, 128, 300, 400, 1000):
        for dirs in (1, 2):
            g = tbn.geometry(bsz, h, dirs)
            assert g.smem_bytes <= tbn.MAX_SHARED_BYTES and g.cluster <= tbn.MAX_CLUSTER


def test_geometry_raises_past_both_instances():
    with pytest.raises(ValueError):  # 5000 rows at H = 512: no cluster, no co-resident grid
        tbn.geometry(5000, 512, 2)


def test_cluster_candidates_are_sorted_and_fit():
    cands = tbn.cluster_candidates(400, 128)
    assert cands and cands == sorted(cands)
    for cost, cluster, rg, us, rows, units, threads, smem, split in cands:
        assert cost == tbn.cluster_step_cost(400, 128, rg, us, rows, units, split)
        assert smem <= tbn.MAX_SHARED_BYTES and threads <= tbn.cluster_max_threads(rows, units)
        assert rg * us == cluster and split in (1, 2)
