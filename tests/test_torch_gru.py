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


# ---- the kernel's geometry (ops/gru.py:geometry), pure Python ---------------

def _check_fits(g, bsz, h, dirs):
    """What csrc/gru.cu's launcher requires of a geometry, and that every
    hidden unit and batch row of the layer has a thread."""
    utl = -(-h // 16)
    warps = g.threads // 32
    resident = g.instance == "resident"
    tiles = 1 if resident else 2  # tiles of 16 units a warp
    assert tgru.unit_tiles(resident) == tiles and g.threads == tgru.block_threads(h, resident)
    assert g.threads % 32 == 0 and g.threads <= tgru.max_threads(resident) <= 512
    assert warps * tiles >= utl > (warps - 1) * tiles  # no warp without a tile
    # a thread holds 2 rows x 2 units of each of its tiles: the block's rows x
    # units fit its threads
    assert tgru.ROWS * 16 * utl <= 4 * tiles * g.threads
    assert g.blocks == dirs * -(-bsz // tgru.ROWS)
    assert g.smem_bytes <= tgru.MAX_SHARED_BYTES
    assert g.smem_bytes == tgru.smem_bytes(h, resident)
    # resident wherever the weights fit a block
    assert resident == (tgru.smem_bytes(h, True) <= tgru.MAX_SHARED_BYTES)


def test_geometry_of_the_main_path():
    # dna-pre's GRU layer, both directions at B = 400, H = 128: the weights
    # resident, a block of 8 warps (one tile of 16 units each) per 8 rows,
    # one block an SM (its shared memory holds no second one), 100 blocks in
    # one wave of the H100's 132 SMs
    g = tgru.geometry(400, 128, 2)
    assert g == tgru.Geometry("resident", 100, 256, g.smem_bytes)
    assert 2 * g.smem_bytes > tgru.MAX_SHARED_BYTES and g.blocks <= 132
    _check_fits(g, 400, 128, 2)
    # unirnn_layers' single direction, also resident in one wave
    one = tgru.geometry(400, 128, 1)
    assert one.instance == "resident" and one.blocks == 50


@pytest.mark.parametrize("h0", range(1, 513, 32))
def test_geometry_gives_every_width_an_instance(h0):
    for h in range(h0, h0 + 32):
        for bsz in (1, 64, 301, 400):
            for dirs in (1, 2):
                _check_fits(tgru.geometry(bsz, h, dirs), bsz, h, dirs)


@pytest.mark.parametrize("bsz,h,instance", [(1, 128, "resident"), (301, 128, "resident"),
                                            (1, 16, "resident"), (301, 100, "resident"),
                                            (1, 384, "streamed"), (301, 512, "streamed"),
                                            (5000, 128, "resident"), (400, 256, "streamed")])
@pytest.mark.parametrize("dirs", [1, 2])
def test_geometry_routes(bsz, h, instance, dirs):
    g = tgru.geometry(bsz, h, dirs)
    assert g.instance == instance
    _check_fits(g, bsz, h, dirs)


@pytest.mark.parametrize("bsz,h,dirs", [(400, 0, 2), (400, 513, 2), (0, 128, 2), (400, 128, 3)])
def test_geometry_raises_past_the_limits(bsz, h, dirs):
    with pytest.raises(ValueError):
        tgru.geometry(bsz, h, dirs)


@pytest.mark.parametrize("h,instance,fits", [(1, "resident", True), (16, "streamed", True),
                                             (128, "resident", True), (128, "streamed", True),
                                             (129, "streamed", True), (512, "streamed", True),
                                             (129, "resident", False), (512, "resident", False),
                                             (128, "cluster", False)])
def test_geometry_forces_an_instance(h, instance, fits):
    # the probe and the on-card tests force an instance; the resident one
    # only where the weights fit a block
    assert (instance in tgru.instances(h)) == fits
    if not fits:
        with pytest.raises(ValueError):
            tgru.geometry(64, h, 2, instance)
        return
    g = tgru.geometry(64, h, 2, instance)
    assert g.instance == instance
    if instance == tgru.geometry(64, h, 2).instance:
        _check_fits(g, 64, h, 2)
    assert g.threads == tgru.block_threads(h, instance == "resident")
    assert g.smem_bytes == tgru.smem_bytes(h, instance == "resident") <= tgru.MAX_SHARED_BYTES
    assert g.blocks == 2 * 8


def _fragments_as_weights(packed, h):
    """The kernel's A fragments read back as [gate, k, unit] weights."""
    utl, ks = -(-h // 16), tgru.k_steps(h)
    frag = packed.reshape(3, utl, ks, 32, 4)
    a = torch.zeros(3, utl, ks, 16, 8)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for i, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        a[:, :, :, g + dm, t + dk] = frag[..., i]
    units = torch.zeros_like(a)
    units[:, :, :, tgru.FRAGMENT_UNITS] = a  # fragment row m holds unit 2 (m % 8) + m // 8
    return units.permute(0, 2, 4, 1, 3).reshape(3, 8 * ks, 16 * utl)


def test_fragment_rows_pair_a_threads_units():
    # a thread holds fragment rows g and g + 8: units 2g and 2g + 1 of the tile
    assert sorted(tgru.FRAGMENT_UNITS) == list(range(16))
    for g in range(8):
        assert (tgru.FRAGMENT_UNITS[g], tgru.FRAGMENT_UNITS[g + 8]) == (2 * g, 2 * g + 1)


@pytest.mark.parametrize("h", [1, 7, 100, 128, 136])
def test_packed_weights_are_the_mma_fragments(h):
    # every weight lands in the lane and register the m16n8k8 A fragment
    # reads it from, the padding is zero
    rng = np.random.RandomState(6 + h)
    whg = torch.tensor(rng.randn(h, 2 * h).astype(np.float32))
    whc = torch.tensor(rng.randn(h, h).astype(np.float32))
    packed = tgru.pack_weights(whg, whc)
    utl, ks = -(-h // 16), tgru.k_steps(h)
    assert ks % 4 == 0 and 8 * ks >= h > 8 * (ks - 4)
    assert packed.shape == (3 * utl * ks * 128,)
    w = _fragments_as_weights(packed, h)
    assert torch.equal(w[0, :h, :h], whg[:, :h]) and torch.equal(w[1, :h, :h], whg[:, h:])
    assert torch.equal(w[2, :h, :h], whc)
    assert not w[:, h:].any() and not w[:, :, h:].any()


def _tf32_split(x):
    """csrc/gru.cu:split_tf32 on the CPU: the head x with its low 13 bits
    cleared, the tail as the tensor cores read it (its low 13 bits
    dropped)."""
    bits = x.contiguous().view(torch.int32)
    head = (bits & ~0x1FFF).view(torch.float32)
    tail = ((x - head).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return head, tail


@pytest.mark.parametrize("h", [100, 128, 512])
def test_3xtf32_products_are_float32_grade(h):
    # the kernel's product: per k step of 8, head*head (here summed in float64,
    # as one MMA keeps more than float32 does) added in order in float32 onto
    # gx; tail*head + head*tail over all k steps, added at the end; against
    # float64
    rng = np.random.RandomState(9 + h)
    hv = torch.tensor(rng.randn(8, h).astype(np.float32))
    w = torch.tensor((rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32))
    gx = torch.tensor(rng.randn(8, 3 * h).astype(np.float32))
    (hh, ht), (wh, wt) = _tf32_split(hv), _tf32_split(w)
    acc = gx.clone()
    small = torch.zeros(8, 3 * h, dtype=torch.float64)
    for k0 in range(0, h, 8):
        ks = slice(k0, k0 + 8)
        acc = acc + (hh[:, ks].double() @ wh[ks].double()).float()
        small += ht[:, ks].double() @ wh[ks].double() + hh[:, ks].double() @ wt[ks].double()
    acc = acc + small.float()
    want = gx.double() + hv.double() @ w.double()
    plain = gx + hv @ w
    err, plain_err = float((acc - want).abs().max()), float((plain - want).abs().max())
    # float32-grade: within a few float32 roundings of the sums' scale, and of
    # the same order as the plain float32 product's own error
    assert err < 4 * max(plain_err, 1e-6), (err, plain_err)
    assert err < 1e-6 * float(want.abs().max())
