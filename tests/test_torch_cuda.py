"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
Tolerances: float32 sums in another order than the plain version's
(1e-4 for conv outputs and moments, whose product is three TF32 tensor-core
products with float32 sums, bit-identical from run to run; 1e-5 for the BiLSTM and the training
LSTM forward (plus 1e-4 relative: its carried c grows without bound and
carries the sum-order residue of every step), 1e-4 for its dxw and 1e-4 of max |dwh| for dwh, a sum over
T*B rows); the beam search is exact (trace, decodes) with log masses within
1e-4. The training LSTM's dwh must be bit-identical from run to run. The
single LSTM direction and the GRU kernels 1e-5 (the GRU at every width
and batch edge, each of its two instances forced, every geometry
bit-identical to the others, fused == single); the BNLSTM kernels 1e-4 (each
step's rsqrt(var + 1e-5) amplifies the sum-order residue), each of its two
instances (the cluster kernel and the cooperative one) at shapes that take
it, bit-identical from run to run. The LSTM kernels (inference, fused and single, and the
training forward and backward) are also held at dna-pre's batch edges
(B = 1, 300, 301, 400) and must be bit-identical from run to run. Every
recurrent kernel is also held at H = 384 and 512, where no cluster holds the
recurrent weights (the LSTM kernels' device-memory variant; the GRU's
streamed instance; the BNLSTM walking two gate columns a thread), and the
beam search at widths past one warp (65, 100, 256) and at 10 classes (the
block kernel), each bit-identical from run to run.
"""

import numpy as np
import pytest
import torch

from chiron_tpu_torch.ops import beam as tbeam
from chiron_tpu_torch.ops import bilstm as tbl
from chiron_tpu_torch.ops import bnlstm as tbn
from chiron_tpu_torch.ops import conv_bn as tconv
from chiron_tpu_torch.ops import gru as tgru
from chiron_tpu_torch.ops import lstm as tlstm
from chiron_tpu_torch.ops import lstm_grad as tlg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


CONV_CASES = [
    # k, stride, t, c_in, c_out, n_terms, relu_in, bsz
    (1, 1, 24, 1, 16, 1, False, 4),
    (1, 1, 70, 16, 8, 2, True, 4),
    (3, 1, 130, 20, 72, 1, True, 3),   # ragged row and channel tiles
    (3, 1, 32, 32, 16, 2, True, 4),
    (9, 5, 50, 1, 16, 1, False, 4),
    (8, 4, 64, 1, 16, 1, False, 3),
    (9, 5, 51, 8, 8, 2, True, 2),
    (1, 1, 400, 256, 256, 2, True, 4),  # dna_model1's k=1 convs: tensor cores, no ragged tile
    (3, 1, 400, 256, 256, 1, True, 4),  # its k=3 convs
    (3, 1, 40, 3, 10, 1, True, 3),      # narrow input, C_out no multiple of 4
    (3, 2, 77, 16, 24, 2, True, 3),     # strided slab on the tensor cores
    (5, 3, 90, 12, 132, 1, False, 2),   # two channel tiles, the second ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,relu_in,bsz", CONV_CASES)
def test_conv_bn_kernel_matches_plain(cuda, k, stride, t, c_in, c_out, n_terms,
                                      relu_in, bsz):
    rng = np.random.RandomState(k + stride + c_in)
    terms = [tuple(torch.tensor(v, device=cuda) for v in (
        rng.randn(bsz, t, c_in).astype(np.float32), (0.5 + rng.rand(c_in)).astype(np.float32),
        (rng.randn(c_in) * 0.2).astype(np.float32))) for _ in range(n_terms)]
    w = torch.tensor((rng.randn(k, c_in, c_out) * 0.3).astype(np.float32), device=cuda)
    before = tconv.launches
    got = tconv.conv_bn(terms, w, relu_in, stride)
    assert tconv.launches == before + 1
    want = tconv.conv_bn_plain(terms, w, relu_in, stride)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    again = tconv.conv_bn(terms, w, relu_in, stride)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"


# (h, t, b): widths with a ragged slice (100) and a cluster of 8 (256), a single
# row, and both directions of a dna-pre batch (B = 400: 13 rows a tile, one wave)
@pytest.mark.cuda
@pytest.mark.parametrize("h,t,b", [(16, 30, 11), (100, 30, 11), (128, 30, 11), (256, 30, 11),
                                   (128, 30, 1), (128, 40, 400), (100, 40, 301), (384, 30, 64),
                                   (512, 30, 301), (512, 30, 1)])
def test_bilstm_kernel_matches_plain(cuda, h, t, b):
    rng = np.random.RandomState(h + b)
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw_f, xw_b = (to(rng.randn(t, b, 4 * h).astype(np.float32)) for _ in range(2))
    # at H = 256 and B >= 300 weights of row norm ~1 (see the LSTM tests below)
    scale = 0.3 if h <= 128 and b < 300 else 1.0 / np.sqrt(h)
    wh_f, wh_b = (to((rng.randn(h, 4 * h) * scale).astype(np.float32)) for _ in range(2))
    lengths = rng.randint(1, t, size=b).astype(np.int32)
    lengths[0], lengths[-1] = 0, t
    args = (xw_f, xw_b, wh_f, wh_b, to(lengths), to((t - lengths).astype(np.int32)))
    before = tbl.launches
    got = tbl.bilstm_layer(*args)
    assert tbl.launches == before + 1
    want = tbl.bilstm_layer_plain(*args)
    again = tbl.bilstm_layer(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=1e-5, rtol=0)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"


def _lengths(rng, t, b, full=1):
    """Seeded lengths with an empty row, ``full`` full rows and partial rows."""
    lengths = rng.randint(1, t, size=b).astype(np.int32)
    lengths[0] = 0
    lengths[-full:] = t
    return lengths


@pytest.mark.cuda
@pytest.mark.parametrize("h,b", [(16, 11), (100, 11), (128, 11), (256, 11), (128, 1),
                                 (128, 301), (128, 400), (100, 400), (256, 301), (384, 64),
                                 (512, 301), (512, 1)])
def test_lstm_layer_kernel_matches_plain(cuda, h, b):
    rng = np.random.RandomState(200 + h + b)
    t = 30
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw_f, xw_b = (to(rng.randn(t, b, 4 * h).astype(np.float32)) for _ in range(2))
    # recurrent weights of row norm ~1: larger ones make the recurrence
    # chaotic at H >= 128, and it then amplifies the sum-order residue
    wh_f, wh_b = (to((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)) for _ in range(2))
    lengths = _lengths(rng, t, b)
    lens, starts = to(lengths), to((t - lengths).astype(np.int32))
    before = tlstm.launches
    got_f = tlstm.lstm_layer(xw_f, wh_f, lens)
    got_b = tlstm.lstm_layer(xw_b, wh_b, lens, starts)
    assert tlstm.launches == before + 2
    torch.cuda.synchronize()
    for got, want in ((got_f, tlstm.lstm_layer_plain(xw_f, wh_f, lens)),
                      (got_b, tlstm.lstm_layer_plain(xw_b, wh_b, lens, starts))):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    assert torch.equal(tlstm.lstm_layer(xw_b, wh_b, lens, starts), got_b), "differs between runs"
    # the fused layer is these two directions, bit for bit (at another geometry:
    # each column's k sum is one thread's, in order, whatever the tile)
    fused_f, fused_b = tbl.bilstm_layer(xw_f, xw_b, wh_f, wh_b, lens, starts)
    assert torch.equal(fused_f, got_f) and torch.equal(fused_b, got_b)
    zero = tlstm.lstm_layer(xw_f, wh_f, torch.zeros_like(lens))
    assert not zero.any()


def _gru_inputs(rng, t, b, h, to):
    gx_f, gx_b = (to(rng.randn(t, b, 2 * h).astype(np.float32)) for _ in range(2))
    cx_f, cx_b = (to(rng.randn(t, b, h).astype(np.float32)) for _ in range(2))
    # row norm ~1 (see the LSTM test above)
    wh_f, wh_b = ((to((rng.randn(h, 2 * h) / np.sqrt(h)).astype(np.float32)),
                   to((rng.randn(h, h) / np.sqrt(h)).astype(np.float32))) for _ in range(2))
    return gx_f, cx_f, gx_b, cx_b, wh_f, wh_b


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 100, 128, 256, 384, 512])
@pytest.mark.parametrize("b", [1, 11, 64, 301, 400])
def test_gru_kernels_match_plain(cuda, h, b):
    # the geometry ops/gru.py chooses, at every width and dna-pre's batch edges
    rng = np.random.RandomState(300 + h + b)
    t = 30 if b <= 64 else 12
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    gx_f, cx_f, gx_b, cx_b, wh_f, wh_b = _gru_inputs(rng, t, b, h, to)
    lengths = _lengths(rng, t, b, full=min(4, b))
    lens, starts = to(lengths), to((t - lengths).astype(np.int32))
    before, inst = dict(tgru.launches), dict(tgru.instance_launches)
    route = tgru.geometry(b, h, 2).instance
    got_f, got_b = tgru.bigru_layer(gx_f, cx_f, gx_b, cx_b, wh_f, wh_b, lens, starts)
    assert tgru.launches["bigru"] == before["bigru"] + 1
    assert tgru.instance_launches[route] == inst[route] + 1
    want_f, want_b = tgru.bigru_layer_plain(gx_f, cx_f, gx_b, cx_b, wh_f, wh_b, lens, starts)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got_f.cpu().numpy(), want_f.cpu().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_b.cpu().numpy(), want_b.cpu().numpy(), atol=1e-5, rtol=0)
    # the fused layer is two single-direction launches, bit for bit (each
    # output's k sum is one thread's, in order, whatever the geometry)
    one_f = tgru.gru_layer(gx_f, cx_f, *wh_f, lens)
    one_b = tgru.gru_layer(gx_b, cx_b, *wh_b, lens, starts)
    assert tgru.launches["gru"] == before["gru"] + 2
    assert torch.equal(one_f, got_f) and torch.equal(one_b, got_b)
    again = tgru.bigru_layer(gx_f, cx_f, gx_b, cx_b, wh_f, wh_b, lens, starts)
    assert torch.equal(again[0], got_f) and torch.equal(again[1], got_b), "differs between runs"
    zero = tgru.gru_layer(gx_f, cx_f, *wh_f, torch.zeros_like(lens))
    assert not zero.any()


# each instance forced where it fits a block (the resident one up to H = 128,
# the streamed one at any width; odd widths store unit by unit, even ones a
# thread's two units at once): against the plain version, bit-identical to
# the streamed instance and across runs, exact zeros for a zero-length batch,
# its own launch counter
@pytest.mark.cuda
@pytest.mark.parametrize("instance,h,t,b", [
    (i, h, t, b) for h, t, b in [(128, 40, 400), (100, 30, 64), (16, 30, 1), (128, 20, 301),
                                 (384, 12, 64), (7, 20, 5), (101, 20, 33), (263, 12, 17)]
    for i in tgru.instances(h)])
def test_gru_each_instance_matches_plain(cuda, instance, h, t, b):
    geom = tgru.geometry(b, h, 2, instance)
    rng = np.random.RandomState(600 + h + b)
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    gx_f, cx_f, gx_b, cx_b, wh_f, wh_b = _gru_inputs(rng, t, b, h, to)
    lengths = _lengths(rng, t, b, full=min(4, b))
    lens, starts = to(lengths), to((t - lengths).astype(np.int32))

    def fused(g, lengths):
        return tgru._launch("bigru", (gx_f, gx_b), (cx_f, cx_b), (wh_f, wh_b), lengths, starts, g)

    before = dict(tgru.instance_launches)
    got = fused(geom, lens)
    assert tgru.instance_launches[geom.instance] == before[geom.instance] + 1
    again = fused(geom, lens)
    other = fused(tgru.geometry(b, h, 2, "streamed"), lens)
    one = [tgru._launch("gru", (gx,), (cx,), (wh,), lens, st, geom)[0]
           for gx, cx, wh, st in ((gx_f, cx_f, wh_f, None), (gx_b, cx_b, wh_b, starts))]
    want = tgru.bigru_layer_plain(gx_f, cx_f, gx_b, cx_b, wh_f, wh_b, lens, starts)
    zero = fused(geom, torch.zeros_like(lens))
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=1e-5, rtol=0)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"
    assert all(torch.equal(a, g) for a, g in zip(other, got)), "resident != streamed"
    assert all(torch.equal(a, g) for a, g in zip(one, got)), "fused != single"
    assert not any(z.any() for z in zero)


def _bn_weights(rng, h, to):
    f32 = np.float32
    return (to((rng.randn(h, 4 * h) / np.sqrt(h)).astype(f32)),
            to((rng.randn(4 * h) * 0.1).astype(f32)),
            to((0.1 + rng.rand(4 * h) * 0.2).astype(f32)),
            to((0.1 + rng.rand(4 * h) * 0.2).astype(f32)),
            to((0.1 + rng.rand(h) * 0.2).astype(f32)), to((rng.randn(h) * 0.1).astype(f32)))


# (h, t, b): the cluster instance (H <= 384 at these batches; B = 400 and 301
# at dna-pre's width are two clusters of 16 a direction, each 4 row groups x 4
# unit slices) and the cooperative kernel where no cluster holds the shape
# (H = 512; 2500 rows)
@pytest.mark.cuda
@pytest.mark.parametrize("h,t,b", [(16, 30, 19), (100, 30, 19), (128, 30, 19), (256, 12, 19),
                                   (384, 12, 19), (512, 12, 19), (128, 40, 400), (100, 30, 301),
                                   (64, 8, 2500)])
def test_bnlstm_kernels_match_plain(cuda, h, t, b):
    rng = np.random.RandomState(400 + h)
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw_f, xw_b = (to(rng.randn(t, b, 4 * h).astype(np.float32)) for _ in range(2))
    w_f, w_b = _bn_weights(rng, h, to), _bn_weights(rng, h, to)
    # eight full rows keep each step's variances well above eps
    lens = to(_lengths(rng, t, b, full=8))
    geom = tbn.geometry(b, h, 2)
    before, inst = dict(tbn.launches), dict(tbn.instance_launches)
    got_f, got_b = tbn.bibnlstm_layer(xw_f, xw_b, w_f, w_b, lens)
    assert tbn.launches["bibnlstm"] == before["bibnlstm"] + 1
    assert tbn.instance_launches[geom.instance] == inst[geom.instance] + 1
    want_f, want_b = tbn.bibnlstm_layer_plain(xw_f, xw_b, w_f, w_b, lens)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got_f.cpu().numpy(), want_f.cpu().numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_b.cpu().numpy(), want_b.cpu().numpy(), atol=1e-4, rtol=0)
    # bit-stable from run to run
    again_f, again_b = tbn.bibnlstm_layer(xw_f, xw_b, w_f, w_b, lens)
    assert torch.equal(again_f, got_f) and torch.equal(again_b, got_b), "differs between runs"
    # and equal to two single-direction launches: bit for bit where both take
    # one geometry (every cluster shape; the cooperative kernel's moments are
    # combined in tile order, and at the large batch the fused grid needs
    # larger tiles than a single one)
    one_f = tbn.bnlstm_layer(xw_f, *w_f, lens)
    one_b = tbn.bnlstm_layer(xw_b, *w_b, lens)
    assert tbn.launches["bnlstm"] == before["bnlstm"] + 2
    if tbn.geometry(b, h, 1) == geom:
        assert torch.equal(one_f, got_f) and torch.equal(one_b, got_b), "fused != single"
    else:
        np.testing.assert_allclose(one_f.cpu().numpy(), got_f.cpu().numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(one_b.cpu().numpy(), got_b.cpu().numpy(), atol=1e-5, rtol=0)
    zero = tbn.bnlstm_layer(xw_f, *w_f, torch.zeros_like(lens))
    assert not zero.any()


# both instances at shapes that either can take: each against the plain
# version, bit-stable, fused == single, exact zeros for a zero-length batch, and
# its own launch counter
@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["cluster", "cooperative"])
@pytest.mark.parametrize("h,t,b", [(128, 40, 400), (100, 30, 64), (128, 30, 11)])
def test_bnlstm_each_instance_matches_plain(cuda, instance, h, t, b):
    rng = np.random.RandomState(500 + h + b)
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw_f, xw_b = (to(rng.randn(t, b, 4 * h).astype(np.float32)) for _ in range(2))
    w_f, w_b = _bn_weights(rng, h, to), _bn_weights(rng, h, to)
    lens = to(_lengths(rng, t, b, full=min(8, b)))
    geom = tbn.geometry(b, h, 2)
    if instance == "cooperative":
        rows = 8
        geom = tbn.Geometry("cooperative", 1, -(-b // rows), 1, rows, 1,
                            min(-(-4 * h // 32) * 32, 1024), tbn.coop_smem_bytes(h, rows))
    assert geom.instance == instance

    def fused(lengths):
        return tbn._launch("bibnlstm", (xw_f, xw_b), (w_f, w_b), lengths, geom)

    before = dict(tbn.instance_launches)
    got = fused(lens)
    assert tbn.instance_launches[instance] == before[instance] + 1
    again = fused(lens)
    one = [tbn._launch("bnlstm", (x,), (w,), lens, geom)[0] for x, w in ((xw_f, w_f), (xw_b, w_b))]
    want = tbn.bibnlstm_layer_plain(xw_f, xw_b, w_f, w_b, lens)
    zero = fused(torch.zeros_like(lens))
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=1e-4, rtol=0)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"
    assert all(torch.equal(a, g) for a, g in zip(one, got)), "fused != single"
    assert not any(z.any() for z in zero)


@pytest.mark.cuda
@pytest.mark.parametrize("h,b", [(16, 19), (100, 19), (128, 19), (256, 19), (128, 1), (128, 24),
                                 (7, 5), (128, 300), (128, 301), (100, 300), (256, 300),
                                 (384, 64), (512, 301), (512, 1)])
def test_lstm_grad_kernels_match_plain(cuda, h, b):
    rng = np.random.RandomState(100 + h)
    t = 37
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw = to(rng.randn(t, b, 4 * h).astype(np.float32))
    # at H = 256 weights of row norm ~1: 0.3 * randn makes the recurrence chaotic
    # there, and it then amplifies the sum-order residue past any tolerance; so
    # at B >= 300 too, where a few of the many rows reach that regime
    scale = 0.3 if h <= 128 and b < 300 else 1.0 / np.sqrt(h)
    wh = to((rng.randn(h, 4 * h) * scale).astype(np.float32))
    dhs = to(rng.randn(t, b, h).astype(np.float32))
    lengths = rng.randint(1, t, size=b).astype(np.int32)
    lengths[0], lengths[-1] = 0, t  # a single row is a full one
    lens = to(lengths)
    before = dict(tlg.launches)
    got = tlg.lstm_fwd_residuals(xw, wh, lens)
    assert tlg.launches["lstm_fwd_residuals"] == before["lstm_fwd_residuals"] + 1
    want = tlg.lstm_fwd_residuals_plain(xw, wh, lens)
    again = tlg.lstm_fwd_residuals(xw, wh, lens)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"
    for g, r in zip(got, want):  # rtol: the carried c is unbounded and sums
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=1e-5, rtol=1e-4)
    dxw, dwh = tlg.lstm_bwd(*want[1:], dhs, wh, lens)
    assert tlg.launches["lstm_bwd"] == before["lstm_bwd"] + 1
    dxw_p, dwh_p = tlg.lstm_bwd_plain(*want[1:], dhs, wh, lens)
    torch.cuda.synchronize()
    np.testing.assert_allclose(dxw.cpu().numpy(), dxw_p.cpu().numpy(), atol=1e-4, rtol=0)
    scale = float(dwh_p.abs().max())
    assert float((dwh - dwh_p).abs().max()) <= 1e-4 * scale
    dxw2, dwh2 = tlg.lstm_bwd(*want[1:], dhs, wh, lens)
    assert torch.equal(dwh, dwh2) and torch.equal(dxw, dxw2)
    # and on the residuals the kernel forward wrote
    dxw_k, dwh_k = tlg.lstm_bwd(*got[1:], dhs, wh, lens)
    dxw_kp, dwh_kp = tlg.lstm_bwd_plain(*got[1:], dhs, wh, lens)
    torch.cuda.synchronize()
    np.testing.assert_allclose(dxw_k.cpu().numpy(), dxw_kp.cpu().numpy(), atol=1e-4, rtol=0)
    assert float((dwh_k - dwh_kp).abs().max()) <= 1e-4 * float(dwh_kp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("seed,w,nclass,bonus", [(0, 8, 5, 0.0), (1, 30, 5, 0.6),
                                                 (2, 50, 5, 0.0), (3, 8, 6, 0.7),
                                                 (4, 64, 8, 1.5), (5, 65, 5, 0.6),
                                                 (6, 100, 5, 0.0), (7, 256, 5, 0.6),
                                                 (8, 30, 10, 0.6), (9, 32, 8, 0.0),
                                                 (10, 1, 2, 0.0), (11, 17, 3, 0.6)])
def test_beam_kernels_match_plain(cuda, seed, w, nclass, bonus):
    rng = np.random.RandomState(seed)
    b, t = 9, 40
    logits = (rng.randn(b, t, nclass) * 2).astype(np.float32)
    lens = rng.randint(1, t, size=b).astype(np.int32)
    lens[0], lens[1] = 0, t
    lp = torch.log_softmax(torch.tensor(logits, device=cuda), dim=-1)
    sl = torch.tensor(lens, device=cuda)
    got = tbeam.beam_search(lp, sl, w, bonus)
    want = tbeam.beam_search_plain(lp, sl, w, bonus)
    again = tbeam.beam_search(lp, sl, w, bonus)
    best = torch.argmax(tbeam._lae(*got[1:]), dim=1).to(torch.int32)
    chars = tbeam.beam_traceback(got[0], best)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(chars.cpu().numpy(),
                                  tbeam.beam_traceback_plain(got[0], best).cpu().numpy())
    dg = tbeam.beam_search_decode(torch.tensor(logits, device=cuda), sl, w, bonus)
    dc = tbeam.beam_search_decode(torch.tensor(logits), torch.tensor(lens), w, bonus)
    np.testing.assert_array_equal(dg[0].cpu().numpy(), dc[0].numpy())
    np.testing.assert_array_equal(dg[1].cpu().numpy(), dc[1].numpy())


# logits from {0, 1}: many candidates score exactly alike, besides the -1e30
# sentinels of the first steps, so the warp kernel's rounds meet tied heads and
# rerun with the pool-index tie break; the block kernel sorts the ties by index
@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 30, 100])
def test_beam_kernels_exact_on_tied_scores(cuda, w):
    rng = np.random.RandomState(w)
    b, t = 16, 60
    logits = rng.randint(0, 2, size=(b, t, 5)).astype(np.float32)
    lens = rng.randint(1, t, size=b).astype(np.int32)
    lens[0] = t
    lp = torch.log_softmax(torch.tensor(logits, device=cuda), dim=-1)
    sl = torch.tensor(lens, device=cuda)
    got = tbeam.beam_search(lp, sl, w, 0.3)
    want = tbeam.beam_search_plain(lp, sl, w, 0.3)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_raises_on_bad_cuda_input(cuda):
    x = torch.zeros(2, 8, 4, device=cuda, dtype=torch.float64)
    one = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        tconv.conv_bn([(x, one, one)], torch.zeros(3, 4, 4, device=cuda), False)
    with pytest.raises(ValueError):  # float64 is CPU-only
        tlg.lstm_fwd_residuals(torch.zeros(3, 2, 8, device=cuda, dtype=torch.float64),
                               torch.zeros(2, 8, device=cuda, dtype=torch.float64),
                               torch.ones(2, device=cuda, dtype=torch.int32))
    assert tlg.MAX_HIDDEN == tlstm.MAX_HIDDEN == 512
    with pytest.raises(ValueError):  # hidden above 512
        h = tlg.MAX_HIDDEN + 1
        tlg.lstm_fwd_residuals(torch.zeros(3, 2, 4 * h, device=cuda),
                               torch.zeros(h, 4 * h, device=cuda),
                               torch.ones(2, device=cuda, dtype=torch.int32))
    lens2 = torch.ones(2, device=cuda, dtype=torch.int32)
    h = tlstm.MAX_HIDDEN + 1
    with pytest.raises(ValueError):  # hidden above 512
        tlstm.lstm_layer(torch.zeros(3, 2, 4 * h, device=cuda), torch.zeros(h, 4 * h, device=cuda),
                         lens2)
    with pytest.raises(ValueError):
        tgru.gru_layer(torch.zeros(3, 2, 2 * h, device=cuda), torch.zeros(3, 2, h, device=cuda),
                       torch.zeros(h, 2 * h, device=cuda), torch.zeros(h, h, device=cuda), lens2)
    with pytest.raises(ValueError):  # lengths on another device than xw
        tbn.bnlstm_layer(torch.zeros(3, 2, 32, device=cuda), torch.zeros(8, 32, device=cuda),
                         *[torch.zeros(32, device=cuda)] * 3, *[torch.zeros(8, device=cuda)] * 2,
                         lens2.cpu())
    with pytest.raises(ValueError):  # a pool no block's shared memory holds (W <= 1638 at C = 5)
        tbeam.beam_search(torch.zeros(2, 5, 5, device=cuda), torch.zeros(2, device=cuda,
                                                                          dtype=torch.int32),
                          beam_width=1639)
