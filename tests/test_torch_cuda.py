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
T*B rows; 1e-5 for the single direction's cluster-of-16 kernel,
csrc/lstm_c16.cu, at H = 321-384 and at Bonito HAC's T = 800, B = 400, whose
3xTF32 product sums in another order than csrc/bilstm.cu's, so there the fused
layer is held bit for bit to csrc/bilstm.cu's single direction, forced); the beam search is exact (trace, decodes) with log masses within
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
block kernel), each bit-identical from run to run. The bf16 instances of
conv_bn and of the LSTM inference kernel (bf16 inference mode) are held in
bf16 ulps and shares against their plain versions, and bit for bit against
the float32 instance on the upcast input (see the section at the end). The
CTC loss's two kernels are held at tests/test_torch_ctc_loss.py's
tolerances (values 1e-5 relative, gradients 1e-5): their lp, alpha, beta and
nll are the plain version's bit for bit, only the class sums' order differs;
bit-identical from run to run.
"""

import numpy as np
import pytest
import torch

from chiron_tpu_torch.ops import beam as tbeam
from chiron_tpu_torch.ops import bilstm as tbl
from chiron_tpu_torch.ops import bnlstm as tbn
from chiron_tpu_torch.ops import conv_bn as tconv
from chiron_tpu_torch.ops import cuda_build
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


# conv_bn's shapes in the CNN zoo's fronts (chip_smoke.py's ZOO: every front no
# bundled model runs, at its published widths) at a full dna-pre batch (B = 400,
# window 400), one entry per distinct (k, stride, T, C_in, C_out, terms, relu_in)
# that dna_model1 does not give; tests/test_torch_zoo.py checks this list against
# the fronts. Among them the one shape that misses the tensor cores in float32:
# gate_conv_net_high's res1.conv2b (k = 17, stride 9, 200 -> 200), whose float32
# slab needs 384 bytes more shared memory than a block has (its bf16 instance's
# fits), and dynamic_net's 250 input channels (no multiple of 4)
ZOO_CONV_SHAPES = [
    (1, 1, 45, 200, 200, 1, True), (1, 1, 45, 200, 200, 2, True),
    (1, 1, 45, 200, 400, 1, False), (1, 1, 45, 400, 600, 1, False),
    (1, 1, 45, 600, 800, 1, False), (1, 1, 58, 256, 256, 1, True),
    (1, 1, 58, 256, 256, 2, True), (3, 1, 58, 256, 256, 1, True),
    (1, 1, 80, 256, 256, 1, False), (1, 1, 80, 256, 256, 1, True),
    (1, 1, 80, 256, 256, 2, True), (3, 1, 80, 256, 256, 1, True),
    (3, 1, 100, 32, 48, 1, True), (5, 1, 100, 32, 48, 1, True),
    (1, 1, 100, 256, 256, 1, True), (1, 1, 100, 256, 256, 2, True),
    (3, 1, 100, 256, 256, 1, True), (1, 1, 100, 288, 32, 1, False),
    (1, 1, 100, 288, 48, 1, False), (1, 1, 200, 1, 256, 1, False),
    (1, 2, 200, 1, 256, 1, False), (3, 1, 200, 32, 48, 1, True),
    (5, 1, 200, 32, 48, 1, True), (3, 1, 200, 250, 256, 1, False),
    (1, 1, 200, 256, 256, 1, True), (3, 2, 200, 256, 256, 1, True),
    (1, 1, 200, 288, 32, 1, False), (1, 1, 200, 288, 48, 1, False),
    (3, 1, 400, 1, 64, 1, False), (1, 1, 400, 1, 200, 1, False),
    (1, 9, 400, 1, 200, 1, False), (1, 2, 400, 1, 256, 1, False),
    (1, 5, 400, 1, 256, 1, False), (14, 7, 400, 1, 256, 1, False),
    (3, 1, 400, 32, 48, 1, True), (5, 1, 400, 32, 48, 1, True),
    (3, 1, 400, 64, 128, 1, True), (3, 1, 400, 128, 256, 1, True),
    (17, 9, 400, 200, 200, 1, True), (1, 1, 400, 256, 32, 1, True),
    (1, 1, 400, 256, 48, 1, False), (1, 1, 400, 256, 48, 1, True),
    (1, 1, 400, 256, 256, 1, False), (5, 1, 400, 256, 256, 1, True),
    (5, 2, 400, 256, 256, 1, True), (13, 5, 400, 256, 256, 1, True),
    (15, 5, 400, 256, 256, 1, True), (1, 1, 400, 288, 32, 1, False),
    (1, 1, 400, 288, 48, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,relu_in", ZOO_CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bn_zoo_shapes_match_plain(cuda, k, stride, t, c_in, c_out, n_terms, relu_in,
                                        dtype):
    """Each instance at each zoo shape, B = 400: float32 1e-4, bf16 in the
    working type (as the bf16 cases below), bit-identical across runs, and,
    where both instances take one route, the bf16 instance the float32
    instance's function rounded. The moments within 1e-4 (relative and
    absolute) of the same sums in float64: over 160,000 rows with
    cancellation, the float32 plain version's own sums sit up to ~1.7e-4
    from them."""
    gen = torch.Generator().manual_seed(k * 1000 + t + c_in + c_out)
    terms = [((torch.randn(400, t, c_in, generator=gen)).to(cuda).to(dtype),
              (0.5 + torch.rand(c_in, generator=gen)).to(cuda),
              (0.2 * torch.randn(c_in, generator=gen)).to(cuda)) for _ in range(n_terms)]
    w = (torch.randn(k, c_in, c_out, generator=gen) * (2 / (k * c_in + c_out)) ** 0.5).to(cuda)
    key = str(dtype).split(".")[-1]
    before = dict(tconv.launches_by_dtype)
    got = tconv.conv_bn(terms, w, relu_in, stride, out_dtype=dtype)
    assert tconv.launches_by_dtype == {**before, key: before[key] + 1}
    want = tconv.conv_bn_plain(terms, w, relu_in, stride, out_dtype=dtype)
    again = tconv.conv_bn(terms, w, relu_in, stride, out_dtype=dtype)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"
    if dtype == torch.float32:
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        _assert_bf16_close(got[0], want[0], 1e-4)
        routes = {cuda_build.load("conv_bn").conv_bn_route(c_in, c_out, k, stride,
                                                           int(n_terms == 2), bf16)
                  for bf16 in (0, 1)}
        if len(routes) == 1:
            y32, s32, q32 = tconv.conv_bn([(r.float(), a, b) for r, a, b in terms], w,
                                          relu_in, stride)
            assert torch.equal(got[0], y32.to(BF16))
            assert torch.equal(got[1], s32) and torch.equal(got[2], q32)
    x64 = sum(r.double() * a.double() + b.double() for r, a, b in terms)
    y64 = tconv.conv1d(torch.relu(x64) if relu_in else x64, w.double(), stride)
    for g, r in zip(got[1:], (y64.sum(dim=(0, 1)), (y64 * y64).sum(dim=(0, 1)))):
        np.testing.assert_allclose(g.double().cpu().numpy(), r.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)


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
    # the fused layer is csrc/bilstm.cu's single direction, twice, bit for bit
    # (at another geometry: each column's k sum is one thread's, in order,
    # whatever the tile); where lstm_layer takes csrc/lstm_c16.cu (H = 384),
    # against that single direction forced, which streams wh as the fused one
    fused_f, fused_b = tbl.bilstm_layer(xw_f, xw_b, wh_f, wh_b, lens, starts)
    one_f, one_b = got_f, got_b
    if tlstm.route(b, h) == "cluster16":
        one_f = tlstm._launch(xw_f, wh_f, lens, None, "streamed")
        one_b = tlstm._launch(xw_b, wh_b, lens, starts, "streamed")
    assert torch.equal(fused_f, one_f) and torch.equal(fused_b, one_b)
    zero = tlstm.lstm_layer(xw_f, wh_f, torch.zeros_like(lens))
    assert not zero.any()


# (h, t, b, flip): Bonito HAC's layer (T = 800, B = 400, H = 384) with ragged
# lengths, forward and in flip mode (starts = T - len); short runs at B = 64
# and B = 1; the route's edges at B = 400 (H = 321, where cluster_geometry first
# streams wh) and H = 384 (its top: 16 blocks x 24 units); B = 600, past the
# 64 rows a cluster of one wave holds
C16_CASES = [(384, 800, 400, False), (384, 800, 400, True), (384, 20, 64, False),
             (384, 12, 1, True), (321, 20, 400, True), (384, 20, 600, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,t,b,flip", C16_CASES)
def test_lstm_layer_cluster16_matches_plain(cuda, h, t, b, flip):
    rng = np.random.RandomState(500 + h + t + b)
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw = to(rng.randn(t, b, 4 * h).astype(np.float32))
    # row norm ~1, as in the LSTM tests above
    wh = to((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32))
    lengths = _lengths(rng, t, b)
    lens = to(lengths)
    starts = to((t - lengths).astype(np.int32)) if flip else None
    assert tlstm.route(b, h) == "cluster16" and tlstm.c16_clusters(cuda) >= 1
    assert cuda_build.load("lstm_c16").lstm_c16_smem_bytes() == tlstm.C16_SMEM_BYTES
    before = dict(tlstm.launches_by_route)
    got = tlstm.lstm_layer(xw, wh, lens, starts)
    again = tlstm.lstm_layer(xw, wh, lens, starts)
    assert tlstm.launches_by_route == {**before, "cluster16": before["cluster16"] + 2}
    streamed = tlstm._launch(xw, wh, lens, starts, "streamed")
    want = tlstm.lstm_layer_plain(xw, wh, lens, starts)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(streamed.cpu().numpy(), want.cpu().numpy(), atol=1e-5, rtol=0)
    assert torch.equal(again, got), "differs between runs"
    # bf16 xw stays on csrc/bilstm.cu (its instance streams wh here, or holds it at
    # H = 321, where its xw tiles take half the shared memory)
    bf16_route = tlstm.route(b, h, 1, BF16)
    assert bf16_route != "cluster16"
    before = dict(tlstm.launches_by_route)
    tlstm.lstm_layer(xw[:2].to(BF16), wh, lens, None if starts is None else starts - (t - 2))
    assert tlstm.launches_by_route == {**before, bf16_route: before[bf16_route] + 1}


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


def _ctc_case(seed, b, t, u, n_class, label_max=None):
    """Logits, per-row logit and label lengths, -1 padded labels with no two
    equal neighbours (so a label fits any logits at least as long, and is
    ignored where longer); with b >= 6 the edge rows of
    tests/test_torch_ctc_loss.py: repeats, an empty label, a label longer than
    its logits, a full-length row, a row with no frames, and a row with more
    frames than T."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, t, n_class) * 2).astype(np.float32)
    logit_len = rng.randint(t // 2, t + 1, size=b).astype(np.int32)
    label_len = rng.randint(1, (label_max or u) + 1, size=b).astype(np.int32)
    labels = np.full((b, u), -1, np.int32)
    for i in range(b):
        steps = rng.randint(1, n_class - 1, label_len[i])
        labels[i, :label_len[i]] = np.cumsum(steps) % (n_class - 1)
    if b >= 6 and u >= 5:
        labels[0, :4], label_len[0] = [1, 1, 2, 2], 4
        label_len[1], labels[1] = 0, -1
        logit_len[2], label_len[2] = 3, 5
        labels[2, :5] = [0, 1, 2, 3, 0]
        logit_len[3] = t
        logit_len[4], label_len[4], labels[4] = 0, 0, -1
        logit_len[5] = t + 5
    return logits, logit_len, labels, label_len


def _ctc_kernels_vs_plain(cuda, case, fl_gamma=0.0):
    """Kernels against ctc_loss_plain on the same CUDA tensors: per-row
    values, and the gradient of the weighted focal sum (each row's cotangent
    differs); the kernels bit-equal across two runs, one launch each a run."""
    from chiron_tpu_torch.ops import ctc_loss as tctc

    logits, logit_len, labels, label_len = case
    rest = [torch.tensor(a, device=cuda) for a in (logit_len, labels, label_len)]
    w = torch.tensor(np.linspace(0.5, 1.5, len(label_len)).astype(np.float32), device=cuda)

    def run(fn):
        lg = torch.tensor(logits, device=cuda, requires_grad=True)
        per_row = fn(lg, *rest)
        focal = torch.pow(1.0 - torch.exp(-per_row), fl_gamma) * per_row if fl_gamma else per_row
        (focal * w).sum().backward()
        return per_row.detach(), lg.grad

    before = dict(tctc.launches)
    got = run(tctc.ctc_loss)
    assert tctc.launches == {k: n + 1 for k, n in before.items()}
    again = run(tctc.ctc_loss)
    want = run(tctc.ctc_loss_plain)
    assert tctc.launches == {k: n + 2 for k, n in before.items()}
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), "differs between runs"
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), atol=1e-5, rtol=0)
    ignored = label_len > logit_len
    assert not got[0].cpu().numpy()[ignored].any() and not got[1].cpu().numpy()[ignored].any()
    past = np.arange(logits.shape[1])[None, :] >= logit_len[:, None]
    assert not got[1].cpu().numpy()[past].any()
    return got


# the train cell's step: B = T = 400, labels 120 wide (S = 241), bases ~44 a
# window, every row's own frame count
@pytest.mark.cuda
@pytest.mark.parametrize("fl_gamma", [0.0, 2.0])
def test_ctc_kernels_match_plain_at_the_train_shape(cuda, fl_gamma):
    from chiron_tpu_torch.ops import ctc_loss as tctc

    case = _ctc_case(400, 400, 400, 120, 5, label_max=90)
    _ctc_kernels_vs_plain(cuda, case, fl_gamma)
    # the mean the train step takes, through ctc_focal_loss
    lg = torch.tensor(case[0], device=cuda)
    rest = [torch.tensor(a, device=cuda) for a in case[1:]]
    got = tctc.ctc_focal_loss(lg, *rest, fl_gamma=fl_gamma)
    per_row = tctc.ctc_loss_plain(lg, *rest)
    want = (torch.pow(1.0 - torch.exp(-per_row), fl_gamma) * per_row if fl_gamma
            else per_row).mean()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,b,t,u,n_class", [
    (0, 6, 20, 7, 5),      # the edge rows at the CPU tests' size
    (1, 8, 40, 12, 5),
    (2, 7, 30, 6, 6),      # six classes (blank = 5)
    (3, 9, 64, 30, 5),     # a slot a thread, two warps
    (4, 8, 1300, 600, 5),  # S = 1201: two slots a thread
    (6, 8, 1700, 1500, 5),  # S = 3001: eight slots a thread, 384 threads
    (5, 8, 2600, 2048, 5),  # S = 4097: sixteen slots a thread, 288 threads
])
def test_ctc_kernels_match_plain_at_edge_cases(cuda, seed, b, t, u, n_class):
    _ctc_kernels_vs_plain(cuda, _ctc_case(seed, b, t, u, n_class), fl_gamma=2.0)


@pytest.mark.cuda
def test_ctc_kernels_with_no_labels(cuda):
    # a batch whose labels are all empty (U = 0, S = 1) and one of six classes
    rng = np.random.RandomState(9)
    logits = rng.randn(3, 12, 6).astype(np.float32)
    logit_len = np.array([12, 7, 1], np.int32)
    _ctc_kernels_vs_plain(cuda, (logits, logit_len, np.zeros((3, 0), np.int32),
                                 np.zeros(3, np.int32)))
    _ctc_kernels_vs_plain(cuda, (logits, logit_len, np.array([[4, 4, 0], [2, -1, -1],
                                                              [-1, -1, -1]], np.int32),
                                 np.array([3, 1, 0], np.int32)))


@pytest.mark.cuda
def test_a_train_step_launches_each_ctc_kernel_once(cuda):
    # make_train_step on the card: one ctc_alpha and one ctc_beta_grad a step
    from chiron_tpu_torch.models.model import init_model, model_ratio
    from chiron_tpu_torch.ops import ctc_loss as tctc
    from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
    from chiron_tpu_torch.train import loop

    config = {"cnn": {"model": "dna_model1"},
              "rnn": {"layer_num": 1, "hidden_num": 16, "cell_type": "LSTM",
                      "layer_type": "normal"}}
    model = from_jax_params(init_model(torch.Generator().manual_seed(0), config), config,
                            cuda).requires_grad_(True)
    ema = from_jax_params(to_numpy_tree(model), config, cuda)
    opt = loop.make_optimizer("Adam", 1e-3, 100, model.parameters())
    step = loop.make_train_step(config, 2.0)
    rng = np.random.RandomState(0)
    labels = np.full((8, 12), -1, np.int32)
    label_len = rng.randint(1, 13, 8).astype(np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, 4, n)
    batch = loop.batch_to_device({"signal": rng.randn(8, 64).astype(np.float32),
                                  "seq_len": rng.randint(40, 65, 8).astype(np.int32),
                                  "label": labels, "label_len": label_len},
                                 model_ratio(config, 64), cuda)
    before = dict(tctc.launches)
    losses = [float(step(model, ema, opt, batch, i)) for i in range(2)]
    assert tctc.launches == {k: n + 2 for k, n in before.items()}
    assert np.isfinite(losses).all()


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
    from chiron_tpu_torch.ops import ctc_loss as tctc

    ctc_rest = [torch.ones(2, device=cuda, dtype=torch.int32),
                torch.zeros(2, 1, device=cuda, dtype=torch.int32),
                torch.ones(2, device=cuda, dtype=torch.int32)]
    for dtype in (torch.float64, torch.bfloat16):  # the CTC kernels are float32
        with pytest.raises(ValueError):
            tctc.ctc_loss(torch.zeros(2, 5, 5, device=cuda, dtype=dtype), *ctc_rest)
    for i in range(3):  # a length or the labels on the CPU, the logits on the card
        with pytest.raises(ValueError):
            tctc.ctc_loss(torch.zeros(2, 5, 5, device=cuda),
                          *[r.cpu() if j == i else r for j, r in enumerate(ctc_rest)])
    with pytest.raises(ValueError):  # a pool no block's shared memory holds (W <= 1638 at C = 5)
        tbeam.beam_search(torch.zeros(2, 5, 5, device=cuda), torch.zeros(2, device=cuda,
                                                                          dtype=torch.int32),
                          beam_width=1639)


# ---- bf16 inference mode: the bf16 instances of conv_bn and the LSTM inference
# kernel. Held in the working type against the plain versions on the card: each
# bfloat16 output equal or one ulp apart from the plain version's (or within the
# float32 gate, 1e-4 conv / 1e-5 LSTM, where a value near zero spans several
# ulps), identical on >= 99.9%; float32 moments 1e-4; bit-identical across runs
# and to the float32 instance on the upcast input with its output rounded (the
# bf16 instance is that function); the per-dtype launch counters move.

BF16 = torch.bfloat16


def _assert_bf16_close(got, want, atol, min_same=0.999):
    def ordered(t):
        b = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7FFF), b)

    ulps = (ordered(got) - ordered(want)).abs()
    off = (ulps > 1) & ((got.float() - want.float()).abs() > atol)
    assert not bool(off.any()), f"{int(off.sum())} elements more than 1 ulp and {atol} apart"
    same = float((ulps == 0).float().mean()) if ulps.numel() else 1.0
    assert same >= min_same, f"only {same:.5f} identical"


def _unaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


BF16_CONV_CASES = [
    # k, stride, t, c_in, c_out, n_terms, relu_in, bsz
    (1, 1, 400, 1, 256, 1, False, 4),   # dna_model1's first convs: the bf16 window
    (9, 5, 2000, 1, 256, 1, False, 3),  # rna_model2's front
    (8, 4, 2000, 1, 256, 1, False, 3),  # slow_model1's front
    (1, 1, 400, 256, 256, 2, True, 4),  # the tensor-core kernel, two terms
    (3, 1, 400, 256, 256, 1, True, 4),
    (3, 1, 130, 20, 72, 2, True, 3),    # ragged row and channel tiles
    (3, 1, 40, 3, 10, 1, True, 3),      # narrow input, C_out no multiple of 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,relu_in,bsz", BF16_CONV_CASES)
@pytest.mark.parametrize("aligned", [True, False])
def test_conv_bn_bf16_kernel_matches_plain(cuda, k, stride, t, c_in, c_out, n_terms, relu_in,
                                           bsz, aligned):
    rng = np.random.RandomState(k + stride + c_in + 7)
    terms = []
    for _ in range(n_terms):
        raw = torch.tensor(rng.randn(bsz, t, c_in).astype(np.float32), device=cuda).to(BF16)
        terms.append((raw if aligned else _unaligned(raw),
                      torch.tensor((0.5 + rng.rand(c_in)).astype(np.float32), device=cuda),
                      torch.tensor((rng.randn(c_in) * 0.2).astype(np.float32), device=cuda)))
    w = torch.tensor((rng.randn(k, c_in, c_out) * 0.3).astype(np.float32), device=cuda)
    before = dict(tconv.launches_by_dtype)
    got = tconv.conv_bn(terms, w, relu_in, stride, out_dtype=BF16)
    assert tconv.launches_by_dtype == {**before, "bfloat16": before["bfloat16"] + 1}
    want = tconv.conv_bn_plain(terms, w, relu_in, stride, out_dtype=BF16)
    again = tconv.conv_bn(terms, w, relu_in, stride, out_dtype=BF16)
    torch.cuda.synchronize()
    assert got[0].dtype == BF16 and got[1].dtype == torch.float32
    _assert_bf16_close(got[0], want[0], 1e-4)
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "differs between runs"
    if aligned:  # the same route as the float32 instance: its function, y rounded
        y32, s32, q32 = tconv.conv_bn([(r.float(), a, b) for r, a, b in terms], w, relu_in,
                                      stride)
        assert torch.equal(got[0], y32.to(BF16))
        assert torch.equal(got[1], s32) and torch.equal(got[2], q32)


# (h, t, b): gate widths no multiple of 8 (20, 12: 4-byte copies of two bf16),
# odd (21: element copies), RNA_default's 100 (a ragged slice of 50 a block),
# DNA_default's 128 (16-byte copies) at dna-pre's batch, batch edges, and 384
# (wh from device memory)
BF16_LSTM_CASES = [(20, 30, 11), (12, 30, 11), (21, 30, 11), (100, 40, 400), (100, 30, 1),
                   (128, 40, 400), (128, 30, 301), (128, 30, 1), (384, 20, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,t,b", BF16_LSTM_CASES)
def test_lstm_inference_bf16_kernels_match_plain(cuda, h, t, b):
    rng = np.random.RandomState(300 + h + b)
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw_f, xw_b = (to(rng.randn(t, b, 4 * h).astype(np.float32)).to(BF16) for _ in range(2))
    wh_f, wh_b = (to((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)) for _ in range(2))
    lengths = _lengths(rng, t, b)
    lens, starts = to(lengths), to((t - lengths).astype(np.int32))
    before = (dict(tbl.launches_by_dtype), dict(tlstm.launches_by_dtype))
    got = tbl.bilstm_layer(xw_f, xw_b, wh_f, wh_b, lens, starts)
    one = [tlstm.lstm_layer(xw_f, wh_f, lens), tlstm.lstm_layer(xw_b, wh_b, lens, starts)]
    assert tbl.launches_by_dtype["bfloat16"] == before[0]["bfloat16"] + 1
    assert tlstm.launches_by_dtype["bfloat16"] == before[1]["bfloat16"] + 2
    assert (tbl.launches_by_dtype["float32"], tlstm.launches_by_dtype["float32"]) == (
        before[0]["float32"], before[1]["float32"])
    want = tbl.bilstm_layer_plain(xw_f, xw_b, wh_f, wh_b, lens, starts)
    again = tbl.bilstm_layer(xw_f, xw_b, wh_f, wh_b, lens, starts)
    f32 = tbl.bilstm_layer(xw_f.float(), xw_b.float(), wh_f, wh_b, lens, starts)
    torch.cuda.synchronize()
    for g, o, r, a, f in zip(got, one, want, again, f32):
        assert g.dtype == o.dtype == BF16
        _assert_bf16_close(g, r, 1e-5)
        assert torch.equal(a, g), "differs between runs"
        assert torch.equal(o, g), "the single direction differs from the fused layer"
        assert torch.equal(g, f.to(BF16)), "not the float32 instance's function, rounded"


@pytest.mark.cuda
@pytest.mark.parametrize("h", [128, 100, 21])
def test_lstm_inference_bf16_kernels_take_2_byte_aligned_xw(cuda, h):
    rng = np.random.RandomState(400 + h)
    t, b = 20, 9
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw_f, xw_b = (to(rng.randn(t, b, 4 * h).astype(np.float32)).to(BF16) for _ in range(2))
    wh_f, wh_b = (to((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)) for _ in range(2))
    lengths = _lengths(rng, t, b)
    lens, starts = to(lengths), to((t - lengths).astype(np.int32))
    got = tbl.bilstm_layer(_unaligned(xw_f), _unaligned(xw_b), wh_f, wh_b, lens, starts)
    one = tlstm.lstm_layer(_unaligned(xw_b), wh_b, lens, starts)
    want = tbl.bilstm_layer(xw_f, xw_b, wh_f, wh_b, lens, starts)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and torch.equal(one, want[1])


@pytest.mark.cuda
def test_bf16_wrappers_raise_on_the_card(cuda):
    t, b, h = 3, 2, 8
    xw = torch.zeros(t, b, 4 * h, device=cuda)
    wh = torch.zeros(h, 4 * h, device=cuda)
    lens = torch.ones(b, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):  # mixed directions
        tbl.bilstm_layer(xw.to(BF16), xw, wh, wh, lens, lens)
    with pytest.raises(ValueError):  # bf16 wh
        tlstm.lstm_layer(xw.to(BF16), wh.to(BF16), lens)
    raw, one = torch.zeros(2, 8, 4, device=cuda), torch.ones(4, device=cuda)
    with pytest.raises(ValueError):  # bf16 raw to a float32 y: no such instance
        tconv.conv_bn([(raw.to(BF16), one, one)], torch.zeros(3, 4, 4, device=cuda), False)


# ---- data parallelism on the card (chiron_tpu_torch/parallel) -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [0, 5])
def test_sharded_decode_on_the_card_equals_a_step_per_shard(cuda, beam):
    """The sharded decode over [cuda:0] * 4 equals four decode_steps on
    contiguous rows bit for bit (each shard normalised by its own moments),
    and over [cuda:0] the one decode_step; every kernel of the step ran."""
    import functools

    from chiron_tpu_torch.eval.pipeline import decode_step
    from chiron_tpu_torch.models.model import init_model
    from chiron_tpu_torch.parallel.dist import make_sharded_decode_step
    from chiron_tpu_torch.params import from_jax_params

    config = {"cnn": {"model": "dna_model1"},
              "rnn": {"layer_num": 1, "hidden_num": 16, "cell_type": "LSTM",
                      "layer_type": "normal"}}
    tree = init_model(torch.Generator().manual_seed(0), config)
    model = from_jax_params(tree, config, cuda)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(16, 64).astype(np.float32), device=cuda)
    sl = torch.tensor(rng.randint(1, 65, 16).astype(np.int32), device=cuda)
    step = functools.partial(decode_step, beam=beam)
    before = tconv.launches
    got = make_sharded_decode_step(step, [cuda] * 4)(model, x, sl)
    assert tconv.launches - before == 4 * 12  # dna_model1's twelve convs, per shard
    want = torch.cat([step(model, x[i:i + 4], sl[i:i + 4]) for i in range(0, 16, 4)])
    one = make_sharded_decode_step(step, [cuda])(model, x, sl)
    # a model held elsewhere is replicated onto the shards' device once
    on_host = make_sharded_decode_step(step, [cuda] * 4)
    replicated = [on_host(from_jax_params(tree, config, "cpu"), x, sl) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(one, step(model, x, sl))
    assert all(torch.equal(r, got) for r in replicated)
    # nothing in the sharded step waits on the host (a sync there would
    # serialise the shards on k cards): torch raises at any sync
    sharded = make_sharded_decode_step(step, [cuda] * 4)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sharded(model, x, sl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_dryrun_multichip_on_one_gpu_through_nccl(cuda):
    """One data-parallel train step in a one-rank NCCL group and the sharded
    decode at beam 0 and 4 (parallel/dryrun.py)."""
    from chiron_tpu_torch.parallel.dryrun import dryrun_multichip

    assert np.isfinite(dryrun_multichip(1, device="cuda"))


@pytest.mark.cuda
def test_bnlstm_validation_in_a_group_runs_the_recurrence_on_the_card(cuda):
    """Inside global_moments (a group of one) a BNLSTM model's inference
    forward launches no BNLSTM kernel (their moments are their own rows') and
    gives the kernels' logits within the BNLSTM tolerance."""
    import torch.distributed as dist

    from chiron_tpu_torch.models.model import init_model
    from chiron_tpu_torch.parallel.dist import free_port, global_moments
    from chiron_tpu_torch.params import from_jax_params

    config = {"cnn": {"model": "dna_model1"},
              "rnn": {"layer_num": 1, "hidden_num": 16, "cell_type": "BNLSTM",
                      "layer_type": "normal"}}
    model = from_jax_params(init_model(torch.Generator().manual_seed(0), config), config, cuda)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(16, 64).astype(np.float32), device=cuda)
    sl = torch.tensor(np.full(16, 64, np.int32), device=cuda)
    with torch.no_grad():
        want = model(x, sl)
        before = dict(tbn.launches)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        try:
            with global_moments():
                got = model(x, sl)
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize()
    assert tbn.launches == before
    assert float((got - want).abs().max()) <= 5e-4 * float(want.abs().max())


# -- Bonito's CRF model: the decode kernels and the stem's swish / padded convs ------
# The CRF kernels (csrc/crf.cu) against ops/crf.py's plain version on the card:
# beta within 1e-6 of its largest value (float32 logsumexps in another order;
# beta reaches ~4,000 at T = 800), the log posteriors within 1e-3 absolute (alpha
# + beta - logZ cancels two such sums), the Viterbi score within 1e-3 a frame,
# the mean posterior gap within 1e-4, and the paths equal except where the plain
# version's own log posteriors score the two paths within that tolerance (a
# near-tie). The stem's convs (swish prologue, k // 2 padding) at conv_bn's
# tolerances; the relu / SAME instances bit for bit what they were before the
# swish choice was added (the sha256 of their outputs on seeded inputs).

from chiron_tpu_torch.ops import crf as tcrf  # noqa: E402


def _crf_inputs(b, t, state_len, seed):
    g = torch.Generator().manual_seed(seed)
    s = 4 ** state_len
    z = 5 * torch.tanh(1.5 * torch.randn(b, t, 4 * s, generator=g))
    lens = torch.randint(max(1, t // 2), t + 1, (b,), generator=g).to(torch.int32)
    lens[0], lens[-1] = t, 1
    return z, lens


def _check_crf(z, lens, posteriors):
    dev = z.device
    b, t, _ = z.shape
    s = z.shape[2] // 4
    post = torch.zeros((b, t, s, 5), device=dev) if posteriors else None
    path, score, prob, beta = tcrf.crf_kernels(z, lens, 2.0, post)
    beta_p = tcrf.crf_beta_plain(z, lens, 2.0)
    tb, score_p, prob_p, final, post_p = tcrf.crf_forward_plain(z, lens, beta_p, 2.0,
                                                                posteriors=True)
    path_p = tcrf.crf_traceback_plain(tb, final, lens)
    live = torch.arange(t + 1, device=dev)[None, :, None] <= lens.long()[:, None, None]
    assert float(((beta - beta_p).abs() * live).max()) <= 1e-6 * float(beta_p.abs().max())
    if posteriors:
        assert float((post - post_p).abs().max()) <= 1e-3
    assert bool(((score - score_p).abs() <= 1e-3 * lens.float()).all())
    assert float((prob - prob_p).abs().max()) <= 1e-4
    # a path that differs is a near-tie under the plain version's posteriors
    pred = tcrf.predecessors(s, dev)
    for row in torch.nonzero((path != path_p).any(dim=1)).flatten().tolist():
        n = int(lens[row])

        def path_score(cols):
            st = torch.zeros(n, dtype=torch.long, device=dev)
            cur = int(final[row])
            for i in range(n - 1, -1, -1):
                st[i] = cur
                cur = int(pred[cur, int(cols[i])])
            return float(post_p[row, torch.arange(n, device=dev), st, cols[:n].long()].sum())

        assert abs(path_score(path[row]) - path_score(path_p[row])) <= 1e-3 * n
    assert float((path != path_p).any(dim=1).float().mean()) <= 0.01
    return path, score, prob


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,state_len", [(5, 60, 3), (7, 90, 1), (3, 33, 2), (16, 800, 5)])
def test_crf_kernels_match_plain(cuda, b, t, state_len):
    z, lens = _crf_inputs(b, t, state_len, seed=b + t)
    _check_crf(z.to(cuda), lens.to(cuda), posteriors=True)


@pytest.mark.cuda
def test_crf_kernels_match_plain_at_the_published_size(cuda):
    """B = 400, T = 800, 1,024 states (Bonito's HAC at batch 400); two runs
    bit-identical; each kernel launched once a decode."""
    z, lens = _crf_inputs(400, 800, 5, seed=4)
    z, lens = z.to(cuda), lens.to(cuda)
    path, score, prob = _check_crf(z, lens, posteriors=False)
    before = dict(tcrf.launches)
    again = tcrf.crf_kernels(z, lens, 2.0)
    assert all(torch.equal(a, b) for a, b in zip((path, score, prob), again[:3]))
    assert {k: tcrf.launches[k] - before[k] for k in before} == {
        "crf_beta": 1, "crf_viterbi": 1, "crf_traceback": 1}
    decoded, n, score2, _ = tcrf.crf_decode(z, lens, 2.0)
    assert torch.equal(score2, score) and int(n.max()) <= 800


STEM_CASES = [  # k, c_in, c_out, stride, swish_in: Bonito's three convs at T = 4,000
    (5, 1, 4, 1, False), (5, 4, 16, 1, True), (19, 16, 384, 5, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c_in,c_out,stride,swish_in", STEM_CASES)
def test_stem_conv_swish_padding_matches_plain(cuda, dtype, k, c_in, c_out, stride, swish_in):
    g = torch.Generator().manual_seed(k + c_out)
    x = torch.randn(24, 4000, c_in, generator=g).to(dtype).to(cuda)
    a = torch.ones(c_in, device=cuda)
    bias = (0.1 * torch.randn(c_in, generator=g)).to(cuda)
    w = (torch.randn(k, c_in, c_out, generator=g) * (3 / (k * c_in) ** 0.5)).to(cuda)
    got = tconv.conv_bn([(x, a, bias)], w, False, stride=stride, out_dtype=dtype,
                        swish_in=swish_in, padding=k // 2)
    want = tconv.conv_bn_plain([(x, a, bias)], w, False, stride, dtype, swish_in, k // 2)
    assert got[0].shape == (24, -(-4000 // stride), c_out)
    scale = float(want[0].float().abs().max())
    if dtype == torch.float32:
        assert float((got[0] - want[0]).abs().max()) <= 1e-4 * scale
    else:  # one bf16 ulp of the largest value
        assert float((got[0].float() - want[0].float()).abs().max()) <= scale / 128
    for i in (1, 2):
        assert torch.allclose(got[i], want[i], rtol=1e-4, atol=1e-4 * float(want[i].abs().max()))
    again = tconv.conv_bn([(x, a, bias)], w, False, stride=stride, out_dtype=dtype,
                          swish_in=swish_in, padding=k // 2)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


# sha256 (first 16 hex digits) of (y, sums, sqs) of each relu / SAME launch below,
# from the kernels before the swish prologue was added (measured on an H100)
RELU_SAME_DIGESTS = {
    ("float32", 3, 256, 256, 1, 1, True): "bd553822ede7b42e",
    ("float32", 1, 256, 256, 1, 2, True): "225d410d1608714c",
    ("float32", 1, 256, 256, 1, 1, False): "0733ac29b2e77267",
    ("float32", 1, 1, 256, 1, 1, False): "5bd6b5b85671496f",
    ("float32", 9, 1, 256, 5, 1, False): "254f8a8f44fa89a0",
    ("float32", 3, 256, 256, 2, 1, True): "d9c9870861932b75",
    ("bfloat16", 3, 256, 256, 1, 1, True): "c527d1d7b9130476",
    ("bfloat16", 1, 256, 256, 1, 2, True): "b96191f2a0c7d999",
    ("bfloat16", 1, 256, 256, 1, 1, False): "28f6486bd08a7fe5",
    ("bfloat16", 1, 1, 256, 1, 1, False): "c89654eebe1bee1c",
    ("bfloat16", 9, 1, 256, 5, 1, False): "7afe8d7ad7dafa89",
    ("bfloat16", 3, 256, 256, 2, 1, True): "ddd7c34039ce121a",
}


@pytest.mark.cuda
def test_conv_bn_relu_same_instances_unchanged_by_the_swish_choice(cuda):
    """dna_model1's and the fronts' launches (T = 400, B = 400), in one seeded
    sequence, give the bits they gave before: swish is a template parameter of
    the kernels, and its instances are the only new code."""
    import hashlib

    g = torch.Generator().manual_seed(6)
    for dt in (torch.float32, torch.bfloat16):
        for k, ci, co, s, nt, relu in [(3, 256, 256, 1, 1, True), (1, 256, 256, 1, 2, True),
                                       (1, 256, 256, 1, 1, False), (1, 1, 256, 1, 1, False),
                                       (9, 1, 256, 5, 1, False), (3, 256, 256, 2, 1, True)]:
            terms = [(torch.randn(400, 400, ci, generator=g).to(cuda).to(dt),
                      (torch.rand(ci, generator=g) + 0.5).to(cuda),
                      (torch.randn(ci, generator=g) * 0.1).to(cuda)) for _ in range(nt)]
            w = (torch.randn(k, ci, co, generator=g) / (k * ci) ** 0.5).to(cuda)
            out = tconv.conv_bn(terms, w, relu, stride=s, out_dtype=dt)
            digest = hashlib.sha256(b"".join(t.float().cpu().numpy().tobytes()
                                             for t in out)).hexdigest()[:16]
            assert digest == RELU_SAME_DIGESTS[(str(dt).split(".")[-1], k, ci, co, s, nt,
                                                relu)]


@pytest.mark.cuda
def test_crf_model_call_on_the_card(cuda, tmp_path):
    """A small CRF model's bf16 `call` on the card: the stem on conv_bn (3
    launches a batch), the stack on the single-direction LSTM kernel (5), the
    decode on the CRF kernels (one each), and a fastq for every read."""
    import json
    import os

    from chiron_tpu_torch import cli
    from chiron_tpu_torch.models import crf as mcrf
    from chiron_tpu_torch.reference import bonito_crf as RB
    from chiron_tpu_torch.train.checkpoint import save_checkpoint

    config = {"cnn": {"model": "bonito_stem", "features": 64, "winlen": 19, "stride": 5},
              "rnn": {"layer_num": 5, "hidden_num": 64, "cell_type": "LSTM",
                      "layer_type": "alternating"},
              "decoder": {"type": "crf", "state_len": 3, "scale": 5.0, "blank_score": 2.0}}
    state = RB.init_bonito(1, features=64, state_len=3, gains={"conv": 3.0, "lstm": 3.0,
                                                                  "head": 3.0})
    os.makedirs(tmp_path / "m")
    (tmp_path / "m" / "model.json").write_text(json.dumps(config))
    save_checkpoint(str(tmp_path / "m"), mcrf.from_bonito(state, 5), 0)
    rng = np.random.RandomState(3)
    os.makedirs(tmp_path / "in")
    for i in range(3):
        (tmp_path / "in" / f"r{i}.signal").write_text(
            " ".join(map(str, rng.randint(300, 700, 3000 + 500 * i).tolist())))
    before = (dict(tcrf.launches), tconv.launches, tlstm.launches, tcrf.frames_decoded())
    cli.main(["call", "-i", str(tmp_path / "in"), "-o", str(tmp_path / "out"), "-m",
              str(tmp_path / "m"), "-l", "1000", "-j", "875", "-b", "8", "--sig_norm", "0",
              "--bf16"])
    torch.cuda.synchronize()
    batches = 2  # 4 + 4 + 5 windows
    assert {k: tcrf.launches[k] - before[0][k] for k in tcrf.launches} == {
        "crf_beta": batches, "crf_viterbi": batches, "crf_traceback": batches}
    assert tconv.launches - before[1] == 3 * batches
    assert tlstm.launches - before[2] == 5 * batches
    # every window's own frames, ceil(samples / 5): reads of 3,000 / 3,500 / 4,000
    # samples in windows of 1,000 every 875, the last batch wrap-padded with r2's first 3
    lens = [1000, 1000, 1000, 375] + [1000, 1000, 1000, 875] + [1000] * 4 + [500] + [1000] * 3
    assert tcrf.frames_decoded() - before[3] == sum(-(-n // 5) for n in lens)
    for i in range(3):
        fq = (tmp_path / "out" / "result" / f"r{i}.fastq").read_text().split("\n")
        assert fq[0] == f"@r{i}" and len(fq[1]) == len(fq[3]) > 0
