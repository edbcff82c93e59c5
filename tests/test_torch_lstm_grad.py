"""The port's training LSTM (chiron_tpu_torch/ops/lstm_grad.py) against the
JAX package on CPU.

- The plain forward (out) and backward (dxw, dwh) against
  ``lstm_layer_pallas_ad(..., interpret=True)`` and its ``jax.vjp`` with a
  random cotangent, JAX's 128-lane padding sliced away: atol 2e-5 forward,
  2e-4 gradients (float32 sums in another order through T steps).
- ``lstm_layer_ad`` gradients of wx, wh, b and x against ``jax.grad``
  through ``_lstm_scan``, the independent scan reference: 2e-4, as
  tests/test_pallas_lstm_grad.py.
- ``torch.autograd.gradcheck`` of ``lstm_layer_ad`` in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.models.rnn import _lstm_scan
from chiron_tpu.ops.pallas.lstm import LANE, pad_lstm_weights
from chiron_tpu.ops.pallas.lstm_grad import lstm_layer_pallas_ad
from chiron_tpu_torch.ops import lstm_grad as tlg

LENGTHS = [8, 8, 5, 5, 3, 1, 1, 0]


def _inputs(h, seed, t=8, c_in=6):
    rng = np.random.RandomState(seed)
    b = len(LENGTHS)
    return (rng.randn(t, b, c_in).astype(np.float32),
            (rng.randn(c_in, 4 * h) * 0.3).astype(np.float32),
            (rng.randn(h, 4 * h) * 0.3).astype(np.float32),
            (rng.randn(4 * h) * 0.1).astype(np.float32),
            np.asarray(LENGTHS, np.int32),
            rng.randn(t, b, h).astype(np.float32))


def _unpad_gates(a, h):
    hp = a.shape[-1] // 4
    return np.concatenate([a[..., q * hp:q * hp + h] for q in range(4)], axis=-1)


@pytest.mark.parametrize("h", [16, 100, 128])
def test_plain_fwd_bwd_match_pallas_interpret(h):
    x, wx, wh, b, lengths, cot = _inputs(h, seed=h)
    wx_p, wh_p, b_p = pad_lstm_weights(jnp.asarray(wx), jnp.asarray(wh), jnp.asarray(b), h)
    xw_p = jnp.asarray(x) @ wx_p + b_p
    out_j, vjp = jax.vjp(lambda xw_, wh_: lstm_layer_pallas_ad(
        xw_, wh_, jnp.asarray(lengths), h, True), xw_p, wh_p)
    dxw_j, dwh_j = vjp(jnp.asarray(cot))
    assert wh_p.shape[0] == -(-h // LANE) * LANE

    xw = torch.tensor(x) @ torch.tensor(wx) + torch.tensor(b)
    out, gates, cc, hc = tlg.lstm_fwd_residuals(xw, torch.tensor(wh), torch.tensor(lengths))
    dxw, dwh = tlg.lstm_bwd(gates, cc, hc, torch.tensor(cot), torch.tensor(wh),
                            torch.tensor(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(dxw.numpy(), _unpad_gates(np.asarray(dxw_j), h),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(dwh.numpy(), _unpad_gates(np.asarray(dwh_j)[:h], h),
                               atol=2e-4, rtol=0)
    # rows past their length: zero output, zero gate gradient
    for row, n in enumerate(LENGTHS):
        assert not out[n:, row].any() and not dxw[n:, row].any()


@pytest.mark.parametrize("h", [16, 100])
def test_autograd_matches_lstm_scan_grad(h):
    x, wx, wh, b, lengths, cot = _inputs(h, seed=7 + h)
    t = x.shape[0]
    mask = (jnp.arange(t)[:, None] < jnp.asarray(lengths)[None, :]).astype(jnp.float32)[..., None]

    def loss_scan(x_, wx_, wh_, b_):
        hs = _lstm_scan({"wx": wx_, "wh": wh_, "b": b_}, x_ @ wx_ + b_, mask)
        return jnp.sum(hs * jnp.asarray(cot))

    want = jax.grad(loss_scan, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, wx, wh, b)))
    tx, twx, twh, tb = (torch.tensor(a, requires_grad=True) for a in (x, wx, wh, b))
    hs = tlg.lstm_layer_ad(tx @ twx + tb, twh, torch.tensor(lengths))
    (hs * torch.tensor(cot)).sum().backward()
    for got, ref, name in zip((tx, twx, twh, tb), want, ("x", "wx", "wh", "b")):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def test_gradcheck_float64():
    rng = np.random.RandomState(3)
    t, b, h = 5, 3, 4
    xw = torch.tensor(rng.randn(t, b, 4 * h), dtype=torch.float64, requires_grad=True)
    wh = torch.tensor(rng.randn(h, 4 * h) * 0.5, dtype=torch.float64, requires_grad=True)
    lengths = torch.tensor([5, 2, 0], dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda a, w: tlg.lstm_layer_ad(a, w, lengths), (xw, wh))


def test_wrapper_rejects_bad_inputs():
    xw = torch.zeros(3, 2, 8)
    with pytest.raises(ValueError):
        tlg.lstm_fwd_residuals(xw, torch.zeros(2, 8), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        tlg.lstm_fwd_residuals(xw.transpose(0, 1).contiguous().transpose(0, 1),
                               torch.zeros(2, 8), torch.zeros(2, dtype=torch.int32))
    before = dict(tlg.launches)
    tlg.lstm_fwd_residuals(xw, torch.zeros(2, 8), torch.zeros(2, dtype=torch.int32))
    assert tlg.launches == before  # the plain version is not a launch


# The forward kernel's geometry is computed in Python (fwd_geometry) and handed
# to the launcher: a cluster of 1, 2, 4 or 8 blocks owns 8 batch rows, each block
# holding the gate columns of ceil(H / cluster) hidden units in shared memory.
GEOMETRY_CASES = [(300, 128), (400, 128), (1, 128), (300, 100), (300, 256), (2500, 128)]


@pytest.mark.parametrize("bsz,h_dim", GEOMETRY_CASES)
def test_fwd_geometry_fits_the_card(bsz, h_dim):
    cluster, rows, smem = tlg.fwd_geometry(bsz, h_dim)
    assert cluster in (1, 2, 4, 8) and rows == tlg.FWD_ROWS == 8
    assert smem == tlg.fwd_smem_bytes(h_dim, cluster) <= 232448 == tlg.MAX_SHARED_BYTES
    hs = -(-h_dim // cluster)
    # the slices cover every hidden unit; only the last may be ragged
    assert (cluster - 1) * hs < h_dim <= cluster * hs
    assert 4 * hs <= 512  # one thread per gate column of a slice
    # the slice of wh alone is most of the block's shared memory
    assert smem > 4 * h_dim * 4 * hs
    tiles = -(-bsz // rows)
    if (bsz, h_dim) in ((300, 128), (400, 128)):
        assert cluster == 2 and tiles * cluster <= 132  # one wave of an H100's SMs


def test_fwd_geometry_prefers_one_wave_and_rejects_what_cannot_fit():
    # H = 128 does not fit one block: 128 x 512 float32 is 256 KB
    assert tlg.fwd_smem_bytes(128, 1) > tlg.MAX_SHARED_BYTES
    # on a card with few SMs the same shape needs more waves but stays valid
    cluster, _, smem = tlg.fwd_geometry(300, 128, sm_count=16)
    assert cluster in (2, 4, 8) and smem <= tlg.MAX_SHARED_BYTES
    # small widths fit one block; a second wave costs more than a wider slice
    for h_dim in (7, 16, 64):
        cluster, _, _ = tlg.fwd_geometry(2000, h_dim)
        assert -(-h_dim // cluster) * cluster >= h_dim
    with pytest.raises(ValueError):
        tlg.fwd_geometry(8, 2048)


# The backward kernel's geometry (cluster_geometry("bwd", ...)): a cluster of 1,
# 2, 4 or 8 blocks owns 1..16 batch rows of one direction, each block holding
# wh^T's columns of ceil(H / cluster) <= 64 hidden units and running 256 threads.
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("h_dim", [16, 100, 128, 256])
@pytest.mark.parametrize("bsz", [1, 300, 301, 400])
def test_bwd_geometry_fits_the_card(bsz, h_dim, dirs):
    cluster, rows, smem = tlg.cluster_geometry("bwd", bsz, h_dim, dirs)
    assert cluster in (1, 2, 4, 8) and 1 <= rows <= tlg.MAX_ROWS
    assert smem == tlg.bwd_smem_bytes(h_dim, cluster, rows) <= tlg.MAX_SHARED_BYTES
    hs = -(-h_dim // cluster)
    assert (cluster - 1) * hs < h_dim <= cluster * hs  # every unit; only the last slice ragged
    assert 4 * hs <= 256 and rows * hs <= 4 * 256  # a thread per (gate, unit); 4 elements a thread
    tiles = -(-bsz // rows)
    assert (tiles - 1) * rows < bsz <= tiles * rows  # every row, no empty tile
    if h_dim == 128 and bsz >= 300:
        assert cluster == 2 and tiles * dirs * cluster <= 132  # one wave of an H100's SMs


# Past H = 256 (up to the kernels' 512): where no cluster of at most 8 blocks
# holds a block's slice of wh (wh^T), the geometry takes the kernels'
# device-memory variant, whose shared memory holds no weights.
WIDE = [257, 384, 512]


@pytest.mark.parametrize("h_dim", WIDE)
@pytest.mark.parametrize("bsz", [1, 301, 400])
def test_wide_fwd_geometry_fits_the_card(bsz, h_dim):
    cluster, rows, smem = tlg.fwd_geometry(bsz, h_dim)
    resident = tlg.weights_resident("fwd", h_dim, cluster, rows, smem)
    assert cluster in (1, 2, 4, 8) and rows == 8
    assert smem == tlg.fwd_smem_bytes(h_dim, cluster, resident) <= tlg.MAX_SHARED_BYTES
    hs = -(-h_dim // cluster)
    assert (cluster - 1) * hs < h_dim <= cluster * hs and 4 * hs <= 512
    assert resident == (h_dim == 257)  # 257: 8 blocks of 167 KB; 384: 238 KB a slice


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("h_dim", WIDE)
@pytest.mark.parametrize("bsz", [1, 301, 400])
def test_wide_bwd_geometry_fits_the_card(bsz, h_dim, dirs):
    cluster, rows, smem = tlg.cluster_geometry("bwd", bsz, h_dim, dirs)
    resident = tlg.weights_resident("bwd", h_dim, cluster, rows, smem)
    assert cluster in (1, 2, 4, 8) and 1 <= rows <= tlg.MAX_ROWS
    assert smem == tlg.bwd_smem_bytes(h_dim, cluster, rows, resident) <= tlg.MAX_SHARED_BYTES
    hs = -(-h_dim // cluster)
    assert (cluster - 1) * hs < h_dim <= cluster * hs
    assert 4 * hs <= 256 and rows * hs <= 4 * 256
    tiles = -(-bsz // rows)
    assert (tiles - 1) * rows < bsz <= tiles * rows
    assert resident == (tlg.bwd_smem_bytes(h_dim, cluster, rows) <= tlg.MAX_SHARED_BYTES)
    if h_dim >= 384:
        assert not resident  # no cluster of 8 holds 4 x 384 x 48 floats a block


def test_limit_past_512_names_the_kernel():
    for kind, name in (("infer", "lstm_infer_kernel"), ("bwd", "lstm_bwd_kernel")):
        with pytest.raises(ValueError, match=name):
            tlg.cluster_geometry(kind, 64, 513)
    with pytest.raises(ValueError, match="512"):
        tlg._cuda_shape_ok("lstm_bwd", 3, 2, 513)


def _kernel_slice(wh, cluster, rank, transposed):
    """The block's slice as the resident kernels load it into shared memory
    (csrc/lstm_grad.cu, csrc/bilstm.cu), zero where k or the unit is padding."""
    h_dim = wh.shape[0]
    hs, h4 = -(-h_dim // cluster), -(-h_dim // 4) * 4
    u0 = rank * hs
    out = np.zeros((4, h4, hs) if transposed else (h4, 4 * hs), np.float32)
    wh_t = wh.T
    for k in range(h_dim):
        for gate in range(4):
            for u in range(min(hs, h_dim - u0)):
                if transposed:  # ws[(q * HP + k) * HS + u] = wh_t[(q * H + k) * H + u0 + u]
                    out[gate, k, u] = wh_t[gate * h_dim + k, u0 + u]
                else:  # ws[k * LC + gate * HS + u] = wh[k * G + gate * H + u0 + u]
                    out[k, gate * hs + u] = wh[k, gate * h_dim + u0 + u]
    return out


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("h_dim,cluster", [(7, 4), (10, 2), (21, 8)])
def test_wh_slices_lie_as_in_shared_memory(h_dim, cluster, transposed):
    wh = np.random.RandomState(h_dim).randn(h_dim, 4 * h_dim).astype(np.float32)
    got = tlg.wh_slices(torch.tensor(wh), cluster, transposed).numpy()
    for rank in range(cluster):
        want = _kernel_slice(wh, cluster, rank, transposed)
        np.testing.assert_array_equal(got[rank].reshape(want.shape), want)
