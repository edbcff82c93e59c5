"""The port's fused BiLSTM layer (chiron_tpu_torch/ops/bilstm.py) and its
single LSTM direction (ops/lstm.py) against the JAX package: the Pallas
kernels in interpret mode and the XLA scan (rnn._lstm_scan) with
reverse_sequence.

Inputs are made with numpy from a seed. Tolerance atol 1e-5: the h @ wh
products sum in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.models import rnn as jrnn
from chiron_tpu.ops.pallas import lstm as jlstm
from chiron_tpu_torch.models import rnn as trnn
from chiron_tpu_torch.ops import bilstm as tbl
from chiron_tpu_torch.ops import lstm as tlstm
from chiron_tpu_torch.ops import lstm_grad as tlg

ATOL = 1e-5


def _inputs(seed, t, b, h):
    rng = np.random.RandomState(seed)
    xw_f = rng.randn(t, b, 4 * h).astype(np.float32)
    xw_b = rng.randn(t, b, 4 * h).astype(np.float32)
    wh_f = (rng.randn(h, 4 * h) * 0.3).astype(np.float32)
    wh_b = (rng.randn(h, 4 * h) * 0.3).astype(np.float32)
    lengths = rng.randint(1, t, size=b).astype(np.int32)
    lengths[0], lengths[-1] = 0, t  # empty and full rows
    return xw_f, xw_b, wh_f, wh_b, lengths


def _port(xw_f, xw_b, wh_f, wh_b, lengths, device="cpu"):
    t = xw_f.shape[0]
    to = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return tbl.bilstm_layer(to(xw_f), to(xw_b), to(wh_f), to(wh_b), to(lengths),
                            to((t - lengths).astype(np.int32)))


@pytest.mark.parametrize("h,t,b,seed", [(16, 12, 5, 0), (16, 20, 8, 1), (100, 9, 4, 2)])
def test_bilstm_matches_pallas_interpret(h, t, b, seed):
    xw_f, xw_b, wh_f, wh_b, lengths = _inputs(seed, t, b, h)
    # the Pallas kernel takes weights padded to 128 lanes (pad_lstm_weights)
    zb = np.zeros(4 * h, np.float32)
    pads = [jlstm.pad_lstm_weights(jnp.zeros((1, 4 * h)), jnp.asarray(wh), zb, h)[1]
            for wh in (wh_f, wh_b)]
    jf, jb = jlstm.bilstm_layer_pallas(
        jlstm.pad_gate_cols(jnp.asarray(xw_f), h), jlstm.pad_gate_cols(jnp.asarray(xw_b), h),
        pads[0], pads[1], jnp.asarray(lengths), jnp.asarray(t - lengths), hidden=h,
        interpret=True)
    tf, tb = _port(xw_f, xw_b, wh_f, wh_b, lengths)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,t,b,seed", [(16, 12, 5, 3), (100, 10, 4, 4)])
def test_bilstm_matches_xla_scan_with_reverse_sequence(h, t, b, seed):
    """Flip + start offset == reverse_sequence + XLA scan + reverse back."""
    xw_f, xw_b, wh_f, wh_b, lengths = _inputs(seed, t, b, h)
    mask = jnp.asarray((np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)[..., None])
    lens = jnp.asarray(lengths)
    jf = jrnn._lstm_scan({"wh": jnp.asarray(wh_f)}, jnp.asarray(xw_f), mask)
    jb = jrnn.reverse_sequence(
        jrnn._lstm_scan({"wh": jnp.asarray(wh_b)},
                        jrnn.reverse_sequence(jnp.asarray(xw_b), lens), mask), lens)
    # the port's backward direction reads the time-flipped sequence
    tf, tb = _port(xw_f, np.ascontiguousarray(xw_b[::-1]), wh_f, wh_b, lengths)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL, rtol=0)
    np.testing.assert_allclose(torch.flip(tb, dims=(0,)).numpy(), np.asarray(jb),
                               atol=ATOL, rtol=0)


def test_reverse_sequence_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(7, 4, 3).astype(np.float32)
    lengths = np.array([0, 7, 3, 1], np.int32)
    np.testing.assert_array_equal(
        trnn.reverse_sequence(torch.tensor(x), torch.tensor(lengths)).numpy(),
        np.asarray(jrnn.reverse_sequence(jnp.asarray(x), jnp.asarray(lengths))))


def test_outputs_zero_outside_window():
    xw_f, xw_b, wh_f, wh_b, lengths = _inputs(6, 10, 6, 16)
    tf, tb = _port(xw_f, xw_b, wh_f, wh_b, lengths)
    t = np.arange(10)[:, None]
    assert (tf.numpy()[(t >= lengths[None, :])] == 0).all()
    assert (tb.numpy()[(t < (10 - lengths)[None, :])] == 0).all()


def test_birnn_stack_and_head_match_jax():
    """Two BiLSTM layers + head (flip mode in the port, XLA scan in JAX)."""
    import jax

    rng = np.random.RandomState(7)
    params = jrnn.init_rnn_layers(jax.random.PRNGKey(0), 8, 16, 2, 5, "LSTM", "normal")
    x = rng.randn(4, 11, 8).astype(np.float32)
    lengths = np.array([11, 0, 6, 3], np.int32)
    want = jrnn.rnn_layers(params, jnp.asarray(x), jnp.asarray(lengths))
    tparams = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), params)
    got = trnn.rnn_layers(tparams, torch.tensor(x), torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_wrapper_rejects_bad_inputs():
    xw_f, xw_b, wh_f, wh_b, lengths = _inputs(0, 6, 3, 16)
    with pytest.raises(ValueError):
        _port(xw_f, xw_b, wh_f, wh_b, lengths.astype(np.int64))
    with pytest.raises(ValueError):
        _port(xw_f, xw_b[:, :2], wh_f, wh_b, lengths)


# ---- the single direction (ops/lstm.py), tolerance 2e-5 as the JAX tests' ----

@pytest.mark.parametrize("h", [100, 128])
@pytest.mark.parametrize("with_starts", [False, True])
def test_lstm_layer_matches_pallas_interpret(h, with_starts):
    t, b = 12, 16
    xw, _, wh, _, lengths = _inputs(10 + h, t, b, h)
    lengths[4:8] = 5
    starts = (t - lengths).astype(np.int32) if with_starts else None
    wh_p = jlstm.pad_lstm_weights(jnp.zeros((1, 4 * h)), jnp.asarray(wh),
                                  np.zeros(4 * h, np.float32), h)[1]
    want = jlstm.lstm_layer_pallas(
        jlstm.pad_gate_cols(jnp.asarray(xw), h), wh_p, jnp.asarray(lengths), hidden=h,
        interpret=True, starts=None if starts is None else jnp.asarray(starts))
    got = tlstm.lstm_layer(torch.tensor(xw), torch.tensor(wh), torch.tensor(lengths),
                           None if starts is None else torch.tensor(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("h", [100, 128])
def test_lstm_layer_matches_xla_scan(h):
    t, b = 12, 16
    xw, _, wh, _, lengths = _inputs(20 + h, t, b, h)
    mask = jnp.asarray((np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)[..., None])
    want = jrnn._lstm_scan({"wh": jnp.asarray(wh)}, jnp.asarray(xw), mask)
    got = tlstm.lstm_layer(torch.tensor(xw), torch.tensor(wh), torch.tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_lstm_layer_is_one_direction_of_the_fused_layer():
    t = 10
    xw_f, xw_b, wh_f, wh_b, lengths = _inputs(8, t, 6, 16)
    tf, tb = _port(xw_f, xw_b, wh_f, wh_b, lengths)
    lens = torch.tensor(lengths)
    assert torch.equal(tf, tlstm.lstm_layer(torch.tensor(xw_f), torch.tensor(wh_f), lens))
    assert torch.equal(tb, tlstm.lstm_layer(torch.tensor(xw_b), torch.tensor(wh_b), lens,
                                            torch.tensor((t - lengths).astype(np.int32))))
    with pytest.raises(ValueError):
        tlstm.lstm_layer(torch.tensor(xw_f), torch.tensor(wh_f), lens.to(torch.int64))



# The inference kernel's geometry (lstm_grad.cluster_geometry("infer", ...)),
# shared by bilstm_layer (two directions) and lstm_layer (one): a cluster of 1,
# 2, 4 or 8 blocks owns 1..16 batch rows of one direction, each block holding
# wh's gate columns of ceil(H / cluster) <= 64 hidden units and running 256 threads.
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("h_dim", [16, 100, 128, 256])
@pytest.mark.parametrize("bsz", [1, 300, 301, 400])
def test_inference_geometry_fits_the_card(bsz, h_dim, dirs):
    cluster, rows, smem = tlg.cluster_geometry("infer", bsz, h_dim, dirs)
    assert cluster in (1, 2, 4, 8) and 1 <= rows <= tlg.MAX_ROWS
    assert smem == tlg.infer_smem_bytes(h_dim, cluster, rows) <= tlg.MAX_SHARED_BYTES
    hs = -(-h_dim // cluster)
    assert (cluster - 1) * hs < h_dim <= cluster * hs  # every unit; only the last slice ragged
    assert 4 * hs <= 256 and rows * hs <= 4 * 256  # a thread per gate column; 4 elements a thread
    tiles = -(-bsz // rows)
    assert (tiles - 1) * rows < bsz <= tiles * rows  # every row, no empty tile
    if h_dim == 128 and bsz >= 300:
        # one wave of an H100's SMs: at B = 400 both directions take 13 rows,
        # where 8 would need 200 blocks, two waves
        assert cluster == 2 and tiles * dirs * cluster <= 132
        assert (bsz, dirs) != (400, 2) or rows == 13


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("h_dim", [257, 384, 512])
@pytest.mark.parametrize("bsz", [1, 301, 400])
def test_wide_inference_geometry_fits_the_card(bsz, h_dim, dirs):
    """Past H = 256 the inference kernel reads wh from device memory where no
    cluster holds it (``weight_args`` lays it out), at most 64 units a block."""
    cluster, rows, smem = tlg.cluster_geometry("infer", bsz, h_dim, dirs)
    resident = tlg.weights_resident("infer", h_dim, cluster, rows, smem)
    assert cluster in (1, 2, 4, 8) and 1 <= rows <= tlg.MAX_ROWS
    assert smem == tlg.infer_smem_bytes(h_dim, cluster, rows, resident) <= tlg.MAX_SHARED_BYTES
    hs = -(-h_dim // cluster)
    assert (cluster - 1) * hs < h_dim <= cluster * hs
    assert 4 * hs <= 256 and rows * hs <= 4 * 256
    tiles = -(-bsz // rows)
    assert (tiles - 1) * rows < bsz <= tiles * rows
    assert h_dim == 257 or not resident
    whs, wh_global = tbl.weight_args([torch.zeros(h_dim, 4 * h_dim)], h_dim, (cluster, rows, smem))
    assert wh_global == int(not resident)
    h4 = -(-h_dim // 4) * 4
    assert tuple(whs[0].shape) == ((h_dim, 4 * h_dim) if resident else (cluster, h4, 4, hs))


def test_apply_model_dna_default_at_hidden_384_matches_jax():
    """DNA_default's model.json (dna_model1, 3 BiLSTM layers) at hidden_num
    384, seeded JAX weights: the port on the CPU against the JAX package,
    within 5e-4 of max |logit| (the batch-stat convs' sum order)."""
    import os

    import jax

    from chiron_tpu.models import model as jmodel
    from chiron_tpu_torch import config as tconfig
    from chiron_tpu_torch.params import from_jax_params

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = tconfig.read_config(os.path.join(repo, "chiron_tpu", "model", "DNA_default",
                                              "model.json"))
    config = {**config, "rnn": {**config["rnn"], "hidden_num": 384}}
    params = jmodel.init_model(jax.random.PRNGKey(6), config)
    seg = 40
    x = np.random.RandomState(6).randn(3, seg).astype(np.float32)
    seq_len = np.array([seg, seg - 7, 3], np.int32)
    want = np.asarray(jmodel.apply_model(params, config, jnp.asarray(x), jnp.asarray(seq_len)))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), config, "cpu")
    got = model(torch.tensor(x), torch.tensor(seq_len)).numpy()
    assert got.shape == want.shape and want.shape[-1] == 5
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max(), rtol=0)
