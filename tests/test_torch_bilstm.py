"""The port's fused BiLSTM layer (chiron_tpu_torch/ops/bilstm.py) against the
JAX package: the Pallas kernel in interpret mode and the XLA scan
(rnn._lstm_scan) with reverse_sequence.

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

