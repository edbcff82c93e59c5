"""The port's CTC decoders (chiron_tpu_torch/ops/{beam,ctc_greedy}.py)
against the JAX package: the Pallas beam kernel in interpret mode, its XLA
twin ctc_beam.beam_search_decode, and ctc_greedy.

Cases are those of tests/test_pallas_beam.py. Decodes and lengths must be
exactly equal; log_prob within rtol/atol 1e-4 (exp/log1p of two libraries).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.ops import ctc_greedy as jgreedy
from chiron_tpu.ops.ctc_beam import beam_search_decode as jax_beam
from chiron_tpu.ops.pallas.beam import beam_search_pallas
from chiron_tpu_torch.ops import beam as tbeam
from chiron_tpu_torch.ops import ctc_greedy as tgreedy

TOL = dict(rtol=1e-4, atol=1e-4)


def _random_case(seed, b, t, nclass, scale, lens):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, nclass) * scale).astype(np.float32), np.asarray(lens, np.int32)


def _peaky_case(seed, b, t, lens):
    rng = np.random.RandomState(seed)
    classes = rng.randint(0, 5, size=(b, t))
    logits = np.full((b, t, 5), -20.0, np.float32)
    for i in range(b):
        for j in range(t):
            logits[i, j, classes[i, j]] = 20.0
    return logits, np.asarray(lens, np.int32)


CASES = {
    "seed0": (lambda: _random_case(0, 5, 10, 5, 2, [10, 10, 7, 1, 0]), 8, 0.0),
    "seed1": (lambda: _random_case(1, 5, 10, 5, 2, [10, 10, 7, 1, 0]), 8, 0.0),
    "seed2": (lambda: _random_case(2, 5, 10, 5, 2, [10, 10, 7, 1, 0]), 8, 0.0),
    "peaky": (lambda: _peaky_case(3, 3, 16, [16, 16, 9]), 4, 0.0),
    "wide50": (lambda: _random_case(7, 4, 12, 5, 1.5, [12, 12, 5, 0]), 50, 0.0),
    "six_class0": (lambda: _random_case(0, 5, 12, 6, 2, [12, 12, 8, 1, 0]), 8, 0.0),
    "six_class5": (lambda: _random_case(5, 5, 12, 6, 2, [12, 12, 8, 1, 0]), 8, 0.0),
    "bonus0.7": (lambda: _random_case(7, 4, 12, 5, 2, [12, 12, 8, 3]), 8, 0.7),
    "bonus1.5": (lambda: _random_case(7, 4, 12, 5, 2, [12, 12, 8, 3]), 8, 1.5),
    "w30_bonus0.6": (lambda: _random_case(11, 4, 24, 5, 2, [24, 20, 1, 0]), 30, 0.6),
}


def _port_decode(logits, lens, w, bonus, device="cpu"):
    d, n, p = tbeam.beam_search_decode(torch.tensor(logits, device=device),
                                       torch.tensor(lens, device=device), beam_width=w,
                                       length_bonus=bonus)
    return d.cpu().numpy(), n.cpu().numpy(), p.cpu().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_beam_matches_xla_twin(name):
    make, w, bonus = CASES[name]
    logits, lens = make()
    dx, lx, px = jax_beam(jnp.asarray(logits), jnp.asarray(lens), beam_width=w,
                          length_bonus=bonus)
    dt, lt, pt = _port_decode(logits, lens, w, bonus)
    np.testing.assert_array_equal(lt, np.asarray(lx))
    np.testing.assert_array_equal(dt, np.asarray(dx))
    np.testing.assert_allclose(pt, np.asarray(px), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_beam_matches_pallas_interpret(name):
    make, w, bonus = CASES[name]
    logits, lens = make()
    dx, lx, px = beam_search_pallas(jnp.asarray(logits), jnp.asarray(lens), beam_width=w,
                                    batch_tile=8, interpret=True, length_bonus=bonus)
    dt, lt, pt = _port_decode(logits, lens, w, bonus)
    np.testing.assert_array_equal(lt, np.asarray(lx))
    np.testing.assert_array_equal(dt, np.asarray(dx))
    np.testing.assert_allclose(pt, np.asarray(px), **TOL)


def test_length_bonus_does_not_shorten():
    logits, lens = _random_case(7, 4, 12, 5, 2, [12, 12, 8, 3])
    _, l0, _ = _port_decode(logits, lens, 8, 0.0)
    _, l1, _ = _port_decode(logits, lens, 8, 1.5)
    assert (l1 >= l0).all()


def test_hash_mul_wraps_like_uint32():
    h = np.array([0, 1, 7919 * 29 + 3, 2 ** 32 - 1, 123456789], np.uint64)
    want = (h * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    got = tbeam._hash_mul(torch.tensor(h.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


def test_traceback_follows_parent_chain():
    # W = 2, T = 3: slot 1 at t=2 came from slot 0 at t=1 (char 2), which
    # came from slot 1 at t=0 (char 0), which stayed (char -1 record)
    w = 2
    trace = torch.tensor([[[0 * w + 0, 1 * w + 1],
                           [3 * w + 1, 0 * w + 0],
                           [0 * w + 0, 3 * w + 0]]], dtype=torch.int32)
    chars = tbeam.beam_traceback(trace, torch.tensor([1], dtype=torch.int32))
    np.testing.assert_array_equal(chars.numpy(), [[0, 2, 2]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_matches_jax(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(6, 15, 5).astype(np.float32)
    logits[0, :, 2] = 5.0  # long repeat run collapses to one label
    lens = np.array([15, 15, 9, 1, 0, 15], np.int32)
    dj, lj, sj = jgreedy.greedy_decode(jnp.asarray(logits), jnp.asarray(lens))
    dt, lt, st = tgreedy.greedy_decode(torch.tensor(logits), torch.tensor(lens))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-5)


def test_compact_labels_matches_jax():
    rng = np.random.RandomState(4)
    classes = rng.randint(0, 5, size=(5, 13)).astype(np.int32)
    keep = rng.rand(5, 13) > 0.5
    keep[0] = False
    dj, lj = jgreedy.compact_labels(jnp.asarray(classes), jnp.asarray(keep))
    dt, lt = tgreedy.compact_labels(torch.tensor(classes), torch.tensor(keep))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))



# Beams wider than the Pallas kernel's 64 and alphabets past 8 classes: the port
# takes any width on the CPU (and the block kernel on the card), the JAX package
# sends them to its XLA twin. Decodes exact.
@pytest.mark.parametrize("bonus", [0.0, 0.6])
@pytest.mark.parametrize("nclass", [5, 6, 10])
@pytest.mark.parametrize("w", [65, 80, 128])
def test_wide_beam_matches_xla_twin(w, nclass, bonus):
    logits, lens = _random_case(w + nclass, 3, 12, nclass, 2, [12, 9, 0])
    dx, lx, px = jax_beam(jnp.asarray(logits), jnp.asarray(lens), beam_width=w,
                          length_bonus=bonus)
    dt, lt, pt = _port_decode(logits, lens, w, bonus)
    np.testing.assert_array_equal(lt, np.asarray(lx))
    np.testing.assert_array_equal(dt, np.asarray(dx))
    np.testing.assert_allclose(pt, np.asarray(px), **TOL)


def test_kernel_routes_and_width_limit():
    """W <= 32 with C <= 8 takes the warp kernel; every other width the block
    kernel, whose pool must fit a block's 227 KB: W <= 1,638 at C = 5, 819 at
    C = 10. The CPU path has no limit."""
    assert tbeam.search_route(30, 5) == "warp" and tbeam.search_route(32, 8) == "warp"
    assert tbeam.search_route(33, 5) == "block" and tbeam.search_route(30, 9) == "block"
    assert tbeam.block_smem_bytes(1638, 5) <= tbeam.MAX_SHARED_BYTES
    assert tbeam.search_route(1638, 5) == "block" and tbeam.search_route(1639, 5) == ""
    assert tbeam.search_route(819, 10) == "block" and tbeam.search_route(820, 10) == ""
    assert tbeam.search_route(0, 5) == "" and tbeam.search_route(8, 1) == ""
    logits, lens = _random_case(3, 2, 3, 5, 2, [3, 2])
    d, n, _ = _port_decode(logits, lens, 1700, 0.0)  # any width on the CPU
    assert d.shape == (2, 3) and (n <= np.array([3, 2])).all()
    with pytest.raises(ValueError):
        tbeam.beam_search(torch.zeros(1, 2, 5), torch.zeros(1, dtype=torch.int32), 0)


# A window of a GRU model with random weights that decoded differently on an
# H100 (the kernel on the card's log_softmax) and on the CPU (the plain version
# on the CPU's log_softmax of the same logits): tests/data/beam_near_tie.npz holds
# the card's logits and both log_softmax. The two lp differ by <= 1 ulp; the two
# searches agree for 242 steps, then pick different candidates for the last beam
# slot, which are 1.9e-6 apart (4 ulp at a score of 6.9) while the rounding has
# moved the scores by up to 3.8e-6: a near-tie, not a rule that differs.
def test_near_tie_fixture_is_a_rounding_flip():
    data = np.load(os.path.join(os.path.dirname(__file__), "data", "beam_near_tie.npz"))
    w, bonus = int(data["beam_width"]), float(data["length_bonus"])
    lp_card, lp_cpu = torch.tensor(data["lp_card"]), torch.tensor(data["lp_cpu"])
    lens = torch.tensor(data["seq_len"], dtype=torch.int32)
    assert float((lp_card - lp_cpu).abs().max()) < 1e-6
    div = tbeam.first_divergence(lp_card[0], lp_cpu[0], lens[0], w, bonus)
    assert (div["step"], div["slot"]) == (242, w - 1)
    assert div["margin"] < div["rounding"] < 1e-5
    decodes = []
    for lp in (lp_card, lp_cpu):
        trace, pb, pnb = tbeam.beam_search_plain(lp, lens, w, bonus)
        chars = tbeam.beam_traceback_plain(
            trace, torch.argmax(tbeam._lae(pb, pnb), dim=1).to(torch.int32))
        decodes.append(chars[0][chars[0] >= 0].numpy())
    assert not np.array_equal(*decodes)
    # the plain version on ONE lp tensor is deterministic, so the kernel and it
    # agree there (chip_smoke holds them on the card's lp); JAX's XLA twin and
    # its Pallas kernel in interpret mode (their own log_softmax of the same
    # logits) land on one side of the tie, the card's
    logits, sl = jnp.asarray(data["logits"]), jnp.asarray(data["seq_len"])
    dx, lx, _ = jax_beam(logits, sl, beam_width=w, length_bonus=bonus)
    dp, lp_, _ = beam_search_pallas(logits, sl, beam_width=w, batch_tile=8, interpret=True,
                                    length_bonus=bonus)
    jax_dec = np.asarray(dx)[0][:int(lx[0])]
    np.testing.assert_array_equal(np.asarray(dp)[0][:int(lp_[0])], jax_dec)
    np.testing.assert_array_equal(jax_dec, decodes[0])
