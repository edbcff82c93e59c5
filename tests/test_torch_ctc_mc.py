"""The port's experimental CTC decoders (chiron_tpu_torch/ops/ctc_mc.py)
against the JAX package's (chiron_tpu/ops/ctc_mc.py) on the CPU.

No torch generator draws the paths ``jax.random.categorical`` draws, so
parity is shown in three parts: (a) on the SAME sampled paths the collapse,
the modes and the quality scores are exact; (b) the sampler's class
frequencies over S*B*T draws match the softmax within 5 binomial standard
deviations; (c) the decoded strings equal the JAX package's on peaked
logits, where every sample agrees, and on DNA_default's logits of a seeded
batch wherever JAX's top path holds at least 60% of the samples.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import synth_read

import chiron_tpu.ops.ctc_mc as jmc
from chiron_tpu_torch import config as tconfig
from chiron_tpu_torch.io.signal import normalize_signal, window_signal
from chiron_tpu_torch.ops import ctc_mc as tmc
from chiron_tpu_torch.params import from_jax_params
from chiron_tpu_torch.train.checkpoint import restore_latest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DNA_DEFAULT = os.path.join(REPO, "chiron_tpu", "model", "DNA_default")
MIN_TOP_SHARE = 0.6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: several test workers' torch
    thread pools competing for the cores made its CPU model runs ~20x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(rng, s, b, t, distinct=6):
    """Sampled-path stand-ins [S, B, T]: per window a few distinct paths
    drawn with unequal weights, so modes and runner-ups tie sometimes."""
    out = np.empty((s, b, t), np.int32)
    for i in range(b):
        pool = rng.randint(0, 5, (distinct, t))
        pool[:, rng.rand(t) < 0.4] = 4  # blank-heavy, as CTC posteriors are
        w = rng.rand(distinct) ** 2
        out[:, i, :] = pool[rng.choice(distinct, s, p=w / w.sum())]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_paths_collapse_modes_and_qualities_exact(seed):
    rng = np.random.RandomState(seed)
    s, b, t = 40, 7, 30
    paths = _paths(rng, s, b, t)
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    flat, flat_lens = paths.reshape(s * b, t), np.tile(lens, s)
    jd, jl = jmc._collapse_paths(jnp.asarray(flat), jnp.asarray(flat_lens), 4)
    td, tl = tmc._collapse_paths(torch.from_numpy(flat), torch.from_numpy(flat_lens), 4)
    assert np.array_equal(np.asarray(jd), td.numpy()) and np.array_equal(np.asarray(jl),
                                                                         tl.numpy())
    decoded = td.numpy().reshape(s, b, t)
    want_strings, want_scores = [], []
    for i in range(b):
        jbest, jcount, jqs = jmc._mode_and_qs(decoded[:, i, :], s)
        tbest, tcount, tqs = tmc._mode_and_qs(decoded[:, i, :], s)
        assert np.array_equal(jbest, tbest) and jcount == tcount and jqs == tqs
        n = int((jbest >= 0).sum())
        want_strings.append("".join("ACGT"[x] for x in jbest[:n]))
        want_scores.append(jqs)
    assert tmc.modes_to_strings(decoded, s) == (want_strings, want_scores)


def test_all_samples_agree_gives_the_quality_ceiling():
    decoded = np.tile(np.asarray([[0, 2, -1]], np.int32), (10, 1))
    assert tmc._mode_and_qs(decoded, 10)[1:] == jmc._mode_and_qs(decoded, 10)[1:] == (10, 10.0)


@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_sampled_class_frequencies_match_the_softmax(scale):
    rng = np.random.RandomState(3)
    logits = torch.from_numpy((rng.randn(16, 50, 5) * scale).astype(np.float32))
    s = 200
    gen = torch.Generator().manual_seed(11)
    paths = tmc.sample_paths(logits, gen, s)
    assert paths.shape == (s, 16, 50) and paths.dtype == torch.int32
    p = torch.softmax(logits.double(), -1).reshape(-1, 5)
    counts = torch.bincount(paths.reshape(-1).long(), minlength=5).double()
    mean = s * p.sum(0)
    sd = torch.sqrt(s * (p * (1 - p)).sum(0))
    assert torch.all((counts - mean).abs() <= 5 * sd), (counts, mean, sd)


def _peaked(rng, b, t, margin=20.0):
    """Logits whose top class leads every other by >= margin at every frame."""
    logits = rng.randn(b, t, 5).astype(np.float32)
    top = rng.randint(0, 5, (b, t))
    top[:, rng.rand(t) < 0.5] = 4
    np.put_along_axis(logits, top[..., None], logits.max(-1, keepdims=True) + margin, -1)
    return logits


def test_mc_decode_and_sections_equal_jax_on_peaked_logits():
    rng = np.random.RandomState(4)
    logits = _peaked(rng, 6, 80)
    lens = np.asarray([80, 70, 60, 50, 40, 1], np.int32)
    got = tmc.mc_decode(torch.from_numpy(logits), torch.from_numpy(lens), sample_n=50)
    want = jmc.mc_decode(logits, lens, sample_n=50)
    assert got == want and all(q == 10.0 * np.log10(50) for q in got[1])
    assert tmc.section_decoding(logits, sample_n=50, device="cpu") == \
        jmc.section_decoding(logits, sample_n=50)
    assert tmc.mc_decode(logits[0], None, sample_n=50, device="cpu") == \
        jmc.mc_decode(logits[0], None, sample_n=50)


def test_section_decoding_all_blank_and_sections_equal_jax():
    blank = np.full((3, 20, 5), -5.0, np.float32)
    blank[..., 4] = 5.0
    assert tmc.section_decoding(blank, device="cpu") == jmc.section_decoding(blank) == [""] * 3
    logits = _peaked(np.random.RandomState(5), 3, 60)
    got = tmc.section_spans(logits, 0.6)
    probs = np.exp(logits - logits.max(2, keepdims=True))
    probs /= probs.sum(2, keepdims=True)
    assert got is not None and got[0].shape[0] == len(got[2])
    for k, (i, start, stop) in enumerate(got[2]):
        assert np.all(probs[i, start:stop, 4] < 0.6)
        assert np.array_equal(got[0][k, : stop - start], logits[i, start:stop])


@pytest.fixture(scope="module")
def dna_default_logits():
    """DNA_default's logits of a seeded batch of 16 dna-pre windows (CPU), on
    chip_smoke's squiggles (mean dwell 9 samples, the DNA_default regime)."""
    config = tconfig.read_config(os.path.join(DNA_DEFAULT, "model.json"))
    model = from_jax_params(restore_latest(DNA_DEFAULT)[0], config, "cpu")
    rng = np.random.RandomState(6)
    n = 16 * 390 + 10
    dwell = np.maximum(rng.geometric(1 / 9.0, n // 5), 2)
    sig = np.repeat(rng.normal(500, 60, n // 5), dwell)[:n] + rng.normal(0, 12, n)
    w, ln = window_signal(normalize_signal(sig.astype(np.int64), 1), 0, 390, 400)
    with torch.no_grad():
        logits = model(torch.from_numpy(w[:16]), torch.from_numpy(ln[:16]))
    return logits.numpy(), ln[:16].astype(np.int32)


def _held(batch, lens, s):
    """Windows of a batch where the JAX package's top path (its default key)
    holds at least MIN_TOP_SHARE of the samples."""
    jd, _ = jmc._sample_and_collapse(jnp.asarray(batch), jnp.asarray(lens),
                                     jax.random.PRNGKey(0), s)
    jd = np.asarray(jd)
    return [i for i in range(len(lens)) if jmc._mode_and_qs(jd[:, i, :], s)[1] / s
            >= MIN_TOP_SHARE]


@pytest.mark.parametrize("batch", ["windows", "sections"])
def test_mc_decode_equals_jax_where_its_top_path_holds_60_percent(dna_default_logits, batch):
    """On whole 400-frame windows every sampled path differs (no window is
    held); on the section batch section_decoding builds from the same
    logits most sections are held."""
    logits, lens = dna_default_logits
    if batch == "sections":
        logits, lens, _ = tmc.section_spans(logits, 0.6)
    s = 300
    got, _ = tmc.mc_decode(torch.from_numpy(logits), torch.from_numpy(lens), sample_n=s)
    want, _ = jmc.mc_decode(logits, lens, sample_n=s)
    held = _held(logits, lens, s)
    if batch == "sections":
        assert len(held) >= len(lens) // 2, (len(held), len(lens))
    assert [got[i] for i in held] == [want[i] for i in held]


def test_section_decoding_joins_the_mc_strings_of_its_sections(dna_default_logits):
    """section_decoding = each window's section strings (one mc_decode over
    the section batch) joined in order; the section strings are the ones
    held to the JAX package's above."""
    logits, _ = dna_default_logits
    got = tmc.section_decoding(torch.from_numpy(logits), sample_n=300)
    batch, lens, spans = tmc.section_spans(logits, 0.6)
    strings, _ = tmc.mc_decode(torch.from_numpy(batch), torch.from_numpy(lens), sample_n=300)
    want = [""] * len(logits)
    for k, (i, _, _) in enumerate(spans):
        want[i] += strings[k]
    assert got == want and all(got)


def test_a_fixed_generator_gives_the_same_output_twice(dna_default_logits):
    logits, lens = dna_default_logits
    runs = [tmc.mc_decode(torch.from_numpy(logits), torch.from_numpy(lens),
                          torch.Generator().manual_seed(7), sample_n=100) for _ in range(2)]
    assert runs[0] == runs[1]
    assert tmc.mc_decode(torch.from_numpy(logits), torch.from_numpy(lens), sample_n=100) == \
        tmc.mc_decode(torch.from_numpy(logits), torch.from_numpy(lens),
                      torch.Generator().manual_seed(0), sample_n=100)


@pytest.mark.parametrize("seed,t", [(0, 5), (1, 6), (2, 7), (3, 1)])
def test_best_path_decode_exact(seed, t):
    logits = (np.random.RandomState(seed).randn(t, 5) * 2).astype(np.float32)
    assert tmc.best_path_decode(logits) == jmc.best_path_decode(logits)
    assert tmc.best_path_decode(torch.from_numpy(logits)) == jmc.best_path_decode(logits)


def test_best_path_decode_guard_raises_as_jax():
    logits = np.zeros((10, 5), np.float32)
    with pytest.raises(ValueError) as got:
        tmc.best_path_decode(logits)
    with pytest.raises(ValueError) as want:
        jmc.best_path_decode(logits)
    assert str(got.value) == str(want.value)
    logits = (np.random.RandomState(8).randn(8, 5) * 2).astype(np.float32)
    with pytest.raises(ValueError):
        tmc.best_path_decode(logits, max_frames=7)
    assert tmc.best_path_decode(logits, max_frames=8) == \
        jmc.best_path_decode(logits, max_frames=8)


def test_decoders_exported_from_ops_as_in_jax():
    import chiron_tpu.ops as jops
    import chiron_tpu_torch.ops as tops

    for name in ("best_path_decode", "mc_decode", "section_decoding"):
        assert getattr(tops, name) is getattr(tmc, name) and callable(getattr(jops, name))


def test_array_logits_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError):
        tmc.mc_decode(np.zeros((1, 4, 5), np.float32), None)
