"""Each plain reference of the benchmark against the port, on the CPU at a
tiny size: the model's logits, the beam decode, the assembly and quality
string, the windows and the batches a call packs."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark import harness as H

from benchmark import reads as R
from benchmark import weights
from benchmark.reference import assembly, beam, signal
from benchmark.reference.model import Reference, load_checkpoint

# the cell's configuration, and the bundled DNA_slow (the reference's other front)
DNA_DEFAULT = H.config_file("benchmark/configs/dna_default.json")
DNA_SLOW = {"front": "slow_model1", "stride": 4,
            "model_dir": os.path.join(H.ROOT, "chiron_tpu", "model", "DNA_slow")}

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    cfg = dict(DNA_DEFAULT)
    cfg["model_dir"] = weights.write_model_dir(cfg, str(tmp_path_factory.mktemp("model")))
    return {"DNA_default": cfg, "DNA_slow": DNA_SLOW}


@pytest.fixture(scope="module")
def fast_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    params = {"n_reads": 3, "median_bases": 250, "sigma": 0.3, "min_bases": 100,
              "max_bases": 1000, "sim": {"mean_dwell": 9.0}}
    return d, R.generate(params, 2**31 + 17, str(d))


@pytest.mark.parametrize("name", ["DNA_default", "DNA_slow"])
def test_logits_match_the_port(name, fast_reads, configs):
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.eval.pipeline import load_model

    cfg = configs[name]
    seg = 400 if name == "DNA_default" else 2000
    d, reads = fast_reads
    x, n = signal.load_windows(os.path.join(d, reads[0].name + ".signal"), seg - 10, seg)
    x = np.concatenate([x, x[::-1] * 0.5])[:4]
    n = np.concatenate([n, n[::-1]])[:4]
    t_out = -(-seg // cfg["stride"])
    frames = np.round(n / (seg / t_out)).astype(np.int32)
    model = load_model(cfg["model_dir"], C.read_config(os.path.join(cfg["model_dir"],
                                                                    "model.json")), "cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(x), torch.from_numpy(frames)).numpy()
    ref = Reference(cfg["model_dir"], cfg["front"], cfg["stride"], "cpu")
    with torch.no_grad():
        got = ref.logits(ref.features(torch.from_numpy(x)), torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_fp8_precision_moves_the_logits(configs):
    cfg = configs["DNA_default"]
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 400).astype(np.float32))
    n = torch.full((4,), 400, dtype=torch.int32)
    outs = {}
    for p in ("fp32", "fp8"):
        ref = Reference(cfg["model_dir"], cfg["front"], cfg["stride"], "cpu", p)
        with torch.no_grad():
            outs[p] = ref.logits(ref.features(x), n)
    rel = (outs["fp8"] - outs["fp32"]).abs().max() / outs["fp32"].abs().max()
    assert float(rel) > 1e-2  # e4m3 keeps 3 mantissa bits: several % an operand


def test_beam_matches_the_port():
    from chiron_tpu_torch.ops.beam import beam_search_decode

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(6, 40, 5, generator=g) * 3
    lens = torch.tensor([40, 39, 1, 20, 40, 7], dtype=torch.int32)
    for bonus in (0.0, 0.6):
        want = beam_search_decode(logits, lens, beam_width=30, length_bonus=bonus)
        got = beam.decode(logits, lens, 30, bonus)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_assembly_matches_the_port():
    from chiron_tpu_torch.assembly import consensus_to_bases, qs, simple_assembly_qs

    rng = np.random.RandomState(5)
    truth = "".join("ACGT"[i] for i in rng.randint(0, 4, 600))
    segs = [truth[i:i + 45] for i in range(0, 560, 43)] + [""]
    segs[3] = segs[3][:10] + "A" + segs[3][11:]
    probs = rng.rand(len(segs)) * 3
    keep = [i for i, s in enumerate(segs) if s]
    counts, qsum = simple_assembly_qs([segs[i] for i in keep], np.asarray(probs)[keep, None],
                                      390 / 400, kernel="glue")
    c2, q2 = assembly.assemble(segs, probs)
    assert assembly.consensus(c2) == consensus_to_bases(counts, "ACGT")
    want = np.frombuffer(qs(counts, qsum).encode(), np.uint8) - 33
    assert np.array_equal(assembly.quality_values(c2, q2), want)


def test_windows_and_batches_match_the_port(fast_reads):
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.io.signal import read_signal_for_eval

    d, reads = fast_reads
    for r in reads:
        path = os.path.join(d, r.name + ".signal")
        x, n = signal.load_windows(path, 390, 400)
        x2, n2 = read_signal_for_eval(path, 0, step=390, seg_length=400, normalize=1)
        assert np.array_equal(n, n2)
        assert np.allclose(x, x2, rtol=0, atol=1e-5)
        assert len(x) == signal.window_count(r.samples, 390)

    class Flags:
        start, jump, segment_len, sig_norm, reverse_fast5, batch_size = 0, 390, 400, 1, False, 8

    names = sorted(r.name + ".signal" for r in reads)
    rows = []
    for _, _, widx, fnames, _ in pipeline._batch_stream(str(d), names, Flags, 1.0):
        rows.append([(f[:-len(".signal")] if f else None, int(i)) for f, i in zip(fnames, widx)])
    plan = signal.batch_plan([r.name for r in reads],
                             {r.name: signal.window_count(r.samples, 390) for r in reads}, 8)
    assert len(plan) == len(rows)
    for want, got in zip(rows, plan):
        for (f, i), key in zip(want, got):
            if f is not None:  # the port marks its wrap padding -1; the plan names the copy
                assert (f, i) == key


def test_weights_fold_back_to_the_published_widths(configs):
    """The configuration's weights have every leaf of the bundled checkpoint
    at 3 x 100, the CNN front unchanged; folding an exact Net2WiderNet widening
    (no training after it) gives the narrow model back."""
    from chiron_tpu_torch.tools.net2wide import widen_params
    from chiron_tpu_torch.train.checkpoint import _flatten, _unflatten

    bundled = load_checkpoint(os.path.join(H.ROOT, "chiron_tpu", "model", "DNA_default"))
    flat = load_checkpoint(configs["DNA_default"]["model_dir"])
    assert set(flat) == set(bundled)
    assert flat["rnn/stack/layers/[0]/fw/wh"].shape == (100, 400)
    assert flat["rnn/stack/layers/[1]/bw/wx"].shape == (200, 400)
    assert flat["rnn/head/w_class"].shape == (100, 5)
    for k in bundled:
        if k.startswith("cnn/"):
            assert np.array_equal(flat[k], bundled[k]), k
    wide = _flatten(widen_params(_unflatten(dict(flat)), 100, 128, seed=0, noise=0.0))
    back = weights._narrow({k: np.asarray(v, np.float32) for k, v in wide.items()}, 100, 128, 0)
    for k, v in flat.items():
        assert np.allclose(back[k], v, rtol=1e-6, atol=1e-7), k
