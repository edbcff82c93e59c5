"""The frozen copies give today what the port's originals give: the same
reads for a seed, and the same FLOPs a sample."""

from __future__ import annotations

import os

import numpy as np
import pytest

from benchmark import harness as H
from benchmark import reads as R
from benchmark import weights
from benchmark.frozen import simulate, work
from benchmark.reference.model import weight_shapes

DNA_DEFAULT = H.config_file("benchmark/configs/dna_default.json")
BUNDLED = os.path.join(H.ROOT, "chiron_tpu", "model")


def test_simulator_copy_gives_the_same_reads(tmp_path):
    from chiron_tpu_torch.tools import simulate as port

    model = simulate.KmerModel.load(R.PORE_MODEL)
    pmodel = port.KmerModel.load(R.PORE_MODEL)
    assert np.array_equal(model.means, pmodel.means)
    for cfg_kw in ({}, {"mean_dwell": 24.0, "max_dwell": 140, "noise_ar": 0.7}):
        a = simulate.simulate_read(np.random.RandomState(11), model, 700,
                                   simulate.SimConfig(**cfg_kw))
        b = port.simulate_read(np.random.RandomState(11), pmodel, 700, port.SimConfig(**cfg_kw))
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y)
        simulate.write_signal_label(str(tmp_path / "a"), "r", *a)
        port.write_signal_label(str(tmp_path / "b"), "r", *b)
        for ext in (".signal", ".label"):
            assert (tmp_path / "a" / ("r" + ext)).read_bytes() == \
                (tmp_path / "b" / ("r" + ext)).read_bytes()


def test_pore_model_is_the_bundled_one():
    with open(R.PORE_MODEL, "rb") as f, open(os.path.join(
            H.ROOT, "chiron_tpu", "model", "DNA_default", "pore_model.tsv"), "rb") as g:
        assert f.read() == g.read()


def test_read_lengths_same_for_every_seed(tmp_path):
    p = {"n_reads": 4, "median_bases": 300, "sigma": 0.85, "min_bases": 100, "max_bases": 2000,
         "sim": {"mean_dwell": 9.0}}
    a = R.generate(p, 1, str(tmp_path / "a"))
    b = R.generate(p, 2**33 + 5, str(tmp_path / "b"))
    assert sorted(r.bases for r in a) == sorted(r.bases for r in b) == sorted(R.read_lengths(p))
    c = R.generate(p, 1, str(tmp_path / "c"))
    assert [(r.bases, r.samples) for r in a] == [(r.bases, r.samples) for r in c]
    assert (tmp_path / "a" / "read000.signal").read_bytes() == \
        (tmp_path / "c" / "read000.signal").read_bytes()


@pytest.mark.parametrize("name,seg,mflop", [("DNA_default", 400, 4.459),
                                             ("DNA_slow", 2000, 1.181)])
def test_flop_count_matches_the_port_on_the_bundles(name, seg, mflop):
    """The copy's count from a checkpoint's shapes equals ``tools/mfu.py``'s
    on the two bundled models (3 x 128)."""
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.tools.mfu import flop_terms

    model_dir = os.path.join(BUNDLED, name)
    config = C.read_config(os.path.join(model_dir, "model.json"))
    frames = -(-seg // (4 if name == "DNA_slow" else 1))
    ours = work.model_flops_per_window(weight_shapes(model_dir), frames)
    assert ours == pytest.approx(sum(flop_terms(config, seg).values()), rel=1e-12)
    assert ours / seg / 1e6 == pytest.approx(mflop, abs=5e-4)


def test_flop_count_matches_the_port_on_the_configuration():
    from chiron_tpu_torch.tools.mfu import flop_terms

    ours = work.model_flops_per_window(weights.shapes(DNA_DEFAULT), 400)
    assert ours == pytest.approx(sum(flop_terms(DNA_DEFAULT["model"], 400).values()),
                                 rel=1e-12)


def test_conv_list_matches_the_weights():
    convs = [s for k, s in weights.shapes(DNA_DEFAULT).items()
             if k.startswith("cnn/") and k.endswith("/w")]
    assert sorted(tuple(s) for s in convs) == sorted(tuple(c[:3]) for c in DNA_DEFAULT["convs"])


def test_roofline_is_the_longer_bound():
    assert work.roofline_seconds(989e12, 0, work.PEAKS["bf16"]) == pytest.approx(1.0)
    assert work.roofline_seconds(0, 3.35e12, work.PEAKS["bf16"]) == pytest.approx(1.0)
    w = work.conv_bn_work([[3, 256, 256, 400, 400, 1]], 400, 2, 2)
    assert w["flops"] == 2.0 * 400 * 400 * 3 * 256 * 256
