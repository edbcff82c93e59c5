"""The port's accuracy and benchmark entry points (chiron_tpu_torch/accuracy.py,
chiron_tpu_torch/bench.py) on the CPU: the accuracy smoke floors of
tests/test_accuracy_smoke.py on the same corpora through the port's plain
kernels, the port's `evaluation` against the JAX package's on one corpus,
and the shape of what each entry point returns and writes.
"""

import json
import os
import types

import pytest
import torch

import test_accuracy_smoke as smoke
from chiron_tpu.eval.pipeline import evaluation as jax_evaluation
from chiron_tpu.tools.simulate import simulate_corpus as jax_simulate_corpus
from chiron_tpu_torch import accuracy, bench
from chiron_tpu_torch.eval.pipeline import evaluation
from chiron_tpu_torch.tools.assess import assess_dir
from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_corpus

JAX_BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
                  "device_samples_per_second_batch2000",
                  "device_samples_per_second_slow_batch400"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread. The plain kernels issue many
    small ops (a step loop over T); with several test workers' torch thread
    pools competing for the cores, one beam-4 case ran 100x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flags(data, out, model_dir, seg, jump, beam, mode, **kw):
    """tests/test_accuracy_smoke.py's flags (the port's also name the device)."""
    return types.SimpleNamespace(
        input=data, output=out, model=model_dir,
        start=0, batch_size=32, segment_len=seg, jump=jump, threads=0,
        beam=beam, extension="fasta", concise=False, mode=mode,
        reverse_fast5=False, recursive=False, sig_norm=1, **kw)


def _corpus(tmp_path, pore, cfg, n_reads, seed):
    data, truth = str(tmp_path / "data"), str(tmp_path / "truth.fasta")
    simulate_corpus(data, n_reads, 1000, seed=seed, model=pore, cfg=cfg, fasta=truth)
    return data, truth


# tests/test_accuracy_smoke.py's four cases: (model, SimConfig kwargs or "rna",
# pore model (None = KmerModel.synthetic()), reads, seed, mode, seg, jump, beam,
# identity floor, kmer11 floor)
SMOKE = {
    "dna_greedy": ("DNA_default", {}, "DNA_default", 6, 991, "dna", 400, 390, 0,
                   smoke.IDENTITY_FLOOR, smoke.KMER11_FLOOR),
    "dna_beam4": ("DNA_default", {}, "DNA_default", 6, 991, "dna", 400, 390, 4,
                  smoke.BEAM_IDENTITY_FLOOR, smoke.BEAM_KMER11_FLOOR),
    "dna_slow": ("DNA_slow", dict(mean_dwell=24.0, max_dwell=140, noise_ar=0.7), "DNA_slow",
                 6, 991, "dna", 2000, 1900, 0,
                 smoke.SLOW_IDENTITY_FLOOR, smoke.SLOW_KMER11_FLOOR),
    "rna": ("RNA_default", "rna", None, 4, 992, "rna", 2000, 1900, 0,
            smoke.RNA_IDENTITY_FLOOR, smoke.RNA_KMER11_FLOOR),
}


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_port_accuracy_floor(tmp_path, case):
    model, cfg_kw, pore_model, n_reads, seed, mode, seg, jump, beam, id_floor, k_floor = \
        SMOKE[case]
    model_dir = os.path.join(smoke.REPO, "chiron_tpu", "model", model)
    pore = (KmerModel.synthetic() if pore_model is None else KmerModel.load(
        os.path.join(smoke.REPO, "chiron_tpu", "model", pore_model, "pore_model.tsv")))
    cfg = SimConfig.rna() if cfg_kw == "rna" else SimConfig(**cfg_kw)
    data, truth = _corpus(tmp_path, pore, cfg, n_reads, seed)
    out = str(tmp_path / "out")
    evaluation(_flags(data, out, model_dir, seg, jump, beam, mode, device="cpu"))
    s = assess_dir(os.path.join(out, "result"), truth)["summary"]
    assert s["n_reads"] == n_reads
    smoke._assert_floors(s, id_floor, k_floor, f"port {case}")


@pytest.mark.parametrize("beam", [0, 4])
def test_port_evaluation_matches_jax(tmp_path, beam):
    """A 2-read DNA_default corpus through both pipelines: identity and
    kmer11 within 0.002 of the JAX package's."""
    pore = KmerModel.load(os.path.join(accuracy.MODEL_DNA, "pore_model.tsv"))
    data, truth = _corpus(tmp_path, pore, SimConfig(), 2, 991)
    summaries = []
    for tag, run, kw in (("jax", jax_evaluation, {}), ("torch", evaluation, {"device": "cpu"})):
        out = str(tmp_path / tag)
        run(_flags(data, out, accuracy.MODEL_DNA, 400, 390, beam, "dna", **kw))
        summaries.append(assess_dir(os.path.join(out, "result"), truth)["summary"])
    want, got = summaries
    assert got["n_reads"] == want["n_reads"] == 2
    assert abs(got["identity"] - want["identity"]) <= 0.002, (got, want)
    assert abs(got["kmer11_hit_rate"] - want["kmer11_hit_rate"]) <= 0.002, (got, want)


def test_bench_default_corpus(tmp_path):
    """The simulated default input: 5 reads of 8,678 bases (the reference
    reads' 43,390) at their 22-26 samples a base, the JAX simulator's corpus
    byte for byte, its truth bases and samples counted."""
    data, bases, samples = bench.simulated_input(str(tmp_path / "torch"))
    assert bases == bench.SIM_READS * bench.SIM_BASES == 43390
    assert 22 <= samples / bases <= 26
    assert sorted(os.listdir(data)) == [f"sim{i:05d}{ext}" for i in range(5)
                                        for ext in (".label", ".signal")]
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_simulate_corpus(str(jax_dir / "data"), bench.SIM_READS, bench.SIM_BASES,
                        seed=bench.SIM_SEED,
                        model=KmerModel.load(os.path.join(accuracy.MODEL_DNA, "pore_model.tsv")),
                        cfg=SimConfig(mean_dwell=24.0, max_dwell=140, noise_ar=0.7),
                        fasta=str(jax_dir / "truth.fasta"))
    for name in ("sim00000.signal", "sim00004.signal", "sim00004.label"):
        with open(os.path.join(data, name), "rb") as a, open(jax_dir / "data" / name, "rb") as b:
            assert a.read() == b.read()
    with open(tmp_path / "torch" / "sim_truth.fasta", "rb") as a, \
            open(jax_dir / "truth.fasta", "rb") as b:
        assert a.read() == b.read()
    # without --input / --golden the input is this corpus, named with its regime
    got = bench.resolve_input(str(tmp_path / "default"))
    assert got[1] == 43390 and got[2].startswith("simulated")
    assert f"{samples} samples, {samples / bases:.2f} samples per base" in got[2]


def test_bench_measure_keys_on_cpu(tmp_path, monkeypatch):
    """bench.measure on a 2-read corpus with golden outputs (its --input /
    --golden path), one timed run, device steps at batch 4 / 2, one step,
    all on the CPU:
    the JAX bench's keys, the golden bases as the reference count."""
    pore = KmerModel.load(os.path.join(accuracy.MODEL_DNA, "pore_model.tsv"))
    data, truth = _corpus(tmp_path, pore, SimConfig(), 2, 7)
    golden = tmp_path / "golden"
    golden.mkdir()
    with open(truth) as f:
        lines = f.read().split()
    for name, seq in zip(lines[0::2], lines[1::2]):
        (golden / f"{name[1:]}.fastq").write_text(f"{name.replace('>', '@')}\n{seq}\n+\n"
                                                  f"{'5' * len(seq)}\n")
    with pytest.raises(ValueError):
        bench.resolve_input(str(tmp_path), data, None)
    # call batches of 16 windows, not dna-pre's 400, to keep the CPU run short
    flags = bench.make_flags
    monkeypatch.setattr(bench, "make_flags", lambda *a, **k: types.SimpleNamespace(
        **{**vars(flags(*a, **k)), "batch_size": 16}))
    out = bench.measure(str(tmp_path / "work"), data, str(golden), device="cpu", runs=1,
                        batch=4, slow_batch=2, steps=1)
    assert JAX_BENCH_KEYS <= set(out)
    assert out["metric"] == "basecall_bases_per_second_beam30" and out["unit"] == "bp/s"
    assert out["reference_bases"] == 2000 and len(out["call_seconds"]) == 1
    assert out["value"] == round(2000 / out["call_seconds"][0], 1)
    assert out["device_samples_per_second_batch2000"] > 0
    assert out["device_samples_per_second_slow_batch400"] > 0
    json.dumps(out)


def test_bench_device_throughput_on_cpu():
    assert bench.device_throughput(accuracy.MODEL_DNA, batch=4, steps=1, device="cpu") > 0


def test_accuracy_main_writes_out_and_leaves_committed(tmp_path, capsys):
    """accuracy.main writes its document under --out, prints each axis beside
    the committed row, and leaves the repository's ACCURACY.json as it was."""
    with open(accuracy.COMMITTED, "rb") as f:
        before = f.read()
    path = tmp_path / "acc" / "port.json"
    assert accuracy.main(["--cpu", "--quick", "--beam", "0", "--out", str(path),
                          "--skip", "real_dna,synthetic_dna,synthetic_dna_slow"]) == 0
    with open(accuracy.COMMITTED, "rb") as f:
        assert f.read() == before
    doc = json.loads(path.read_text())
    assert set(doc) == {"beam", "device", "synthetic_rna"}
    assert doc["beam"] == 0 and doc["device"] == "cpu"
    row = doc["synthetic_rna"]
    assert row["n_reads"] == 2 and row["n_bases_per_read"] == 500 and row["n_windows"] > 0
    assert row["pore_model"] == "synthetic(seed=1234)"
    assert {"identity", "skill", "kmer11_hit_rate"} <= set(row)
    printed = capsys.readouterr().out
    assert "synthetic_rna: identity" in printed and "committed ACCURACY.json" in printed
    with pytest.raises(ValueError):
        accuracy.main(["--cpu", "--out", accuracy.COMMITTED])


def test_real_dna_axis_skips_without_the_reference_reads(tmp_path):
    """real_dna reads only a directory it is given: none, or one without the
    reads and golden outputs, skips the axis as the JAX package does."""
    want = {"skipped": "reference example data absent"}
    assert accuracy.measure_real_dna(str(tmp_path), 30, "cpu") == want
    assert accuracy.measure_real_dna(str(tmp_path), 30, "cpu",
                                     reference=str(tmp_path / "absent")) == want


def test_accuracy_oracle_matches_jax_on_the_axis_corpus(tmp_path):
    """``accuracy --oracle`` on synthetic_dna's corpus (holdout seed 991,
    DNA_default's pore model, SimConfig()), cut to 2 reads of 150 bases and
    the oracle to the first (``--oracle_reads 1``): the "oracle" summary the
    port attaches equals the JAX oracle's on the same read. Call batches of 8
    windows keep the basecall short on the CPU."""
    from chiron_tpu.tools.oracle import measure_axis as jax_oracle_axis

    row = accuracy._measure_synth(str(tmp_path), "dna", 0, 2, 150, oracle=True,
                                  oracle_reads=1, device="cpu",
                                  call_kw=dict(batch=8, seg=400, jump=390))
    assert row["n_reads"] == 2 and row["n_bases_per_read"] == 150
    assert row["oracle"]["n_reads"] == 1
    want = jax_oracle_axis(1, 150, accuracy.HOLDOUT_SEED_DNA,
                           KmerModel.load(os.path.join(accuracy.MODEL_DNA, "pore_model.tsv")),
                           SimConfig(), workers=0)["summary"]
    assert row["oracle"] == {k: round(v, 4) if isinstance(v, float) else v
                             for k, v in want.items()}
