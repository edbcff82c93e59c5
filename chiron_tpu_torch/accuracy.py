"""Accuracy benchmark of the port: the JAX package's accuracy axes, basecalled
by ``chiron_tpu_torch``.

A port of the root ``accuracy.py``, which measures the JAX package and writes
the committed ``ACCURACY.json``. This module runs the same axes (the same
held-out seeds, corpus sizes, models, presets and beam) through the port's
``eval/pipeline.evaluation`` and scores them with the port's copies of the
simulator and aligner (``tools/simulate.py``, ``tools/assess.py``):

  1. real_dna: the reference's example reads against its golden fastq, from
     the directory given as ``--reference`` (the reference Chiron's
     ``example_data/DNA``); skipped without it, as the JAX package skips the
     axis when that data is absent.
  2. synthetic_dna / synthetic_rna: a held-out simulated corpus (seeds 991 /
     992, disjoint from every training corpus) basecalled with DNA_default /
     RNA_default and aligned against the true sequences.
  3. synthetic_dna_slow: the same at the real reads' translocation regime
     (mean dwell 24, AR(1) noise), basecalled with DNA_slow at dna-slow-pre.

Each axis reports identity, ``skill`` ((identity - 0.525) / 0.475, 0 = a
random caller) and ``kmer11_hit_rate`` (tools/assess.py explains both).

The committed ``ACCURACY.json`` is the JAX package's record and is only read
here: the port writes its own document to ``--out`` (default under the
gitignored ``chiron_tpu_torch/_build/``) and prints, beside each axis, the
committed row it answers to.

Usage:  python -m chiron_tpu_torch.accuracy [--cpu] [--beam N] [--quick] [--out PATH]
                                            [--reference DIR]
Without ``--cpu`` the basecalls run on the card, and a machine without one raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import types

import torch

from chiron_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DNA = os.path.join(REPO, "chiron_tpu", "model", "DNA_default")
MODEL_RNA = os.path.join(REPO, "chiron_tpu", "model", "RNA_default")
# slow-translocation model (dna-slow-pre preset): used for the real reads
# (22-26 samples/base) and the synthetic slow axis; falls back to
# DNA_default at seg 400 when no DNA_slow checkpoint is installed
MODEL_SLOW = os.path.join(REPO, "chiron_tpu", "model", "DNA_slow")
# the JAX package's record, read-only here
COMMITTED = os.path.join(REPO, "ACCURACY.json")
DEFAULT_OUT = os.path.join(REPO, "chiron_tpu_torch", "_build", "accuracy.json")
SYNTHETIC_AXES = ("synthetic_dna", "synthetic_dna_slow", "synthetic_rna")

# held-out simulation seeds: every training corpus must use different ones
HOLDOUT_SEED_DNA = 991
HOLDOUT_SEED_RNA = 992


def _slow_model():
    if os.path.exists(os.path.join(MODEL_SLOW, "checkpoint")):
        return MODEL_SLOW, dict(batch=300, seg=2000, jump=1900)
    return MODEL_DNA, dict(batch=400, seg=400, jump=390)


def _flags(input_dir, output_dir, model_dir, mode="dna", beam=30,
           batch=400, seg=400, jump=390, length_bonus=None, device="cuda",
           bf16=False):
    return types.SimpleNamespace(
        input=input_dir, output=output_dir, model=model_dir,
        start=0, batch_size=batch, segment_len=seg, jump=jump, threads=0,
        beam=beam, extension="fastq", concise=False, mode=mode,
        reverse_fast5=False, recursive=False, sig_norm=1, bf16=bf16,
        # None => the model's calibrated model.json default (pipeline.py)
        length_bonus=length_bonus, device=device,
    )


def _call(flags):
    from chiron_tpu_torch.eval.pipeline import evaluation

    return evaluation(flags)


def measure_real_dna(work: str, beam: int, device: str = "cuda",
                     bf16: bool = False, reference: str = None) -> dict:
    """Identity of our basecalls vs the reference golden fastq (real signal).

    ``reference`` is the reference Chiron's ``example_data/DNA`` directory
    (reads under ``output/raw``, golden outputs under ``output/result``);
    without it, or without those two directories, the axis is skipped."""
    from chiron_tpu_torch.tools.assess import assess_dir

    raw = os.path.join(reference or "", "output", "raw")
    golden = os.path.join(reference or "", "output", "result")
    if not (reference and os.path.isdir(raw) and os.path.isdir(golden)):
        return {"skipped": "reference example data absent"}
    out = os.path.join(work, "real_dna")
    model_dir, kw = _slow_model()
    _call(_flags(raw, out, model_dir, beam=beam, device=device, bf16=bf16, **kw))
    report = assess_dir(os.path.join(out, "result"), golden)
    s = report["summary"]
    s["per_read_identity"] = {
        name: round(r["identity"], 4) for name, r in sorted(report["reads"].items())
    }
    s["model"] = os.path.basename(model_dir)
    return s


def _measure_synth(work: str, mode: str, beam: int, n_reads: int,
                   n_bases: int, cfg=None, axis: str = "",
                   model_dir: str = None, call_kw: dict = None,
                   oracle: bool = False, length_bonus=None,
                   oracle_reads: int = 0, device: str = "cuda",
                   bf16: bool = False) -> dict:
    """Held-out simulated corpus -> basecall -> identity vs truth.

    ``oracle=True`` additionally decodes the SAME corpus with the exact-
    model Viterbi oracle (tools/oracle.py) and attaches its summary under
    "oracle": the ceiling every model number should be read against
    (CPU-only). ``oracle_reads`` caps the oracle to the first N reads of
    the corpus (a deterministic prefix of the same corpus: reads are drawn
    in order from RandomState(seed))."""
    from chiron_tpu_torch.tools.assess import assess_dir
    from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_corpus

    if model_dir is None:
        model_dir = MODEL_DNA if mode == "dna" else MODEL_RNA
    pore_path = os.path.join(model_dir, "pore_model.tsv")
    pore = KmerModel.load(pore_path) if os.path.exists(pore_path) else (
        KmerModel.synthetic()
    )
    seed = HOLDOUT_SEED_DNA if mode == "dna" else HOLDOUT_SEED_RNA
    if cfg is None:
        cfg = SimConfig() if mode == "dna" else SimConfig.rna()
    axis = axis or f"synth_{mode}"
    data = os.path.join(work, f"{axis}_data")
    truth = os.path.join(work, f"truth_{axis}.fasta")
    simulate_corpus(data, n_reads, n_bases, seed=seed, model=pore, cfg=cfg,
                    fasta=truth)
    out = os.path.join(work, f"{axis}_out")
    common = dict(beam=beam, length_bonus=length_bonus, device=device, bf16=bf16)
    if call_kw is not None:
        flags = _flags(data, out, model_dir, mode=mode, **common, **call_kw)
    elif mode == "dna":
        flags = _flags(data, out, model_dir, mode="dna", **common)
    else:
        flags = _flags(data, out, model_dir, mode="rna", batch=100, seg=2000,
                       jump=1900, **common)
    n_windows = _call(flags)["total_windows"]
    report = assess_dir(os.path.join(out, "result"), truth)
    s = report["summary"]
    s["n_bases_per_read"] = n_bases
    s["n_windows"] = n_windows
    s["pore_model"] = os.path.relpath(pore_path, REPO) if os.path.exists(
        pore_path) else "synthetic(seed=1234)"
    if oracle:
        from chiron_tpu_torch.tools.oracle import measure_axis as oracle_axis

        n_or = min(n_reads, oracle_reads) if oracle_reads else n_reads
        orep = oracle_axis(n_or, n_bases, seed, pore, cfg,
                           workers=os.cpu_count() or 1)
        s["oracle"] = {k: round(v, 4) if isinstance(v, float) else v
                       for k, v in orep["summary"].items()}
    return s


def committed_rows() -> dict:
    """The JAX package's committed accuracy document (empty if absent)."""
    if not os.path.exists(COMMITTED):
        return {}
    with open(COMMITTED) as f:
        return json.load(f)


def _summary_line(axis: str, row: dict, committed: dict) -> str:
    if "skipped" in row:
        return f"{axis}: skipped ({row['skipped']})"
    line = (f"{axis}: identity {row['identity']:.4f} skill {row['skill']:.4f} "
            f"kmer11 {row['kmer11_hit_rate']:.4f}")
    ref = committed.get(axis, {})
    if "skill" in ref:
        line += (f"   committed ACCURACY.json: identity {ref['identity']:.4f} skill "
                 f"{ref['skill']:.4f} kmer11 {ref['kmer11_hit_rate']:.4f}")
    return line


def measure(work: str, beam: int = 30, quick: bool = False, skip=(),
            oracle: bool = False, oracle_reads: int = 0, length_bonus=None,
            device: str = "cuda", bf16: bool = False, reference: str = None) -> dict:
    """Every axis not in ``skip``, basecalled under ``work``; prints one
    summary line per axis beside the committed row it answers to."""
    from chiron_tpu_torch.tools.simulate import SimConfig

    committed = committed_rows()
    n_reads = 5 if quick else 20
    kw = dict(oracle=oracle, length_bonus=length_bonus, oracle_reads=oracle_reads,
              device=device, bf16=bf16)
    out = {"beam": beam}
    if "real_dna" not in skip:
        out["real_dna"] = measure_real_dna(work, beam, device, bf16, reference)
    if "synthetic_dna" not in skip:
        out["synthetic_dna"] = _measure_synth(
            work, "dna", beam, n_reads, 1000 if quick else 4000, **kw)
    if "synthetic_dna_slow" not in skip:
        # real-signal translocation regime: the reference's example reads
        # run at 22-26 samples/base (vs the 9 of synthetic_dna)
        slow_dir, slow_kw = _slow_model()
        out["synthetic_dna_slow"] = _measure_synth(
            work, "dna", beam, max(2, n_reads // 2), 500 if quick else 2000,
            cfg=SimConfig(mean_dwell=24.0, max_dwell=140, noise_ar=0.7),
            axis="synth_dna_slow", model_dir=slow_dir, call_kw=slow_kw, **kw)
        out["synthetic_dna_slow"]["sim_config"] = (
            "mean_dwell=24 max_dwell=140 noise_ar=0.7")
        out["synthetic_dna_slow"]["model"] = os.path.basename(slow_dir)
    if "synthetic_rna" not in skip:
        out["synthetic_rna"] = _measure_synth(
            work, "rna", beam, max(2, n_reads // 4), 500 if quick else 2000, **kw)
    for axis, row in out.items():
        if axis != "beam":
            print(_summary_line(axis, row, committed), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Accuracy benchmark of the port")
    p.add_argument("--cpu", action="store_true",
                   help="basecall on the CPU (default: the card; none raises)")
    p.add_argument("--beam", type=int, default=30,
                   help="beam width (0 = greedy)")
    p.add_argument("--quick", action="store_true",
                   help="small synthetic corpora (CI-scale)")
    p.add_argument("--length_bonus", type=float, default=None,
                   help="beam-decode per-label bonus; default None = each "
                        "model's calibrated model.json value (0.0 if unset)")
    p.add_argument("--oracle", action="store_true",
                   help="also decode each synthetic corpus with the exact-"
                        "model Viterbi oracle (tools/oracle.py) and attach "
                        "its ceiling under each axis's 'oracle' key")
    p.add_argument("--oracle_reads", type=int, default=0,
                   help="cap the oracle to the first N reads per axis "
                        "(deterministic corpus prefix); 0 = all")
    p.add_argument("--skip", default="",
                   help="comma list of axes to skip (real_dna,synthetic_dna,"
                        "synthetic_dna_slow,synthetic_rna)")
    p.add_argument("--reference", default=None,
                   help="the reference Chiron's example_data/DNA directory for the "
                        "real_dna axis (skipped without it)")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="where to write the port's JSON document (never the "
                        "repository's ACCURACY.json)")
    args = p.parse_args(argv)
    out_path = os.path.realpath(args.out)
    if out_path == os.path.realpath(COMMITTED):
        raise ValueError(f"{COMMITTED} is the JAX package's record; pass another --out")
    device = str(resolve_device("cpu" if args.cpu else "cuda"))

    skip = set(filter(None, args.skip.split(",")))
    work = tempfile.mkdtemp(prefix="chiron_torch_acc_")
    try:
        out = measure(work, args.beam, args.quick, skip, args.oracle, args.oracle_reads,
                      args.length_bonus, device, reference=args.reference)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["device"] = torch.cuda.get_device_name(0) if device == "cuda" else device
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"Wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
