"""Benchmark of the port: the full basecall pipeline on the card, as the root
``bench.py`` measures the JAX package.

    python -m chiron_tpu_torch.bench [--input DIR --golden DIR]

Prints ONE JSON line with the JAX bench's keys ("metric", "value", "unit",
"vs_baseline", "device_samples_per_second_batch2000",
"device_samples_per_second_slow_batch400"), plus "input" (which input the
run used, with its samples per base) and "card" (the card's name and power
limit).

Metric (model-independent): reference bases / the best of 5 warm full
``call`` runs after one warm-up run (reading + forward + CTC beam search of
width 30 + assembly + writing), with the bundled DNA_default weights at
dna-pre in bf16 inference mode, the JAX package's production mode.
``vs_baseline`` divides it by the reference Chiron's published GPU
beam-search rate, 1,204 bp/s (BASELINE.md), which was taken on the
reference's 5 example reads (43,390 golden bases at 22-26 samples a base).

Input: reads and golden outputs given as ``--input`` / ``--golden`` (the
reference's example reads, for one); the reference bases are then the golden
consensus bases. By default, a seeded simulated ``.signal`` corpus in the
regime of those reads: 5 reads of 8,678 bases (43,390 truth bases) at their
translocation speed (``SimConfig(mean_dwell=24, max_dwell=140,
noise_ar=0.7)``, the regime of the accuracy's ``synthetic_dna_slow`` axis),
DNA_default's pore model, from a seed that is no accuracy holdout; the
reference bases are then the truth bases. Its bases, samples and windows
are those of the reference reads in count, not the same reads.

The device axes time the step alone (``device_throughput``): forward, beam-30
decode and output packing on a batch of 2,000 windows of 400 samples
(DNA_default) or 400 windows of 2,000 (DNA_slow), between two
``torch.cuda.synchronize()`` calls. Both read the same 800,000 samples a step.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from chiron_tpu_torch import config as C
from chiron_tpu_torch.accuracy import MODEL_DNA, MODEL_SLOW
from chiron_tpu_torch.utils.device import resolve_device

BASELINE_BPS = 1204.0  # reference GPU beam-search rate
# the default simulated corpus: the reference reads' count of reads and
# bases, at their translocation speed (22-26 samples a base)
SIM_SEED = 4242  # not an accuracy holdout seed (991, 992)
SIM_READS = 5
SIM_BASES = 8678
SIM_CONFIG = dict(mean_dwell=24.0, max_dwell=140, noise_ar=0.7)


def make_flags(input_dir, output_dir, model_dir, beam=30, device="cuda"):
    return types.SimpleNamespace(
        input=input_dir,
        output=output_dir,
        model=model_dir,
        start=0,
        batch_size=400,
        segment_len=400,
        jump=390,
        threads=0,
        beam=beam,
        extension="fastq",
        concise=False,
        mode="dna",
        reverse_fast5=False,
        recursive=True,
        sig_norm=1,  # the bundled model's preprocessing
        bf16=True,  # the JAX package's production inference mode
        device=device,
    )


def golden_bases(result_dir: str) -> int:
    """Total consensus bases in the reference's golden outputs."""
    total = 0
    if os.path.isdir(result_dir):
        for f in os.listdir(result_dir):
            if f.endswith(".fastq") or f.endswith(".fasta"):
                with open(os.path.join(result_dir, f)) as fh:
                    lines = fh.read().splitlines()
                if len(lines) >= 2:
                    total += len(lines[1])
    return total


def simulated_input(work: str, seed: int = SIM_SEED, n_reads: int = SIM_READS,
                    n_bases: int = SIM_BASES):
    """Write the default corpus under ``work``: (signal dir, truth bases, samples)."""
    from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_corpus

    pore = KmerModel.load(os.path.join(MODEL_DNA, "pore_model.tsv"))
    os.makedirs(work, exist_ok=True)
    data = os.path.join(work, "sim_signal")
    truth = os.path.join(work, "sim_truth.fasta")
    simulate_corpus(data, n_reads, n_bases, seed=seed, model=pore,
                    cfg=SimConfig(**SIM_CONFIG), fasta=truth)
    with open(truth) as f:
        bases = sum(len(line.strip()) for line in f if not line.startswith(">"))
    samples = 0
    for name in os.listdir(data):
        if name.endswith(".signal"):
            with open(os.path.join(data, name)) as f:
                samples += len(f.read().split())
    return data, bases, samples


def resolve_input(work: str, input_dir=None, golden=None):
    """(input dir, reference bases, description) for the run: the given reads
    and golden outputs, else the simulated corpus."""
    if input_dir or golden:
        bases = golden_bases(golden or "")
        if not (input_dir and os.path.isdir(input_dir) and bases):
            raise ValueError("--input needs a reads directory and --golden golden outputs "
                             f"with consensus bases (got {input_dir!r}, {golden!r})")
        return input_dir, bases, f"reads {input_dir}, golden {golden}"
    data, bases, samples = simulated_input(work)
    cfg = " ".join(f"{k}={v:g}" for k, v in SIM_CONFIG.items())
    return data, bases, (f"simulated: {SIM_READS} reads of {SIM_BASES} bases, seed {SIM_SEED}, "
                         f"DNA_default pore model, SimConfig({cfg}), {samples} samples, "
                         f"{samples / bases:.2f} samples per base")


def call_seconds(input_dir: str, work: str, runs: int = 5, device: str = "cuda"):
    """Wall seconds of ``runs`` warm full `call` runs (DNA_default) after one
    warm-up run, and the last run's summary."""
    from chiron_tpu_torch.eval.pipeline import evaluation

    evaluation(make_flags(input_dir, os.path.join(work, "warm"), MODEL_DNA, device=device))
    seconds = []
    for i in range(runs):
        flags = make_flags(input_dir, os.path.join(work, f"run{i}"), MODEL_DNA, device=device)
        t0 = time.time()
        result = evaluation(flags)
        seconds.append(time.time() - t0)
    return seconds, result


def device_throughput(model_dir, batch=2000, seg=400, beam=30, steps=4,
                      device="cuda") -> float:
    """Signal samples/s through the full device step (forward + beam-30
    decode + output packing, bf16 inference mode) at a throughput-mode
    batch, without the host pipeline: ``steps`` steps are issued back to
    back and the timed window is bracketed by ``torch.cuda.synchronize()``
    (best of 3). Every window is full: seq_len is the frame count of ``seg``
    samples. The beam runs without a length bonus, as in the JAX bench."""
    from chiron_tpu_torch.eval.pipeline import decode_step, load_model
    from chiron_tpu_torch.models.model import output_len

    dev = resolve_device(device)
    config = C.read_config(os.path.join(model_dir, "model.json"))
    model = load_model(model_dir, config, dev)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, seg).astype(np.float32)).to(torch.bfloat16).to(dev)
    seq_len = torch.full((batch,), output_len(config, seg), dtype=torch.int32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    decode_step(model, x, seq_len, beam, bf16=True).cpu()  # warm
    best = float("inf")
    for _ in range(3):
        sync()
        t0 = time.time()
        for _ in range(steps):
            decode_step(model, x, seq_len, beam, bf16=True)
        sync()
        best = min(best, time.time() - t0)
    return round(batch * seg * steps / best, 1)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def measure(work: str, input_dir=None, golden=None, device="cuda", runs=5, batch=2000,
            slow_batch=400, steps=4) -> dict:
    """The bench's result under the JAX bench's keys, with the input it used,
    the reference bases, every timed call's seconds and its windows."""
    input_dir, bases, described = resolve_input(work, input_dir, golden)
    seconds, result = call_seconds(input_dir, work, runs=runs, device=device)
    bps = bases / min(seconds)
    out = {
        "metric": "basecall_bases_per_second_beam30",
        "value": round(bps, 1),
        "unit": "bp/s",
        "vs_baseline": round(bps / BASELINE_BPS, 2),
        "device_samples_per_second_batch2000": device_throughput(
            MODEL_DNA, batch=batch, steps=steps, device=device),
    }
    if os.path.exists(os.path.join(MODEL_SLOW, "checkpoint")):
        out["device_samples_per_second_slow_batch400"] = device_throughput(
            MODEL_SLOW, batch=slow_batch, seg=2000, steps=steps, device=device)
    out.update({"input": described, "reference_bases": bases, "call_seconds": seconds,
                "call_windows": result["total_windows"]})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Basecall benchmark of the port (needs the card)")
    p.add_argument("--input", default=None,
                   help="reads to basecall (default: the simulated corpus)")
    p.add_argument("--golden", default=None,
                   help="golden outputs whose consensus bases count as the reference bases")
    args = p.parse_args(argv)
    resolve_device("cuda")
    work = tempfile.mkdtemp(prefix="chiron_torch_bench_")
    try:
        out = measure(work, args.input, args.golden)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["card"] = card_name()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
