"""Runner of the ``chiron call`` cells: whole basecalls of a batch of reads,
back to back, through the program's command line.

Set-up: the mix's reads are simulated from the seed once under the run's
scratch directory and each is hard-linked ``copies`` times into one input
directory (``c<copy>_<read>.signal``), so one call is a user's batch of
reads. One call over the first ``warm_reads`` reads builds the kernels and
warms the call's shapes (every batch has the same shape).

Window: ``chiron call -i <input> -o <fresh dir> -m <model> -p <preset>
<flags>`` is run whole, again and again, until ``--seconds`` have passed,
and nothing else runs in it. Once it has closed, the harness checks that
every read of every call got its fastq, counts the truth bases of those
reads, keeps the outputs of the sampled reads and deletes each call's
outputs (some 10 MB a call). ``bases_per_s`` is the truth bases over the
window, from the first call's start to the last call's end.

Check: once the window has closed, the reference basecalls the sampled
reads (the longest read among them, the rest drawn from the seed) in the
batches the call packed, and every timed call's outputs of them are
compared with it (``reference.compare.read_numbers``).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time
from typing import Dict, List

import numpy as np

from benchmark import reads as R
from benchmark.harness import Context, Outcome, memory_peak, model_dir, sync
from benchmark.reference import assembly, compare
from benchmark.reference.call import reference_reads
from benchmark.reference.signal import window_count, window_lengths
from benchmark.trace import Window


def link_inputs(reads: List[R.Read], src: str, dst: str, copies: int) -> Dict[str, R.Read]:
    """Hard links ``c<j>_<read>.signal`` -> the read's file; name -> read."""
    os.makedirs(dst, exist_ok=True)
    names = {}
    for j in range(copies):
        for r in reads:
            name = f"c{j}_{r.name}"
            os.link(os.path.join(src, r.name + ".signal"), os.path.join(dst, name + ".signal"))
            names[name] = r
    return names


def call_argv(ctx: Context, input_dir: str, out_dir: str) -> List[str]:
    mix = ctx.traffic
    return (["call", "-i", input_dir, "-o", out_dir,
             "-m", ctx.config["model_dir"], "-p", mix["preset"],
             "-b", str(mix["batch_size"]), "-l", str(mix["segment_len"]),
             "-j", str(mix["jump"]), "--beam", str(mix["beam"])] + list(mix["flags"]))


def read_outputs(out_dir: str, name: str):
    """(segments, consensus, quality) a call wrote for ``name``, or None."""
    try:
        with open(os.path.join(out_dir, "result", name + ".fastq")) as f:
            lines = f.read().split("\n")
        with open(os.path.join(out_dir, "segments", name + ".fastq")) as f:
            seg_lines = f.read().split("\n")
    except FileNotFoundError:
        return None
    if len(lines) < 4 or not lines[0].startswith("@"):
        return None
    segments = [seg_lines[i + 1] for i in range(0, len(seg_lines) - 1, 2)
                if seg_lines[i].startswith(">")]
    return {"segments": segments, "consensus": lines[1], "quality": lines[3]}


def work_of_call(ctx: Context, names: Dict[str, R.Read]) -> Dict[str, float]:
    """The device work of one call: windows, batches, logit frames."""
    mix = ctx.traffic
    seg, jump, batch = mix["segment_len"], mix["jump"], mix["batch_size"]
    t_out = -(-seg // ctx.config["stride"])
    ratio = seg / t_out
    frames = []
    for r in names.values():
        frames.append(np.round(window_lengths(r.samples, jump, seg) / ratio))
    frames = np.concatenate(frames)
    n = len(frames)
    batches = -(-n // batch)
    pad = batches * batch - n
    tail = frames[(n // batch) * batch:]
    padded_frames = float(frames.sum() + (np.resize(tail, pad).sum() if pad else 0))
    return {"windows": float(batches * batch), "batches": float(batches),
            "frames": padded_frames, "frames_padded": float(batches * batch * t_out)}


def prepare(ctx: Context):
    """The model directory, the reads, the call's input directory (name ->
    read) and the sampled reads: a copy of the longest read, and the rest
    drawn from the seed."""
    mix = ctx.traffic
    model_dir(ctx)
    src = os.path.join(ctx.workdir, "reads")
    reads = R.generate(mix["reads"], ctx.seed, src)
    input_dir = os.path.join(ctx.workdir, "input")
    names = link_inputs(reads, src, input_dir, mix["copies"])
    rng = R.rng_for(ctx.seed, 1)
    longest = max(reads, key=lambda r: r.bases)
    others = [n for n, r in names.items() if r is not longest]
    sampled = [f"c{rng.randint(mix['copies'])}_{longest.name}"]
    sampled += [others[i] for i in rng.choice(len(others), mix["check_reads"] - 1,
                                              replace=False)]
    return reads, names, input_dir, sampled


def reference_of(ctx: Context, names, input_dir, sampled, precision: str):
    mix = ctx.traffic
    n_windows = {n: window_count(r.samples, mix["jump"]) for n, r in names.items()}
    call = {k: mix[k] for k in ("batch_size", "segment_len", "jump", "beam")}
    return reference_reads(ctx.config, call, input_dir, n_windows, sampled, precision,
                           ctx.device)


def judge_outputs(kept: List[Dict[str, Dict]], ref: Dict[str, Dict]) -> Dict[str, float]:
    """The compared numbers, the worst over the kept calls."""
    numbers = {"window_edit": 0.0, "consensus_diff": 0.0, "quality_gap": 0.0,
               "missing_outputs": 0.0}
    for outputs in kept:
        numbers["missing_outputs"] += sum(o is None for o in outputs.values())
        present = {n: o for n, o in outputs.items() if o is not None}
        got = compare.read_numbers(present, {n: ref[n] for n in present})
        for k, v in got.items():
            numbers[k] = max(numbers[k], v)
    return numbers


def control(ctx: Context, precision: str) -> Dict[str, float]:
    """The numbers of the control: the reference computed in ``precision``
    put in the program's place (its window decodes, and its reads assembled
    from them with its own path probabilities), judged as a run is."""
    _, names, input_dir, sampled = prepare(ctx)
    low = reference_of(ctx, names, input_dir, sampled, precision)
    outputs = {}
    for n, r in low.items():
        counts, qsum = assembly.assemble(r["segments"], r["probs"])
        qual = "".join(chr(q + 33) for q in assembly.quality_values(counts, qsum))
        outputs[n] = {"segments": r["segments"], "consensus": assembly.consensus(counts),
                      "quality": qual}
    return judge_outputs([outputs], reference_of(ctx, names, input_dir, sampled, "fp32"))


def run(ctx: Context) -> Outcome:
    import torch

    from chiron_tpu_torch import cli
    from chiron_tpu_torch.ops import host_build

    mix = ctx.traffic
    reads, names, input_dir, sampled = prepare(ctx)
    warm_dir = os.path.join(ctx.workdir, "warm")
    link_inputs(reads[:mix["warm_reads"]], os.path.join(ctx.workdir, "reads"), warm_dir, 1)
    print(f"native host library: {host_build.native_available()}", file=sys.stderr)
    out_dir = os.path.join(ctx.workdir, "out")
    cli.main(call_argv(ctx, warm_dir, out_dir))
    shutil.rmtree(out_dir)
    sync(ctx.device)
    setup_s = time.time() - ctx.t0

    outs: List[str] = []
    ends: List[float] = []
    with Window(ctx.trace) as window:
        start = time.time()
        while not outs or time.time() - start < ctx.seconds:
            outs.append(os.path.join(ctx.workdir, f"out{len(outs)}"))
            cli.main(call_argv(ctx, input_dir, outs[-1]))
            ends.append(time.time())
        end = time.time()
    print("seconds of each timed call: " + " ".join(
        f"{b - a:.3f}" for a, b in zip([start] + ends[:-1], ends)), file=sys.stderr)
    kept: List[Dict[str, Dict]] = []
    attempted = failed = bases = 0
    for out in outs:
        for name, r in names.items():
            attempted += 1
            path = os.path.join(out, "result", name + ".fastq")
            if os.path.isfile(path) and os.path.getsize(path) > 0:
                bases += r.bases
            else:
                failed += 1
        kept.append({n: read_outputs(out, n) for n in sampled})
        shutil.rmtree(out)
    sync(ctx.device)
    peak = memory_peak(ctx.device)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    numbers = judge_outputs(kept, reference_of(ctx, names, input_dir, sampled, "fp32"))
    work = {k: v * len(outs) for k, v in work_of_call(ctx, names).items()}
    work["calls"] = float(len(outs))
    return Outcome(metrics={"bases_per_s": bases / (end - start), "setup_s": setup_s},
                   attempted=attempted, failed=failed, numbers=numbers,
                   memory_peak_bytes=peak, trace=window.data, work=work)
