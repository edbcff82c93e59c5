"""Runner of the ``chiron call`` cells of a CRF model (Bonito's CTC-CRF
basecallers): whole basecalls of a batch of reads, back to back, through the
program's command line, as ``runners/call.py`` runs them.

Set-up: the configuration's weights are made from its ``weights.seed`` in
Bonito's layout (``reference/crf.py:init_bonito``) and written twice under
the run's scratch directory: as they are, for the reference, and through the
program's import (``chiron_tpu_torch.models.crf.from_bonito``) as the model
directory that the call's ``-m`` reads. The mix's reads are simulated from
the seed and hard-linked ``copies`` times into one input directory. One call
over the first ``warm_reads`` reads builds the kernels and warms the call's
one shape ([batch, segment_len]).

Window: ``chiron call`` is run whole, again and again, until ``--seconds``
have passed. ``bases_per_s`` is the truth bases of every read whose fastq
the timed calls wrote, over the window.

Check, once the window has closed: the reference basecalls the sampled reads
(the longest read, the rest drawn from the seed) window by window, and every
timed call's outputs of them are compared with it (``reference/crf.py:
read_numbers``: ``window_edit``, ``consensus_diff``, ``quality_gap``; and
``missing_outputs``). ``score_gap``: the program's model step
(``eval/pipeline.decode_step``) run once more on the sampled windows, in
batches of ``batch_size`` (the last wrap-padded), and its Viterbi scores
against the reference's: the largest difference over the largest reference
score, both in absolute value. With random weights a decode flips at a
near-tie between two paths, so the scores are held as well as the decodes.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import time
from typing import Dict, List

import numpy as np

from benchmark import reads as R
from benchmark.harness import Context, Outcome, memory_peak, sync
from benchmark.reference import crf as ref_crf
from benchmark.reference.signal import window_lengths
from benchmark.runners.call import call_argv, link_inputs, read_outputs
from benchmark.trace import Window

BONITO_WEIGHTS = "bonito_weights.npz"


def write_model(ctx: Context) -> Dict[str, np.ndarray]:
    """The configuration's weights in Bonito's layout (also saved beside the
    model directory), and the program's model directory
    (``ctx.config["model_dir"]``) from them."""
    from chiron_tpu_torch.models.crf import from_bonito
    from chiron_tpu_torch.train.checkpoint import save_checkpoint

    cfg = ctx.config
    state = ref_crf.init_bonito(cfg["weights"]["seed"], features=cfg["features"],
                                state_len=cfg["state_len"], winlen=cfg["winlen"],
                                stride=cfg["stride"], layers=cfg["layers"],
                                gains=cfg["weights"]["gains"])
    np.savez(os.path.join(ctx.workdir, BONITO_WEIGHTS), **state)
    path = os.path.join(ctx.workdir, "model")
    save_checkpoint(path, from_bonito(state, cfg["layers"]), 0)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump(cfg["model"], f)
    cfg["model_dir"] = path
    return state


def prepare(ctx: Context):
    """The weights, the reads, the input directory (name -> read) and the
    sampled reads: a copy of the longest read, and the rest drawn from the
    seed."""
    mix = ctx.traffic
    state = write_model(ctx)
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
    return state, reads, names, input_dir, sampled


def reference_of(ctx: Context, state, input_dir: str, sampled, precision: str):
    mix = ctx.traffic
    paths = {n: os.path.join(input_dir, n + ".signal") for n in sampled}
    return ref_crf.reference_reads(state, ctx.config, paths, mix["jump"], mix["segment_len"],
                                   precision, ctx.device)


def work_of_call(ctx: Context, names: Dict[str, R.Read]) -> Dict[str, float]:
    """The device work of one call: windows, batches, frames (each row's own,
    ceil(samples / stride), the wrap padding's rows included)."""
    mix = ctx.traffic
    seg, jump, batch = mix["segment_len"], mix["jump"], mix["batch_size"]
    stride = ctx.config["stride"]
    frames = np.concatenate([ref_crf.window_frames(window_lengths(r.samples, jump, seg), stride)
                             for r in names.values()]).astype(np.float64)
    n = len(frames)
    batches = -(-n // batch)
    pad = batches * batch - n
    tail = frames[(n // batch) * batch:]
    return {"windows": float(batches * batch), "batches": float(batches),
            "frames": float(frames.sum() + (np.resize(tail, pad).sum() if pad else 0)),
            "frames_padded": float(batches * batch * -(-seg // stride))}


def judge_outputs(ctx: Context, kept: List[Dict[str, Dict]], ref: Dict[str, Dict]
                  ) -> Dict[str, float]:
    """The call's compared numbers, the worst over the kept calls."""
    mix = ctx.traffic
    numbers = {"window_edit": 0.0, "consensus_diff": 0.0, "quality_gap": 0.0,
               "missing_outputs": 0.0}
    for outputs in kept:
        numbers["missing_outputs"] += sum(o is None for o in outputs.values())
        present = {n: o for n, o in outputs.items() if o is not None}
        got = ref_crf.read_numbers(present, {n: ref[n] for n in present},
                                   mix["jump"] / mix["segment_len"])
        for k, v in got.items():
            numbers[k] = max(numbers[k], v)
    return numbers


def score_gap(scores: np.ndarray, ref: Dict[str, Dict], sampled) -> float:
    """max |program - reference| over max |reference| of the sampled windows'
    Viterbi scores (``scores`` in the sampled reads' window order)."""
    want = np.concatenate([ref[n]["scores"] for n in sampled])
    return float(np.abs(scores - want).max() / max(np.abs(want).max(), 1e-30))


def program_scores(ctx: Context, ref: Dict[str, Dict], sampled) -> np.ndarray:
    """The program's model step on the sampled windows, in batches of the
    call's size (the last wrap-padded), as the call uploads them: its Viterbi
    scores in the sampled reads' window order."""
    import torch

    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.eval import pipeline

    mix = ctx.traffic
    cfg = C.read_config(os.path.join(ctx.config["model_dir"], "model.json"))
    model = pipeline.load_model(ctx.config["model_dir"], cfg, ctx.device)
    bf16 = "--bf16" in mix["flags"]
    x = np.concatenate([ref[n]["windows"] for n in sampled])
    frames = np.concatenate([ref[n]["frames"] for n in sampled]).astype(np.int32)
    batch = mix["batch_size"]
    out = []
    for i in range(0, len(x), batch):
        idx = np.resize(np.arange(i, min(i + batch, len(x))), batch)
        xb = torch.from_numpy(x[idx]).to(torch.bfloat16 if bf16 else torch.float32)
        packed = pipeline.decode_step(model, xb.to(ctx.device),
                                      torch.from_numpy(frames[idx]).to(ctx.device),
                                      beam=mix["beam"], bf16=bf16)
        _, _, score, _ = pipeline.unpack_step_outputs(packed.cpu().numpy())
        out.append(score[:min(batch, len(x) - i)])
    return np.concatenate(out)


def control(ctx: Context, precision: str) -> Dict[str, float]:
    """The numbers of the control: the reference computed in ``precision``
    put in the program's place (its window decodes and scores, and its reads
    assembled from them with its own path probabilities), judged as a run is."""
    from benchmark.reference import assembly

    state, _, _, input_dir, sampled = prepare(ctx)
    low = reference_of(ctx, state, input_dir, sampled, precision)
    jump_ratio = ctx.traffic["jump"] / ctx.traffic["segment_len"]
    outputs = {}
    for n, r in low.items():
        counts, qsum = ref_crf.assemble(r["segments"], r["probs"], jump_ratio)
        qual = "".join(chr(q + 33) for q in assembly.quality_values(counts, qsum))
        outputs[n] = {"segments": r["segments"], "consensus": assembly.consensus(counts),
                      "quality": qual}
    ref = reference_of(ctx, state, input_dir, sampled, "fp32")
    numbers = judge_outputs(ctx, [outputs], ref)
    numbers["score_gap"] = score_gap(np.concatenate([low[n]["scores"] for n in sampled]), ref,
                                     sampled)
    return numbers


def run(ctx: Context) -> Outcome:
    # the program's CRF model first: a program without it fails here, at once
    from chiron_tpu_torch.ops import crf  # noqa: F401

    import torch

    from chiron_tpu_torch import cli
    from chiron_tpu_torch.ops import host_build

    mix = ctx.traffic
    state, reads, names, input_dir, sampled = prepare(ctx)
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

    ref = reference_of(ctx, state, input_dir, sampled, "fp32")
    numbers = judge_outputs(ctx, kept, ref)
    numbers["score_gap"] = score_gap(program_scores(ctx, ref, sampled), ref, sampled)
    decoded = [len(s) for n in sampled for s in ref[n]["segments"]]
    print(f"reference bases a window over the sampled reads: {np.mean(decoded):.1f}",
          file=sys.stderr)
    work = {k: v * len(outs) for k, v in work_of_call(ctx, names).items()}
    work["calls"] = float(len(outs))
    return Outcome(metrics={"bases_per_s": bases / (end - start), "setup_s": setup_s},
                   attempted=attempted, failed=failed, numbers=numbers,
                   memory_peak_bytes=peak, trace=window.data, work=work)


# faults planted in the program for this runner's checks (benchmark/tests/
# test_bench_crf.py and the readings on the card), as benchmark/faults.py's


def alter_token(setattr_, module) -> None:
    from benchmark import faults

    faults.alter_token(setattr_, module)


def alter_answer(setattr_, module) -> None:
    from benchmark import faults

    faults.alter_answer(setattr_, module)


def perturb_score_column(setattr_, module) -> None:
    """One column of the edge scores M[t, s, c] raised by 1 in every frame and
    state: c = 1, the move that emits "A" (the head's outputs 4 s)."""
    real = module.crf_scores

    def perturbed(*a, **k):
        scores = real(*a, **k)
        scores[..., 0::4] += 1.0
        return scores

    setattr_(module, "crf_scores", perturbed)


FAULTS = {"token": ("chiron_tpu_torch.eval.pipeline", alter_token),
          "answer": ("chiron_tpu_torch.eval.pipeline", alter_answer),
          "score_column": ("chiron_tpu_torch.eval.pipeline", perturb_score_column)}


def plant(fault: str, setattr_) -> None:
    import importlib

    module, patch = FAULTS[fault]
    patch(setattr_, importlib.import_module(module))
