"""Runner of the training cells: the program's train step, its model and
optimizer built once, fed batch after batch as its trainer feeds them.

Set-up: labelled reads are simulated from the seed and cut into training
windows at base boundaries (a window takes consecutive bases while their
samples stay under ``segment_len``, and is kept where they fill more than
30% of it and hold more than 2 bases; the whole read normalised by its mean
and deviation first), each with its bases as labels (``label_width`` wide,
-1 padded). The rows are shuffled from the seed into batches of
``batch_size``. The model starts from the configuration's weights
(``benchmark/weights.py``: a user retraining a model) with the EMA copy, Adam at ``step_rate`` over a
schedule of ``max_steps`` and the step of ``train.loop.make_train_step``;
the first ``first_steps`` steps run in set-up, through the same step and
the same feed (``train.loop.batch_to_device``), on batches that all differ.

Window: the same object steps on, batch after batch, until ``--seconds``
have passed, and the window closes when the device has finished the last
step. ``train_windows_per_s`` is the rows stepped over the window. A step
whose loss is not finite fails.

Check: the reference runs the first steps from the checkpoint on the same
host batches, and ``reference.train.step_numbers`` compares the program's
losses, its first gradient (from Adam's first moment after one step) and
its change after the first steps, leaf by leaf.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np

from benchmark import reads as R
from benchmark.harness import Context, Outcome, memory_peak, model_dir, sync
from benchmark.reference.train import reference_steps, step_numbers
from benchmark.trace import Window


def cut_windows(seq: str, starts: np.ndarray, dwell: np.ndarray, signal: np.ndarray,
                seg: int, width: int):
    sig = signal.astype(np.float32)
    sig = (sig - np.mean(sig)) / np.float32(np.std(sig))
    ids = np.frombuffer(seq.encode(), np.uint8)
    ids = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), ids).astype(np.int32)
    csum = np.concatenate([[0], np.cumsum(dwell)])
    out = []
    j, n = 0, len(dwell)
    while j < n:
        k = int(np.searchsorted(csum, csum[j] + seg, side="left")) - 1
        if k >= n:
            break  # the read's end: the partial window is dropped
        k = max(k, j + 1)
        total = int(csum[k] - csum[j])
        if total > 0.3 * seg and 2 < k - j <= width and total < seg:
            x = np.zeros(seg, np.float32)
            piece = sig[starts[j]:starts[j] + seg]
            x[:len(piece)] = piece
            lab = np.full(width, -1, np.int32)
            lab[:k - j] = ids[j:k]
            out.append((x, total, lab, k - j))
        j = k
    return out


def make_batches(ctx: Context) -> List[Dict[str, np.ndarray]]:
    """Every batch of one pass over the seeded windows, in the seed's order
    (and the run's model directory, written once)."""
    mix = ctx.traffic
    model_dir(ctx)
    rows = []
    for _, seq, starts, dwell, signal in R.simulate_reads(mix["reads"], ctx.seed):
        rows += cut_windows(seq, starts, dwell, signal, mix["segment_len"], mix["label_width"])
    order = R.rng_for(ctx.seed, 1).permutation(len(rows))
    b = mix["batch_size"]
    batches = []
    for i in range(0, len(order) - b + 1, b):
        take = [rows[j] for j in order[i:i + b]]
        batches.append({"signal": np.stack([t[0] for t in take]),
                        "seq_len": np.asarray([t[1] for t in take], np.int32),
                        "label": np.stack([t[2] for t in take]),
                        "label_len": np.asarray([t[3] for t in take], np.int32)})
    return batches


def as_reference(batch: Dict[str, np.ndarray], stride: int, seg: int) -> Dict[str, np.ndarray]:
    ratio = seg / -(-seg // stride)
    return {"signal": batch["signal"], "frames": np.round(batch["seq_len"] / ratio)
            .astype(np.int32), "label": batch["label"], "label_len": batch["label_len"]}


def build(ctx: Context):
    """The program's training object: model, EMA copy, optimizer, step."""
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
    from chiron_tpu_torch.train.checkpoint import restore_latest
    from chiron_tpu_torch.train.loop import make_optimizer, make_train_step

    mix = ctx.traffic
    config = C.read_config(os.path.join(ctx.config["model_dir"], "model.json"))
    tree, _ = restore_latest(ctx.config["model_dir"])
    model = from_jax_params(tree, config, ctx.device).requires_grad_(True)
    ema = from_jax_params(to_numpy_tree(model), config, ctx.device)
    opt = make_optimizer(config.get("opt_method", "Adam"), mix["step_rate"], mix["max_steps"],
                         model.parameters())
    step = make_train_step(config, float(config.get("fl_gamma", 0)))
    return config, model, ema, opt, step


def run(ctx: Context) -> Outcome:
    import torch

    from chiron_tpu_torch.models.model import model_ratio
    from chiron_tpu_torch.train.loop import batch_to_device

    mix = ctx.traffic
    batches = make_batches(ctx)
    config, model, ema, opt, step = build(ctx)
    ratio = model_ratio(config, mix["segment_len"])
    start_params = {k: p.detach().clone() for k, p in model.flat.items()}
    first = mix["first_steps"]
    losses, first_grad = [], None
    n_steps = 0

    def one_step():
        nonlocal n_steps
        batch = batch_to_device(batches[n_steps % len(batches)], ratio, ctx.device)
        loss = step(model, ema, opt, batch, n_steps)
        n_steps += 1
        return loss

    for i in range(first):
        losses.append(one_step())
        if i == 0:  # Adam's first moment after one step is (1 - beta1) g
            state, beta1 = opt.opt.state, opt.opt.defaults["betas"][0]
            first_grad = {k: (state[p]["exp_avg"] / (1 - beta1)).detach().clone()
                          if "exp_avg" in state.get(p, {}) else torch.zeros_like(p.detach())
                          for k, p in model.flat.items()}
    got = {"losses": [float(v) for v in losses], "first_grad": first_grad,
           "change": {k: model.flat[k].detach() - v for k, v in start_params.items()}}
    sync(ctx.device)
    setup_s = time.time() - ctx.t0

    timed: List = []
    with Window(ctx.trace) as window:
        start = time.time()
        while not timed or time.time() - start < ctx.seconds:
            timed.append(one_step())
        sync(ctx.device)
        end = time.time()
    peak = memory_peak(ctx.device)
    bad = int((~torch.isfinite(torch.stack(timed))).sum())
    del model, ema, opt, step
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    want = reference_steps(ctx.config, [as_reference(b, ctx.config["stride"], mix["segment_len"])
                                        for b in batches[:first]], mix["step_rate"],
                           float(ctx.config["model"].get("fl_gamma", 0)), "fp32", ctx.device)
    numbers = step_numbers(got, want)
    rows = len(timed) * mix["batch_size"]
    frames_out = -(-mix["segment_len"] // ctx.config["stride"])
    frames = sum(float(np.round(batches[i % len(batches)]["seq_len"] / ratio).sum())
                 for i in range(first, first + len(timed)))
    work = {"steps": float(len(timed)), "windows": float(rows), "batches": float(len(timed)),
            "frames": frames, "frames_padded": float(rows * frames_out)}
    return Outcome(metrics={"train_windows_per_s": rows / (end - start), "setup_s": setup_s},
                   attempted=len(timed), failed=bad, numbers=numbers, memory_peak_bytes=peak,
                   trace=window.data, work=work)


def control(ctx: Context, precision: str) -> Dict[str, float]:
    """The numbers of the control: the reference computed in ``precision``
    put in the program's place, against the float32 reference."""
    mix = ctx.traffic
    batches = [as_reference(b, ctx.config["stride"], mix["segment_len"])
               for b in make_batches(ctx)[:mix["first_steps"]]]
    gamma = float(ctx.config["model"].get("fl_gamma", 0))
    low = reference_steps(ctx.config, batches, mix["step_rate"], gamma, precision, ctx.device)
    want = reference_steps(ctx.config, batches, mix["step_rate"], gamma, "fp32", ctx.device)
    return step_numbers(low, want)
