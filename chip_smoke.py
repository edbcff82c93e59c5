#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chiron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build every CUDA kernel from
     chiron_tpu_torch/csrc (one nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version ON THE CARD at the
     main path's shapes (dna-pre: batch 400, window 400, DNA_default), with
     TF32 off for every float32 matmul and convolution; conv_bn at every
     distinct shape of the three bundled fronts, bit-identical across two
     runs; the training LSTM forward also at H = 100 and 256, B = 1 and a
     ragged B, bit-identical across two runs; the recurrent
     kernels (one LSTM direction, GRU, BNLSTM, fused and single) also at a
     small H = 100 size, the BNLSTM bit-identical across two runs;
  3. drive the port's `call` entry point with -p dna-pre and the bundled
     DNA_default weights on seeded .signal reads (2-3 full batches), at beam
     30 and at beam 0, with every launch count set to 0 just before each run
     and read just after; check the fastq output, and check one full batch's
     step outputs on the card against the same step on the CPU; then the
     same `call` at beam 30 with a GRU and with a BNLSTM model (DNA_default's
     model.json with cell_type changed, fresh seeded weights written as a
     checkpoint), the forward-only stack `unirnn_layers` at full width for
     each cell type, and one `rna`-layer-type LSTM batch, each card vs CPU
     with its launch counts;
  4. drive the port's `train` entry point (DNA_default config, -s 400 -b 300,
     30 steps, fresh seeded weights) on seeded .signal/.label reads, with the
     training LSTM's launch counts set to 0 just before and read just after
     (6 forward + 6 backward per step); check the files it writes and that
     the loss falls; basecall one batch with its final checkpoint; check one
     full-width train step (bundled weights) on the card against the CPU;
  5. time each kernel, its plain version and a PyTorch library yardstick
     with CUDA events after a warm-up (conv_bn at each dna_model1 shape,
     cuDNN with TF32 off and, as a second yardstick, on); no kernel may
     read below its bound; the whole call in bases/s, and a warm
     train step split into forward / loss / backward / update;
  6. print the per-kernel JSON line, then {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(REPO, "chiron_tpu", "model", "DNA_default")
# H100 SXM published peaks: float32 outside the tensor cores, dense TF32 on
# the tensor cores, HBM3 rate
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
SEED = 0
BATCH, SEG, JUMP, BEAM = 400, 400, 390, 30
TRAIN_BATCH, TRAIN_STEPS, CPU_STEP_BATCH = 300, 30, 64
# At the CLI's default -t 4e-3 a fresh DNA_default reaches the CTC all-blank
# plateau within its first 10 steps and stays there, so the recorded steps
# 10/20/30 show no fall; at 1e-3 the descent spans the recorded steps.
TRAIN_RATE = 1e-3
LEVELS = np.array([100.0, 200.0, 300.0, 400.0])  # a learnable level per base (A, C, G, T)
# card vs CPU logits of one full batch, relative to max |logit|, every cell type
LOGIT_TOL = 5e-4


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(flops, nbytes, peak=PEAK_F32):
    """Least time for `flops` operations on the unit whose peak is given
    (the CUDA cores' float32 rate unless the kernel uses the tensor cores)
    and `nbytes` of traffic: (ms, which of the two bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv_bound(terms, w, stride, on_tensor_cores):
    """conv_bn's bound from its inputs. On the tensor cores the product is
    three TF32 products (3 x the FLOP over the TF32 peak); the narrow-input
    kernel runs on the CUDA cores. Bytes: every term and its affine read
    once, w read once, y and the moments written once."""
    bsz, t, cin = terms[0][0].shape
    k, _, cout = w.shape
    rows_out = bsz * (-(-t // stride))
    flops = 2.0 * rows_out * k * cin * cout
    nbytes = 4.0 * (len(terms) * (bsz * t * cin + 2 * cin) + k * cin * cout
                    + rows_out * cout + 2 * cout)
    if on_tensor_cores:
        return bound_ms(3 * flops, nbytes, PEAK_TF32) + ("3 x FLOP / 495 TFLOP/s TF32",)
    return bound_ms(flops, nbytes) + ("FLOP / 67 TFLOP/s float32",)


def time_ms(torch, fn, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def write_reads(sig_dir, n_reads, samples, rng):
    """Seeded synthetic squiggles: piecewise-constant levels (mean dwell ~9
    samples, the DNA_default regime) plus noise, as integer raw counts."""
    os.makedirs(sig_dir)
    for i in range(n_reads):
        n_events = samples // 5
        dwell = np.maximum(rng.geometric(1 / 9.0, n_events), 2)
        levels = rng.normal(500, 60, n_events)
        sig = np.repeat(levels, dwell)[:samples] + rng.normal(0, 12, samples)
        np.savetxt(os.path.join(sig_dir, f"read{i:02d}.signal"), sig.astype(np.int64), fmt="%d")


def write_train_reads(data_dir, n_reads, n_bases, rng):
    """Seeded .signal/.label pairs: one signal level per base, dwell 5-14
    samples, noise sd 5, 20 trailing samples (the tests' synthetic reads)."""
    os.makedirs(data_dir)
    for i in range(n_reads):
        bases = rng.randint(0, 4, n_bases)
        dwell = rng.randint(5, 15, n_bases)
        starts = np.concatenate([[0], np.cumsum(dwell)[:-1]])
        sig = np.repeat(LEVELS[bases], dwell)
        sig = np.concatenate([sig, np.full(20, LEVELS[bases[-1]])])
        sig = sig + rng.randn(sig.size) * 5.0
        np.savetxt(os.path.join(data_dir, f"read{i:02d}.signal"), sig, fmt="%.3f")
        with open(os.path.join(data_dir, f"read{i:02d}.label"), "w") as f:
            f.writelines(f"{s} {s + d} {'ACGT'[b]}\n" for s, d, b in zip(starts, dwell, bases))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    from chiron_tpu_torch import cli
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.models import layers as L, model as M, rnn as R
    from chiron_tpu_torch.ops import (beam, bilstm, bnlstm, conv_bn, cuda_build, gru, lstm,
                                      lstm_grad)
    from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
    from chiron_tpu_torch.train.checkpoint import restore_latest, save_checkpoint

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    logs = cuda_build.build_all()
    log(f"built {sorted(logs)} in {time.time() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            # the redesigned kernels must not spill: ptxas prints a function's
            # spill bytes two lines after its "Compiling entry function"
            if "Compiling entry function" in line and any(
                    k in line for k in ("conv_bn_mma_kernel", "conv_bn_direct_kernel",
                                        "lstm_fwd_kernel")):
                if "0 bytes spill stores, 0 bytes spill loads" not in lines[i + 2]:
                    fail(f"{name}: a redesigned kernel spills registers: {lines[i + 2].strip()}")

    # ---- 2. each kernel against its plain version on the card -------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    failures = []

    def max_err(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    def hold(name, err, tol, extra=""):
        ok = err <= tol
        log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e}) {extra}"
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        return err

    # conv_bn at every distinct shape of the three bundled fronts. dna_model1:
    # the k=3 convs (two deferred terms, relu), the k=1 256 -> 256 convs (7 of
    # its 12 launches a batch) and res1's first-layer convs (k=1, C_in=1);
    # rna_model2's front (k=9 stride 5, C_in=1) at the rna-pre batch
    # [300, 2000] and slow_model1's (k=8 stride 4) at the dna-slow-pre batch
    c = 256
    conv_cases = {
        "k3_two_terms_relu": ([(rnd(BATCH, SEG, c), rnd(c).abs() + 0.5, rnd(c, scale=0.2))
                               for _ in range(2)], rnd(3, c, c, scale=(2 / (4 * c)) ** 0.5), True, 1),
        "k1_cin1": ([(rnd(BATCH, SEG, 1), torch.ones(1, device=dev), torch.zeros(1, device=dev))],
                    rnd(1, 1, c, scale=(2 / (1 + c)) ** 0.5), False, 1),
        "k9_stride5_cin1": ([(rnd(300, 2000, 1), torch.ones(1, device=dev),
                              torch.zeros(1, device=dev))],
                            rnd(9, 1, c, scale=(2 / (9 + c)) ** 0.5), False, 5),
        "k1_two_terms_relu": ([(rnd(BATCH, SEG, c), rnd(c).abs() + 0.5, rnd(c, scale=0.2))
                               for _ in range(2)], rnd(1, c, c, scale=(2 / (2 * c)) ** 0.5), True, 1),
        "k8_stride4_cin1": ([(rnd(300, 2000, 1), torch.ones(1, device=dev),
                              torch.zeros(1, device=dev))],
                            rnd(8, 1, c, scale=(2 / (8 + c)) ** 0.5), False, 4),
    }
    conv_lib = cuda_build.load("conv_bn")
    conv_route = {case: conv_lib.conv_bn_route(w.shape[1], w.shape[2], w.shape[0], stride,
                                               int(len(terms) == 2))
                  for case, (terms, w, _, stride) in conv_cases.items()}
    log(f"  conv_bn routes (2 tensor cores, 1 narrow-input CUDA cores): {conv_route}")
    conv_err = 0.0
    for case, (terms, w, relu, stride) in conv_cases.items():
        y, s, q = conv_bn.conv_bn(terms, w, relu, stride)
        again = conv_bn.conv_bn(terms, w, relu, stride)
        py, ps, pq = conv_bn.conv_bn_plain(terms, w, relu, stride)
        torch.cuda.synchronize()
        if not all(torch.equal(a, g) for a, g in zip(again, (y, s, q))):
            failures.append(f"conv_bn {case} differs between two runs")
        mom = max(float(((s - ps).abs() / ps.abs().clamp(min=1.0)).max()),
                  float(((q - pq).abs() / pq.abs().clamp(min=1.0)).max()))
        hold(f"conv_bn {case} y", float((y - py).abs().max()), 1e-4)
        conv_err = max(conv_err, float((y - py).abs().max()))
        hold(f"conv_bn {case} moments (relative)", mom, 1e-4)

    # bilstm at one DNA_default layer: T = B = 400, H = 128, lengths with 0 and T
    t_len, h = SEG, 128
    xw_f, xw_b = rnd(t_len, BATCH, 4 * h), rnd(t_len, BATCH, 4 * h)
    wh_f, wh_b = rnd(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2), rnd(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2)
    lens = torch.randint(0, t_len + 1, (BATCH,), generator=gen).to(torch.int32)
    lens[0], lens[1] = 0, t_len
    lens = lens.to(dev)
    starts = (t_len - lens).to(torch.int32)
    lstm_args = (xw_f, xw_b, wh_f, wh_b, lens, starts)
    got = bilstm.bilstm_layer(*lstm_args)
    want = bilstm.bilstm_layer_plain(*lstm_args)
    torch.cuda.synchronize()
    lstm_err = hold("bilstm T=B=400 H=128", max(float((g - r).abs().max())
                                                  for g, r in zip(got, want)), 1e-4)

    # beam W=30 at B = T = 400 with length_bonus 0.6: random and peaky logits
    bonus = 0.6
    beam_lens = torch.randint(1, t_len + 1, (BATCH,), generator=gen).to(torch.int32)
    beam_lens[0], beam_lens[1] = 0, t_len
    beam_lens = beam_lens.to(dev)
    peak = torch.randint(0, 5, (BATCH, t_len), generator=gen)
    peaky = torch.full((BATCH, t_len, 5), -20.0).scatter_(2, peak[..., None], 20.0).to(dev)
    beam_inputs = {"random": torch.log_softmax(rnd(BATCH, t_len, 5, scale=2.0), -1),
                   "peaky": torch.log_softmax(peaky + rnd(BATCH, t_len, 5, scale=0.5), -1)}
    beam_err = tb_err = 0.0
    for case, lp in beam_inputs.items():
        trace, pb, pnb = beam.beam_search(lp, beam_lens, BEAM, bonus)
        ptrace, ppb, ppnb = beam.beam_search_plain(lp, beam_lens, BEAM, bonus)
        final = beam._lae(pb, pnb)
        best = torch.argmax(final, dim=1).to(torch.int32)
        chars = beam.beam_traceback(trace, best)
        pchars = beam.beam_traceback_plain(trace, best)
        torch.cuda.synchronize()
        mism = int((trace != ptrace).any(dim=(1, 2)).sum())
        live = ppb > -1e29
        err = max(float((pb - ppb)[live].abs().max()),
                  float((pnb - ppnb)[ppnb > -1e29].abs().max()))
        beam_err = max(beam_err, hold(f"beam_search {case} pb/pnb", err, 1e-4,
                                      f"(rows whose trace differs: {mism}, must be 0) "))
        if mism:
            failures.append(f"beam_search {case} trace")
        tb_mism = int((chars != pchars).sum())
        tb_err = max(tb_err, hold(f"beam_traceback {case} chars", float(tb_mism), 0))
    # the training LSTM at one DNA_default direction: T = 400, B = 300, H = 128,
    # lengths with 0 and T, random output gradient
    tb = TRAIN_BATCH
    xw_t = rnd(t_len, tb, 4 * h)
    wh_t = rnd(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2)
    lens_t = torch.randint(0, t_len + 1, (tb,), generator=gen).to(torch.int32)
    lens_t[0], lens_t[1] = 0, t_len
    lens_t = lens_t.to(dev)
    dhs_t = rnd(t_len, tb, h)
    fwd = lstm_grad.lstm_fwd_residuals(xw_t, wh_t, lens_t)
    fwd_p = lstm_grad.lstm_fwd_residuals_plain(xw_t, wh_t, lens_t)
    torch.cuda.synchronize()
    fwd_errs = {n: float((g - r).abs().max()) for n, g, r in zip(("out", "gates", "cc", "hc"),
                                                                 fwd, fwd_p)}
    fwd_err = hold("lstm_fwd_residuals T=400 B=300 H=128", max(fwd_errs.values()), 1e-5,
                   f"{json.dumps(fwd_errs)} ")
    fwd_again = lstm_grad.lstm_fwd_residuals(xw_t, wh_t, lens_t)
    fwd_same = all(torch.equal(a, g) for a, g in zip(fwd_again, fwd))
    # other widths and batch edges: a ragged slice per block (H = 100), a cluster
    # of 8 (H = 256), a single row, and a batch that is no multiple of the row tile
    for b_x, h_x in ((tb, 100), (tb, 256), (1, h), (tb + 1, h)):
        xw_x = rnd(t_len, b_x, 4 * h_x)
        wh_x = rnd(h_x, 4 * h_x, scale=(6 / (5 * h_x)) ** 0.5 / 2)
        lens_x = torch.randint(0, t_len + 1, (b_x,), generator=gen).to(torch.int32)
        lens_x[-1] = t_len
        lens_x = lens_x.to(dev)
        got_x = lstm_grad.lstm_fwd_residuals(xw_x, wh_x, lens_x)
        again_x = lstm_grad.lstm_fwd_residuals(xw_x, wh_x, lens_x)
        want_x = lstm_grad.lstm_fwd_residuals_plain(xw_x, wh_x, lens_x)
        torch.cuda.synchronize()
        hold(f"lstm_fwd_residuals T=400 B={b_x} H={h_x} (cluster, rows, shared bytes "
             f"{lstm_grad.fwd_geometry(b_x, h_x)})", max_err(got_x, want_x), 1e-5)
        fwd_same = fwd_same and all(torch.equal(a, g) for a, g in zip(again_x, got_x))
    log(f"  lstm_fwd_residuals bit-identical across two runs at every shape: {fwd_same}")
    if not fwd_same:
        failures.append("lstm_fwd_residuals differs between two runs")
    # the backward on the residuals the kernel forward wrote
    dxw_k, dwh_k = lstm_grad.lstm_bwd(*fwd[1:], dhs_t, wh_t, lens_t)
    dxw, dwh = lstm_grad.lstm_bwd(*fwd_p[1:], dhs_t, wh_t, lens_t)
    _, dwh_again = lstm_grad.lstm_bwd(*fwd_p[1:], dhs_t, wh_t, lens_t)
    dxw_p, dwh_p = lstm_grad.lstm_bwd_plain(*fwd_p[1:], dhs_t, wh_t, lens_t)
    torch.cuda.synchronize()
    dwh_scale = float(dwh_p.abs().max())
    dwh_abs = float((dwh - dwh_p).abs().max())
    bwd_err = max(hold("lstm_bwd dxw", float((dxw - dxw_p).abs().max()), 1e-4), dwh_abs)
    hold("lstm_bwd dxw on the kernel forward's residuals", float((dxw_k - dxw_p).abs().max()),
         1e-4)
    hold("lstm_bwd dwh on the kernel forward's residuals (relative to max |dwh|)",
         float((dwh_k - dwh_p).abs().max()) / dwh_scale, 1e-4)
    hold("lstm_bwd dwh (relative to max |dwh|)", dwh_abs / dwh_scale, 1e-4,
         f"(max |dwh| {dwh_scale:.2f}) ")
    if not torch.equal(dwh, dwh_again):
        failures.append("lstm_bwd dwh differs between two runs")
    log(f"  lstm_bwd dwh bit-identical across two runs: {torch.equal(dwh, dwh_again)}")

    # the other recurrent kernels: one LSTM direction (with and without start
    # offsets), the GRU and the BNLSTM, fused and single, with seeded lengths
    # that hold an empty row, full rows and partial rows. Eight rows are full:
    # with two or three rows active a BNLSTM column's variance can fall far
    # below eps, and rsqrt(var + 1e-5) then amplifies float32 rounding.
    def recurrent_inputs(t, b, hid):
        ws = (6 / (5 * hid)) ** 0.5 / 2
        ln = torch.randint(0, t + 1, (b,), generator=gen).to(torch.int32)
        ln[0], ln[1:9] = 0, t
        ln = ln.to(dev)

        def bn_weights():
            return (rnd(hid, 4 * hid, scale=2 * ws), rnd(4 * hid, scale=0.1),
                    0.1 + 0.2 * torch.rand(4 * hid, generator=gen).to(dev),
                    0.1 + 0.2 * torch.rand(4 * hid, generator=gen).to(dev),
                    0.1 + 0.2 * torch.rand(hid, generator=gen).to(dev), rnd(hid, scale=0.1))

        return {"lens": ln, "starts": (t - ln).to(torch.int32),
                "lstm": (rnd(t, b, 4 * hid), rnd(hid, 4 * hid, scale=ws)),
                "gru": (rnd(t, b, 2 * hid), rnd(t, b, hid), rnd(t, b, 2 * hid), rnd(t, b, hid),
                        (rnd(hid, 2 * hid, scale=ws), rnd(hid, hid, scale=ws)),
                        (rnd(hid, 2 * hid, scale=ws), rnd(hid, hid, scale=ws))),
                "bn": (rnd(t, b, 4 * hid), rnd(t, b, 4 * hid), bn_weights(), bn_weights())}

    def recurrent_holds(tag, case):
        ln, st = case["lens"], case["starts"]
        xw, wh = case["lstm"]
        got = [lstm.lstm_layer(xw, wh, ln, s) for s in (None, st)]
        want = [lstm.lstm_layer_plain(xw, wh, ln, s) for s in (None, st)]
        torch.cuda.synchronize()
        errs = {"lstm_layer": hold(f"lstm_layer {tag} (without and with starts)",
                                   max_err(got, want), 1e-4)}
        gx_f, cx_f, gx_b, cx_b, wh_f, wh_b = case["gru"]
        got = gru.bigru_layer(*case["gru"], ln, st)
        one = gru.gru_layer(gx_b, cx_b, *wh_b, ln, st)
        want = gru.bigru_layer_plain(*case["gru"], ln, st)
        torch.cuda.synchronize()
        errs["bigru_layer"] = hold(f"bigru_layer {tag}", max_err(got, want), 1e-4)
        errs["gru_layer"] = hold(f"gru_layer {tag} (with starts)", max_err([one], want[1:]), 1e-4)
        xw_f, xw_b, w_f, w_b = case["bn"]
        got = bnlstm.bibnlstm_layer(*case["bn"], ln)
        again = bnlstm.bibnlstm_layer(*case["bn"], ln)
        one = bnlstm.bnlstm_layer(xw_f, *w_f, ln)
        want = bnlstm.bibnlstm_layer_plain(*case["bn"], ln)
        torch.cuda.synchronize()
        errs["bibnlstm_layer"] = hold(f"bibnlstm_layer {tag}", max_err(got, want), 1e-4)
        errs["bnlstm_layer"] = hold(f"bnlstm_layer {tag}", max_err([one], want[:1]), 1e-4)
        same = all(torch.equal(a, g) for a, g in zip(again, got)) and torch.equal(one, got[0])
        log(f"  bibnlstm_layer {tag} bit-identical across two runs and to the single "
            f"direction: {same}")
        if not same:
            failures.append(f"bibnlstm_layer {tag} differs between runs")
        return errs

    rec_case = recurrent_inputs(t_len, BATCH, h)
    rec_err = recurrent_holds("T=B=400 H=128", rec_case)
    recurrent_holds("T=30 B=11 H=100", recurrent_inputs(30, 11, 100))
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")

    # ---- 3. the main path: `call -p dna-pre`, beam 30 and beam 0 ----------
    rng = np.random.RandomState(SEED)
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    work = tempfile.mkdtemp(dir=cuda_build.BUILD)
    sig_dir = os.path.join(work, "signal")
    n_reads, samples = 20, 40 * JUMP + 10  # 41 windows each: 820 = 2 full batches + 20
    write_reads(sig_dir, n_reads, samples, rng)
    n_windows = n_reads * (-(-samples // JUMP))
    n_batches = -(-n_windows // BATCH)
    expect = {"conv_bn": 12 * n_batches, "bilstm": 3 * n_batches,
              "beam_search": n_batches, "beam_traceback": n_batches}

    def reset():
        conv_bn.launches = bilstm.launches = lstm.launches = 0
        for counter in (beam.launches, gru.launches, bnlstm.launches):
            for k in counter:
                counter[k] = 0

    def counts():
        return {"conv_bn": conv_bn.launches, "bilstm": bilstm.launches, **beam.launches,
                "lstm_layer": lstm.launches,
                **{f"{k}_layer": n for k, n in {**gru.launches, **bnlstm.launches}.items()}}

    def call(out, beam_width, model=None):
        args = ["call", "-i", sig_dir, "-o", out, "-p", "dna-pre", "--sig_norm", "1",
                "--beam", str(beam_width), "--device", "cuda"]
        if model is not None:
            args += ["-m", model]
        t = time.time()
        res = cli.main(args)
        torch.cuda.synchronize()
        return res, time.time() - t

    def counted_call(label, width, model=None):
        """One `call` with every count set to 0 just before and read just
        after; checks the run's summary and its fastq files."""
        reset()
        res, wall = call(os.path.join(work, f"out_{label}"), width, model)
        cnt = counts()
        log(f"call -p dna-pre --beam {width} ({label}): {res['total_windows']} windows, "
            f"{res['total_bases']} bases in {wall:.3f} s; launches {cnt}")
        if res["n_files"] != n_reads or res["total_windows"] != n_windows:
            fail(f"{label}: expected {n_reads} files / {n_windows} windows, got {res}")
        result_dir = os.path.join(work, f"out_{label}", "result")
        fastqs = sorted(os.listdir(result_dir))
        if len(fastqs) != n_reads:
            fail(f"{label}: {len(fastqs)} fastq files written, expected {n_reads}")
        for f in fastqs:
            with open(os.path.join(result_dir, f)) as fh:
                lines = fh.read().splitlines()
            if len(lines) != 4 or not lines[1] or len(lines[1]) != len(lines[3]) \
                    or set(lines[1]) - set("ACGT"):
                fail(f"{label}: malformed fastq {f}")
        return cnt

    def check_counts(label, cnt, want):
        """Every count of the run must be the expected one, 0 where none is named."""
        bad = {k: (n, want.get(k, 0)) for k, n in cnt.items() if n != want.get(k, 0)}
        if bad:
            fail(f"{label} run: launches (got, expected) {bad}")

    beam_counts = counted_call("beam30", BEAM)
    check_counts("beam-30", beam_counts, expect)
    check_counts("beam-0", counted_call("beam0", 0),
                 {"conv_bn": expect["conv_bn"], "bilstm": expect["bilstm"]})

    # warm repeat of the beam-30 call for the end-to-end rate
    res, wall = call(os.path.join(work, "out_warm"), BEAM)
    call_rate = {"windows": n_windows, "bases": res["total_bases"], "seconds": wall,
                 "bases_per_s": res["total_bases"] / wall, "windows_per_s": n_windows / wall}
    log(f"warm call -p dna-pre --beam 30: {json.dumps(call_rate)}")

    # one full batch: the step on the card against the same step on the CPU
    config = C.read_config(os.path.join(MODEL_DIR, "model.json"))
    tree, _ = restore_latest(MODEL_DIR)
    gpu_model = from_jax_params(tree, config, "cuda")
    cpu_model = from_jax_params(tree, config, "cpu")
    flags = type("F", (), dict(batch_size=BATCH, segment_len=SEG, jump=JUMP, start=0,
                               sig_norm=1, reverse_fast5=False))()
    file_dir, files = pipeline.list_input_files(sig_dir)
    ratio = gpu_model.ratio(SEG)
    x, sl, _, _, _ = next(iter(pipeline._batch_stream(file_dir, files, flags, ratio)))
    xg, slg = torch.from_numpy(x).to(dev), torch.from_numpy(sl).to(dev)
    xc, slc = torch.from_numpy(x), torch.from_numpy(sl)
    lb = float(config["length_bonus"])

    def same_decodes(a, b):
        """How many windows decode to the same bases in (tokens, lengths) a and b."""
        return sum(bool(a[1][i] == b[1][i] and (a[0][i, :a[1][i]] == b[0][i, :b[1][i]]).all())
                   for i in range(BATCH))

    def step_card_vs_cpu(label, on_card, on_cpu, logit_tol, min_same=0.99):
        """One full batch, card against CPU: logits within logit_tol of max
        |logit|; the beam decoder on the card's own logits (kernel on the card,
        plain version on the CPU) the same for >= 99% of the windows; at least
        min_same of the windows decoding identically end to end."""
        logits_c = on_cpu(xc, slc)
        logits_g = on_card(xg, slg)
        logit_err = float((logits_g.cpu() - logits_c).abs().max())
        scale = float(logits_c.abs().max())
        hold(f"{label} step logits card vs CPU (relative to max |logit|)", logit_err / scale,
             logit_tol, f"(max |logit| {scale:.2f}) ")
        dec_kernel = [v.cpu().numpy() for v in beam.beam_search_decode(logits_g, slg, BEAM, lb)]
        dec_plain = [v.numpy() for v in beam.beam_search_decode(logits_g.cpu(), slc, BEAM, lb)]
        on_same = same_decodes(dec_kernel, dec_plain)
        step_g = pipeline.unpack_step_outputs(
            pipeline.decode_step(on_card, xg, slg, BEAM, lb).cpu().numpy())
        step_c = pipeline.unpack_step_outputs(
            pipeline.decode_step(on_cpu, xc, slc, BEAM, lb).numpy())
        same = same_decodes(step_g, step_c)
        log(f"  {label} step decodes: {on_same}/{BATCH} windows identical on the card's own "
            f"logits (kernel vs plain, must be >= 99%); {same}/{BATCH} identical card vs CPU end "
            f"to end (must be >= {min_same:.0%}: float32 rounding may flip a near-tie beam)")
        if failures or on_same < 0.99 * BATCH or same < min_same * BATCH:
            fail(f"{label}: card step disagrees with the CPU step: {failures}, identical "
                 f"{on_same} on the same logits, {same} end to end, of {BATCH}")

    # relative to the logits' scale: 12 batch-stat convs and 3 BiLSTM layers
    # whose float32 sums run in another order on the card than on the CPU.
    # Two correct CPU implementations (the JAX package and the port) differ
    # by 2.6e-4 of max |logit| on this batch, so 5e-4 is the float32 floor.
    step_card_vs_cpu("DNA_default", gpu_model, cpu_model, LOGIT_TOL)

    # ---- 3b. `call` with a GRU and with a BNLSTM model ----------------------
    # DNA_default's model.json with cell_type changed (length_bonus kept) and
    # fresh weights from init_model with a fixed seed, saved as a checkpoint
    # (the head's bias is zero, so scaling w_class scales the logits)
    with open(os.path.join(MODEL_DIR, "model.json")) as f:
        base_json = json.load(f)
    fused_name = {"GRU": "bigru_layer", "BNLSTM": "bibnlstm_layer"}
    cell_models, cell_counts, cell_rates = {}, {}, {}
    for cell in ("GRU", "BNLSTM"):
        mdir = os.path.join(work, f"model_{cell}")
        os.makedirs(mdir)
        with open(os.path.join(mdir, "model.json"), "w") as f:
            json.dump({**base_json, "rnn": {**base_json["rnn"], "cell_type": cell}}, f)
        cfg = C.read_config(os.path.join(mdir, "model.json"))
        fresh = from_jax_params(M.init_model(torch.Generator().manual_seed(SEED), cfg), cfg, "cuda")
        # At their initial scale the logits are near 0 and the posteriors near
        # uniform, so every beam is a near tie that float32 rounding flips.
        # Scale the head's class weights (by a power of two) so that the
        # logits have a trained model's scale, max |logit| ~ 10.
        fresh_tree = to_numpy_tree(fresh)
        gain = 2.0 ** round(np.log2(10.0 / float(fresh(xg, slg).abs().max())))
        fresh_tree["rnn"]["head"]["w_class"] = fresh_tree["rnn"]["head"]["w_class"] * gain
        log(f"{cell} model: fresh weights (seed {SEED}), head w_class scaled by {gain:g}")
        save_checkpoint(mdir, fresh_tree, 0)
        cell_counts[cell] = counted_call(cell, BEAM, mdir)
        check_counts(cell, cell_counts[cell],
                     {**expect, "bilstm": 0, fused_name[cell]: 3 * n_batches})
        res, wall = call(os.path.join(work, f"out_{cell}_warm"), BEAM, mdir)
        cell_rates[cell] = {"windows": n_windows, "bases": res["total_bases"], "seconds": wall,
                            "bases_per_s": res["total_bases"] / wall,
                            "windows_per_s": n_windows / wall}
        log(f"warm call -p dna-pre --beam 30 ({cell}): {json.dumps(cell_rates[cell])}")
        cell_tree, _ = restore_latest(mdir)
        cell_models[cell] = from_jax_params(cell_tree, cfg, "cuda")
        # a model with random weights emits ~200 bases a window from posteriors
        # with no structure: many hypotheses score within float32 rounding of
        # each other, and on an H100 97.5-99.5% of the windows decode as on
        # the CPU although the logits agree to 4e-6 of max |logit|. So the
        # end-to-end share is held at 95% here, and the decoder is held at
        # 99% on identical logits.
        step_card_vs_cpu(cell, cell_models[cell], from_jax_params(cell_tree, cfg, "cpu"),
                         LOGIT_TOL, min_same=0.95)

    # ---- 3c. the forward-only stack at full width, each cell type -----------
    uni_x = rnd(BATCH, SEG, 256)
    uni_name = {"LSTM": "lstm_layer", "GRU": "gru_layer", "BNLSTM": "bnlstm_layer"}
    uni_counts = {}
    for cell, kernel in uni_name.items():
        uni = R.init_unirnn_layers(torch.Generator().manual_seed(SEED), 256, 128, 3, 5, cell)
        uni_g = {k: [{n: w.to(dev) for n, w in layer.items()} for layer in v]
                 if k == "layers" else v.to(dev) for k, v in uni.items()}
        with torch.no_grad():
            reset()
            out_g = R.unirnn_layers(uni_g, uni_x, slg, cell)
            torch.cuda.synchronize()
            cnt = counts()
            out_c = R.unirnn_layers(uni, uni_x.cpu(), slc, cell)
        check_counts(f"unirnn_layers {cell}", cnt, {kernel: 3})
        uni_counts[kernel] = cnt[kernel]
        scale = float(out_c.abs().max())
        hold(f"unirnn_layers {cell} [400, 400, 256] card vs CPU (relative to max |logit|)",
             float((out_g.cpu() - out_c).abs().max()) / scale, LOGIT_TOL,
             f"(max |logit| {scale:.3f}; launches {kernel}: {cnt[kernel]}) ")

    # ---- 3d. one `rna`-layer-type LSTM batch through apply_model ------------
    rna_cfg = {**config, "rnn": {**config["rnn"], "layer_type": "rna"}}
    rna_tree = to_numpy_tree(from_jax_params(
        M.init_model(torch.Generator().manual_seed(SEED), rna_cfg), rna_cfg, "cpu"))
    reset()
    rna_g = from_jax_params(rna_tree, rna_cfg, "cuda")(xg, slg)
    torch.cuda.synchronize()
    check_counts("rna-type LSTM batch", counts(), {"conv_bn": 12, "bilstm": 3})
    rna_c = from_jax_params(rna_tree, rna_cfg, "cpu")(xc, slc)
    scale = float(rna_c.abs().max())
    hold("rna-type LSTM stack, one batch, logits card vs CPU (relative to max |logit|)",
         float((rna_g.cpu() - rna_c).abs().max()) / scale, LOGIT_TOL,
         f"(max |logit| {scale:.3f}) ")
    if failures:
        fail(f"card disagrees with the CPU: {failures}")

    # ---- 4. the training path: `train` at DNA_default width ----------------
    from chiron_tpu_torch.ops.ctc_loss import ctc_focal_loss
    from chiron_tpu_torch.train import loop

    train_dir, valid_dir = os.path.join(work, "train"), os.path.join(work, "valid")
    write_train_reads(train_dir, 16, 2000, rng)  # ~750 windows of 400 samples
    write_train_reads(valid_dir, 2, 1000, rng)
    log_dir = os.path.join(work, "log")
    train_args = ["train", "-i", train_dir, "-o", log_dir, "-m", "dna", "-v", valid_dir,
                  "--configure", os.path.join(MODEL_DIR, "model.json"), "-s", str(SEG),
                  "-b", str(TRAIN_BATCH), "-x", str(TRAIN_STEPS), "-t", str(TRAIN_RATE),
                  "--device", "cuda"]
    for k in lstm_grad.launches:
        lstm_grad.launches[k] = 0
    t = time.time()
    result = cli.main(train_args)
    torch.cuda.synchronize()
    train_wall = time.time() - t
    train_counts = dict(lstm_grad.launches)
    log(f"train -s {SEG} -b {TRAIN_BATCH} -x {TRAIN_STEPS} -t {TRAIN_RATE}: {train_wall:.3f} s, losses "
        f"{result['losses']}; launches {train_counts}")
    for k, n in train_counts.items():
        if n != 6 * TRAIN_STEPS:
            fail(f"train launched {k} {n} times, expected {6 * TRAIN_STEPS}")
    mdir = result["model_dir"]
    names = os.listdir(mdir)
    for want in ("model.json", "checkpoint", "metrics.jsonl", f"final-{TRAIN_STEPS}.npz",
                 f"ema-{TRAIN_STEPS}.npz"):
        if want not in names:
            fail(f"train did not write {want} (wrote {sorted(names)})")
    with open(os.path.join(mdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows]
    log(f"  metrics.jsonl: " + json.dumps(rows))
    if [r["step"] for r in rows] != [10, 20, 30] or not np.all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        fail(f"train losses {losses}: expected finite at steps 10, 20, 30 and falling")
    # close the loop with the call path: basecall one batch with the final checkpoint
    trained_tree, trained_step = restore_latest(mdir)
    trained = from_jax_params(trained_tree, C.read_config(os.path.join(mdir, "model.json")),
                              "cuda")
    dec_lens = pipeline.unpack_step_outputs(
        pipeline.decode_step(trained, xg, slg, BEAM, 0.0).cpu().numpy())[1]
    if trained_step != TRAIN_STEPS or dec_lens.shape != (BATCH,) \
            or not ((dec_lens >= 0) & (dec_lens <= SEG)).all():
        fail(f"basecalling with the trained checkpoint (step {trained_step}) failed")
    log(f"  basecalled one batch with final-{trained_step}: {int(dec_lens.sum())} bases")

    # one full-width train step (bundled DNA_default weights) on the card vs the CPU
    dataset = loop.load_dataset(train_dir, SEG)
    if dataset.n < 2 * TRAIN_BATCH:
        fail(f"only {dataset.n} training windows, expected well over {TRAIN_BATCH}")
    step_ratio = gpu_model.ratio(SEG)
    cpu_batch = dataset.next_batch(CPU_STEP_BATCH)

    def value_and_grad(device):
        m = from_jax_params(tree, config, device).requires_grad_(True)
        b = loop.batch_to_device(cpu_batch, step_ratio, torch.device(device))
        loss = ctc_focal_loss(m(b["signal"], b["seq_len"], training=True), b["seq_len"],
                              b["label"], b["label_len"], float(config["fl_gamma"]))
        loss.backward()
        return float(loss.detach()), {k: p.grad.cpu() for k, p in m.flat.items()}

    loss_g, grads_g = value_and_grad("cuda")
    loss_c, grads_c = value_and_grad("cpu")
    hold(f"train step loss card vs CPU ({CPU_STEP_BATCH} windows, relative)",
         abs(loss_g - loss_c) / abs(loss_c), 1e-4, f"(loss {loss_c:.4f}) ")
    # each leaf within 1e-2 of its own max |grad| plus 1e-4 of the largest
    # |grad| of all leaves: 12 batch-stat convs, 3 BiLSTM layers and the CTC
    # recursions sum in another order on the card. The absolute floor is for
    # res1's branch1/conv2a, which read the 1-channel signal straight into a
    # batch-stat BN: their output does not depend on w's scale, so their
    # exact gradient is ~0 and both sides compute float32 cancellation noise.
    top = max(float(g.abs().max()) for g in grads_c.values())
    grad_spread = {k: float((grads_g[k] - g).abs().max()) for k, g in grads_c.items()}
    grad_ratio = {k: e / (1e-2 * float(grads_c[k].abs().max()) + 1e-4 * top)
                  for k, e in grad_spread.items()}
    own = sorted(e / max(float(grads_c[k].abs().max()), 1e-30) for k, e in grad_spread.items())
    worst = sorted(grad_ratio, key=grad_ratio.get)[-3:]
    hold("train step gradients card vs CPU (worst leaf: err / (1e-2 own max + 1e-4 top))",
         grad_ratio[worst[-1]], 1.0,
         f"(largest |grad| {top:.3e}; worst leaves "
         + json.dumps({k: [grad_spread[k], float(grads_c[k].abs().max())] for k in worst})
         + f"; per-leaf err / own max: median {own[len(own) // 2]:.2e}, 90th percentile "
         f"{own[int(0.9 * len(own))]:.2e}) ")
    if failures:
        fail(f"card train step disagrees with the CPU step: {failures}")

    # ---- 5. timing ----------------------------------------------------------
    # where one warm full-batch step's device time goes (CUDA events)
    front = M.CNN_ZOO[config["cnn"]["model"]][1]

    def step_parts(model=gpu_model):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        rnn_cfg = model.config["rnn"]
        with torch.no_grad():
            ev[0].record()
            fea = L.materialize(front(model.params["cnn"], xg[..., None]))
            ev[1].record()
            logits = R.rnn_layers(model.params["rnn"], fea, slg, rnn_cfg["cell_type"],
                                  rnn_cfg["layer_type"])
            ev[2].record()
            prob = pipeline.path_prob(logits)
            dec = beam.beam_search_decode(logits, slg, BEAM, lb)
            ev[3].record()
            pipeline.pack_step_outputs(*dec, prob)
            ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    step_parts()
    parts = np.mean([step_parts() for _ in range(3)], axis=0)
    log("one dna-pre beam-30 step, device ms: " + json.dumps(dict(zip(
        ("cnn_front", "bilstm_stack_and_head", "path_prob_and_beam_decode", "pack"),
        [float(v) for v in parts]))))
    for cell, cell_model in cell_models.items():
        step_parts(cell_model)
        cparts = np.mean([step_parts(cell_model) for _ in range(3)], axis=0)
        log(f"one dna-pre beam-30 step with the {cell} model, device ms: " + json.dumps(dict(zip(
            ("cnn_front", "rnn_stack_and_head", "path_prob_and_beam_decode", "pack"),
            [float(v) for v in cparts]))))
    # the device's busy share over one warm call (torch.profiler kernel time)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_p = call(os.path.join(work, "out_prof"), BEAM)
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_s = sum(kern.values()) / 1e6
    if busy_s > 0:
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        log(f"profiled warm call: wall {wall_p:.3f} s, device busy {busy_s:.3f} s, idle share "
            f"{1 - busy_s / wall_p:.3f}; top device time (ms): "
            + json.dumps({k[:60]: round(v / 1e3, 3) for k, v in top}))
    else:
        log("profiled warm call: device busy share not measured (no device events)")

    # a warm train step at -s 400 -b 300 (fresh seeded weights), split with
    # CUDA events, then steps/s over warm steps and the idle share of a
    # profiled short `train` run
    model_t = from_jax_params(M.init_model(torch.Generator().manual_seed(SEED), config),
                              config, "cuda").requires_grad_(True)
    ema_t = from_jax_params(to_numpy_tree(model_t), config, "cuda")
    opt_t = loop.make_optimizer("Adam", TRAIN_RATE, 10000, model_t.parameters())
    batch_t = loop.batch_to_device(dataset.next_batch(TRAIN_BATCH), step_ratio, dev)
    step_fn = loop.make_train_step(config, float(config["fl_gamma"]))

    def train_parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        logits = model_t(batch_t["signal"], batch_t["seq_len"], training=True)
        ev[1].record()
        loss = ctc_focal_loss(logits, batch_t["seq_len"], batch_t["label"],
                              batch_t["label_len"], float(config["fl_gamma"]))
        ev[2].record()
        opt_t.zero_grad()
        loss.backward()
        ev[3].record()
        opt_t.step()
        loop.ema_update(ema_t, model_t, opt_t.count)
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    train_parts()
    tparts = np.mean([train_parts() for _ in range(3)], axis=0)
    log("one warm train step (-s 400 -b 300), device ms: " + json.dumps(dict(zip(
        ("forward", "loss", "backward", "update_and_ema"), [float(v) for v in tparts]))))
    n_steps = 5
    torch.cuda.synchronize()
    t = time.time()
    for i in range(n_steps):
        step_fn(model_t, ema_t, opt_t, batch_t, i)
    torch.cuda.synchronize()
    step_s = (time.time() - t) / n_steps
    train_rate = {"seconds_per_step": step_s, "steps_per_s": 1 / step_s,
                  "windows_per_s": TRAIN_BATCH / step_s}
    log(f"warm train steps: {json.dumps(train_rate)}")
    lg = model_t(batch_t["signal"], batch_t["seq_len"], training=True).detach()
    lg.requires_grad_(True)
    ctc_args = (batch_t["seq_len"], batch_t["label"], batch_t["label_len"], 2.0)
    ctc_fwd_ms = time_ms(torch, lambda: ctc_focal_loss(lg, *ctc_args), 3, 1)
    ctc_both_ms = time_ms(torch, lambda: ctc_focal_loss(lg, *ctc_args).backward(), 3, 1)
    log(f"ctc_focal_loss at B={TRAIN_BATCH} T={SEG} U={int(batch_t['label'].shape[1])}: "
        f"forward {ctc_fwd_ms:.3f} ms, forward+backward {ctc_both_ms:.3f} ms")
    prof_args = list(train_args)
    prof_args[prof_args.index("-m") + 1] = "dna_prof"
    prof_args[prof_args.index("-x") + 1] = "10"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        cli.main(prof_args)
        torch.cuda.synchronize()
        wall_t = time.time() - t
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_t = sum(kern.values()) / 1e6
    if busy_t > 0:
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
        log(f"profiled train -x 10: wall {wall_t:.3f} s, device busy {busy_t:.3f} s, idle "
            f"share {1 - busy_t / wall_t:.3f}; top device time (ms): "
            + json.dumps({k[:60]: round(v / 1e3, 3) for k, v in top}))
    else:
        log("profiled train: device busy share not measured (no device events)")

    # conv_bn at each dna_model1 shape (stride 1): the kernel, its plain version
    # and the library yardstick F.conv1d + F.batch_norm on the normalised input
    # (cuDNN; the prologue is not timed), with TF32 off as everywhere here and,
    # as a second yardstick, with cuDNN's TF32 convolutions allowed
    F = torch.nn.functional
    conv_shapes = {}
    for case in ("k3_two_terms_relu", "k1_two_terms_relu", "k1_cin1"):
        terms, w, relu, stride = conv_cases[case]
        z = sum(r * a + b for r, a, b in terms)
        z_ncw = (torch.relu(z) if relu else z).transpose(1, 2).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()
        pad = (w.shape[0] - 1) // 2

        def library():
            return F.batch_norm(F.conv1d(z_ncw, w_oik, padding=pad), None, None, training=True)

        ms = time_ms(torch, lambda: conv_bn.conv_bn(terms, w, relu, stride), 10)
        plain_ms = time_ms(torch, lambda: conv_bn.conv_bn_plain(terms, w, relu, stride), 5)
        lib_ms = time_ms(torch, library, 10)
        torch.backends.cudnn.allow_tf32 = True
        lib_tf32_ms = time_ms(torch, library, 10)
        torch.backends.cudnn.allow_tf32 = False
        b_ms, b_by, b_unit = conv_bound(terms, w, stride, conv_route[case] == 2)
        conv_shapes[case] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "bound_unit": b_unit, "library_ms": lib_ms,
                             "library_tf32_ms": lib_tf32_ms, "route": conv_route[case]}
        if ms < b_ms:
            fail(f"conv_bn {case}: {ms:.4f} ms reads below its bound {b_ms:.4f} ms")
    log("conv_bn at dna_model1's shapes, [400, 400] batch (3 / 7 / 2 of the 12 launches a "
        "batch; library = F.conv1d + F.batch_norm, cuDNN TF32 off / on): "
        + json.dumps(conv_shapes))
    main_conv = conv_shapes["k3_two_terms_relu"]
    timing = {"conv_bn": (main_conv["ms"], main_conv["plain_ms"], main_conv["library_ms"])}
    lstm_lib = torch.nn.LSTM(256, h, batch_first=False, bidirectional=True).to(dev)
    x_lib = rnd(t_len, BATCH, 256)
    with torch.no_grad():
        timing["bilstm"] = (time_ms(torch, lambda: bilstm.bilstm_layer(*lstm_args), 5),
                            time_ms(torch, lambda: bilstm.bilstm_layer_plain(*lstm_args), 2, 1),
                            time_ms(torch, lambda: lstm_lib(x_lib), 5))
    lp = beam_inputs["random"]
    trace, pb, pnb = beam.beam_search(lp, beam_lens, BEAM, bonus)
    best = torch.argmax(beam._lae(pb, pnb), dim=1).to(torch.int32)
    timing["beam_search"] = (time_ms(torch, lambda: beam.beam_search(lp, beam_lens, BEAM, bonus), 5),
                             time_ms(torch, lambda: beam.beam_search_plain(lp, beam_lens, BEAM, bonus), 2, 1),
                             None)
    timing["beam_traceback"] = (time_ms(torch, lambda: beam.beam_traceback(trace, best), 20),
                                time_ms(torch, lambda: beam.beam_traceback_plain(trace, best), 3, 1),
                                None)

    # the other recurrent kernels on the held inputs; library: cuDNN's LSTM for
    # one direction (input projection included, lengths ignored). None for
    # the GRU (cuDNN's GRU applies r after the recurrent product, another
    # function) and for the BNLSTM.
    rl, rs = rec_case["lens"], rec_case["starts"]
    lstm_one = torch.nn.LSTM(256, h).to(dev)
    gx_b, cx_b, wh_gru_b = rec_case["gru"][2], rec_case["gru"][3], rec_case["gru"][5]
    bn_xw, bn_w = rec_case["bn"][0], rec_case["bn"][2]
    with torch.no_grad():
        timing["lstm_layer"] = (
            time_ms(torch, lambda: lstm.lstm_layer(*rec_case["lstm"], rl, rs), 5),
            time_ms(torch, lambda: lstm.lstm_layer_plain(*rec_case["lstm"], rl, rs), 2, 1),
            time_ms(torch, lambda: lstm_one(x_lib), 5))
        timing["bigru_layer"] = (
            time_ms(torch, lambda: gru.bigru_layer(*rec_case["gru"], rl, rs), 5),
            time_ms(torch, lambda: gru.bigru_layer_plain(*rec_case["gru"], rl, rs), 2, 1), None)
        timing["gru_layer"] = (
            time_ms(torch, lambda: gru.gru_layer(gx_b, cx_b, *wh_gru_b, rl, rs), 5),
            time_ms(torch, lambda: gru.gru_layer_plain(gx_b, cx_b, *wh_gru_b, rl, rs), 2, 1),
            None)
        timing["bibnlstm_layer"] = (
            time_ms(torch, lambda: bnlstm.bibnlstm_layer(*rec_case["bn"], rl), 5),
            time_ms(torch, lambda: bnlstm.bibnlstm_layer_plain(*rec_case["bn"], rl), 2, 1), None)
        timing["bnlstm_layer"] = (
            time_ms(torch, lambda: bnlstm.bnlstm_layer(bn_xw, *bn_w, rl), 5),
            time_ms(torch, lambda: bnlstm.bnlstm_layer_plain(bn_xw, *bn_w, rl), 2, 1), None)

    res_t = lstm_grad.lstm_fwd_residuals(xw_t, wh_t, lens_t)
    lib_lstm = torch.nn.LSTM(2 * h, h).to(dev)
    x_lstm = rnd(t_len, tb, 2 * h).requires_grad_(True)
    out_lib, _ = lib_lstm(x_lstm)
    lib_inputs = [x_lstm] + list(lib_lstm.parameters())
    timing["lstm_fwd_residuals"] = (
        time_ms(torch, lambda: lstm_grad.lstm_fwd_residuals(xw_t, wh_t, lens_t), 5),
        time_ms(torch, lambda: lstm_grad.lstm_fwd_residuals_plain(xw_t, wh_t, lens_t), 2, 1),
        time_ms(torch, lambda: lib_lstm(x_lstm), 5))
    timing["lstm_bwd"] = (
        time_ms(torch, lambda: lstm_grad.lstm_bwd(*res_t[1:], dhs_t, wh_t, lens_t), 5),
        time_ms(torch, lambda: lstm_grad.lstm_bwd_plain(*res_t[1:], dhs_t, wh_t, lens_t), 2, 1),
        time_ms(torch, lambda: torch.autograd.grad(out_lib, lib_inputs, dhs_t,
                                                   retain_graph=True), 5))

    # bounds from this run's inputs (bytes: each input read once, each output
    # written once; operations: what these inputs need)
    active = float(lens.sum())  # active (row, step) pairs per direction
    lstm_flops = 2 * active * (2 * h * 4 * h + 12 * h)
    lstm_bytes = 4.0 * (2 * t_len * BATCH * 4 * h + 2 * h * 4 * h + 2 * BATCH
                        + 2 * t_len * BATCH * h)
    steps = float(beam_lens.sum())
    cand = BEAM * 5
    # per active step: candidate scoring (~8 ops each), the [4W x W] hash
    # merge compare, and a top-W selection of ~cand * log2(cand) compares
    beam_ops = steps * (8 * cand + 4 * BEAM * BEAM + cand * np.log2(cand))
    beam_bytes = 4.0 * (BATCH * t_len * 5 + BATCH + BATCH * t_len * BEAM + 2 * BATCH * BEAM)
    tb_bytes = 4.0 * (BATCH + BATCH * t_len + BATCH * t_len)  # best, path reads, chars
    # training LSTM, per active (row, step): forward h @ wh plus ~12H gate ops;
    # backward da @ wh^T and h^T da (dwh) plus ~20H gate-gradient ops
    active_t = float(lens_t.sum())
    rows_t = t_len * tb
    fwd_flops = active_t * (2 * h * 4 * h + 12 * h)
    fwd_bytes = 4.0 * (rows_t * 4 * h + h * 4 * h + tb + 3 * rows_t * h + rows_t * 4 * h)
    bwd_flops = active_t * (2 * 2 * h * 4 * h + 20 * h)
    bwd_bytes = 4.0 * (rows_t * 4 * h + 3 * rows_t * h + h * 4 * h + tb + rows_t * 4 * h
                       + h * 4 * h)
    # the other recurrent kernels, per active (row, step) of one direction:
    # LSTM h @ wh + ~12H gate ops; GRU h @ whg and (r * h) @ whc + ~10H; BNLSTM
    # the LSTM's plus ~40H for the three normalisations. Bytes: the input
    # projections in, the weights and vectors, lengths (and starts), h out.
    act = float(rl.sum())
    cells_tb = t_len * BATCH
    one_lstm = (act * (2 * h * 4 * h + 12 * h),
                4.0 * (cells_tb * 4 * h + h * 4 * h + 2 * BATCH + cells_tb * h))
    one_gru = (act * (2 * h * 3 * h + 10 * h),
               4.0 * (cells_tb * 3 * h + h * 3 * h + 2 * BATCH + cells_tb * h))
    one_bn = (act * (2 * h * 4 * h + 52 * h),
              4.0 * (cells_tb * 4 * h + h * 4 * h + 14 * h + BATCH + cells_tb * h))
    bounds = {"lstm_layer": bound_ms(*one_lstm),
              "bigru_layer": bound_ms(2 * one_gru[0], 2 * one_gru[1]),
              "gru_layer": bound_ms(*one_gru),
              "bnlstm_layer": bound_ms(*one_bn),
              "bibnlstm_layer": bound_ms(2 * one_bn[0], 2 * one_bn[1]),
              "lstm_fwd_residuals": bound_ms(fwd_flops, fwd_bytes),
              "lstm_bwd": bound_ms(bwd_flops, bwd_bytes),
              "conv_bn": (main_conv["bound_ms"], main_conv["bound_by"]),
              "bilstm": bound_ms(lstm_flops, lstm_bytes),
              "beam_search": bound_ms(beam_ops, beam_bytes),
              "beam_traceback": bound_ms(BATCH * t_len, tb_bytes)}
    meta = {
        "conv_bn": ("chiron_tpu_torch/csrc/conv_bn.cu", "chiron_tpu/ops/pallas/convbn.py:188",
                    conv_err),
        "bilstm": ("chiron_tpu_torch/csrc/bilstm.cu", "chiron_tpu/ops/pallas/lstm.py:254",
                   lstm_err),
        "beam_search": ("chiron_tpu_torch/csrc/beam.cu", "chiron_tpu/ops/pallas/beam.py:418",
                        beam_err),
        "beam_traceback": ("chiron_tpu_torch/csrc/beam.cu", "chiron_tpu/ops/pallas/beam.py:462",
                           tb_err),
        "lstm_layer": ("chiron_tpu_torch/csrc/bilstm.cu", "chiron_tpu/ops/pallas/lstm.py:141",
                       rec_err["lstm_layer"]),
        "lstm_fwd_residuals": ("chiron_tpu_torch/csrc/lstm_grad.cu",
                               "chiron_tpu/ops/pallas/lstm_grad.py:120", fwd_err),
        "lstm_bwd": ("chiron_tpu_torch/csrc/lstm_grad.cu",
                     "chiron_tpu/ops/pallas/lstm_grad.py:174", bwd_err),
        "bigru_layer": ("chiron_tpu_torch/csrc/gru.cu", "chiron_tpu/ops/pallas/gru.py:161",
                        rec_err["bigru_layer"]),
        "gru_layer": ("chiron_tpu_torch/csrc/gru.cu", "chiron_tpu/ops/pallas/gru.py:230",
                      rec_err["gru_layer"]),
        "bnlstm_layer": ("chiron_tpu_torch/csrc/bnlstm.cu", "chiron_tpu/ops/pallas/bnlstm.py:133",
                         rec_err["bnlstm_layer"]),
        "bibnlstm_layer": ("chiron_tpu_torch/csrc/bnlstm.cu",
                           "chiron_tpu/ops/pallas/bnlstm.py:261", rec_err["bibnlstm_layer"]),
    }
    # each count is from the run that drives its kernel: the DNA_default beam-30
    # call, the train run, the GRU and BNLSTM calls, the forward-only stacks
    path_launches = {**beam_counts, **train_counts, **uni_counts,
                     "bigru_layer": cell_counts["GRU"]["bigru_layer"],
                     "bibnlstm_layer": cell_counts["BNLSTM"]["bibnlstm_layer"]}
    kernels = []
    for name, (source, replaces, err) in meta.items():
        ms, plain_ms, lib_ms = timing[name]
        b_ms, b_by = bounds[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": path_launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms})
    log(f"  bounds: conv_bn's operations are {main_conv['bound_unit']} (tensor cores); every "
        "other kernel's are FLOP / 67 TFLOP/s float32 (CUDA cores); bytes / 3.35 TB/s")
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound "
            f"{k['bound_ms']:.4f} by {k['bound_by']}, library {k['library_ms']})")
        if k["ms"] < k["bound_ms"]:
            fail(f"{k['name']}: {k['ms']:.4f} ms reads below its bound {k['bound_ms']:.4f} ms: "
                 "the count of its work is wrong")
    shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"call_dna_pre_beam30": call_rate, "train_s400_b300": train_rate,
                    **{f"call_dna_pre_beam30_{c}": r for c, r in cell_rates.items()}}))
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
