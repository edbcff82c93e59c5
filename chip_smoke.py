#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chiron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

DIR (default chiron_tpu_torch/_build/chip_smoke, gitignored) receives the
windows of a call step that decode differently on the card and on the CPU.

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build every CUDA kernel from
     chiron_tpu_torch/csrc (one nvcc per library, all started together; the
     LSTM inference kernel's bf16 instance is a library of its own), with
     each library's nvcc time;
  2. hold each kernel against its plain PyTorch version ON THE CARD at the
     main path's shapes (dna-pre: batch 400, window 400, DNA_default), with
     TF32 off for every float32 matmul and convolution; conv_bn at every
     distinct shape of the three bundled fronts, bit-identical across two
     runs; the LSTM inference kernel (fused and one direction, with and
     without starts) also at H = 100 and 256, B = 1 and 301, and the training
     LSTM forward and backward also at H = 100 and 256, B = 1 and 301, each
     bit-identical across two runs and printed with its cluster geometry; the
     recurrent kernels (one LSTM direction, GRU, BNLSTM, fused and single)
     also at a small H = 100 size, the BNLSTM bit-identical across two runs
     and fused == single, printed with the instance and geometry it takes
     (ops/bnlstm.py:geometry: the cluster kernel at dna-pre's width, the
     cooperative kernel where no cluster holds the shape, both driven);
     every recurrent kernel at H = 384 and 512 (T = 100, B = 1 / 64 / 301),
     where the LSTM kernels read wh from device memory; the GRU at H = 16,
     100, 128, 256, 384 and 512 and B = 1, 64, 301 and 400 (T = 30), at the
     instance ops/gru.py chooses and with each instance forced (resident:
     the weights in shared memory, where they fit; streamed: from device
     memory), equal bit for bit across runs, to two single launches and to
     each other, both instances driven; the beam search at
     W = 30 (the warp kernel; random, peaky and tied scores) and at W = 65,
     100, 256 and C = 10 (the block kernel), exact and bit-identical across
     two runs; the bf16 instances (bf16 inference mode) of conv_bn at every
     distinct shape of the fronts with one and two terms, and of the LSTM
     inference kernel, fused and one direction with and without starts, at
     T = 400, B = 400 / 1 / 301, H = 128 and B = 400, H = 100, each held in
     the working type (outputs equal or one bf16 ulp apart, identical on >=
     99.9%; moments 1e-4), bit-identical across two runs and to the float32
     instance on the upcast input with its output rounded;
  3. drive the port's `call` entry point with -p dna-pre and the bundled
     DNA_default weights on seeded .signal reads (2-3 full batches), at beam
     30 and at beam 0, and at beam 30 with --bf16, with every launch count
     (per dtype instance for conv_bn and the LSTM inference kernel) set to 0
     just before each run and read just after; check the fastq output, and
     check one full batch's step outputs on the card against the same step on
     the CPU in both modes (float32: logits 5e-4 of max |logit|, >= 99% of
     the decodes; bf16: each side held to the CPU's float32 step, see
     BF16_RMS_RATIO), and at beam 80 (the beam kernel and
     its plain version on one lp tensor exact; a window that decodes
     differently end to end printed with its first divergence, the
     near-tie's margin beside the rounding); the same for DNA_slow
     (-p dna-slow-pre) and RNA_default (--mode rna -p rna-pre) in both modes,
     and bf16 against float32 on the card for each model (max logit
     difference, identical decodes); then the same `call` at beam 30 with a
     GRU and with a BNLSTM model (DNA_default's model.json with cell_type
     changed, fresh seeded weights written as a checkpoint), in both modes,
     the forward-only stack `unirnn_layers` at full width for each cell type
     (the LSTM also in bf16), and one `rna`-layer-type LSTM batch in both
     modes, each card vs CPU with its launch counts;
  4. drive the port's `train` entry point (DNA_default config, -s 400 -b 300,
     30 steps, fresh seeded weights) on seeded .signal/.label reads, with the
     training LSTM's launch counts set to 0 just before and read just after
     (6 forward + 6 backward per step); check the files it writes and that
     the loss falls; basecall one batch with its final checkpoint; check one
     full-width train step (bundled weights) on the card against the CPU;
  5. time each kernel, its plain version and a PyTorch library yardstick
     with CUDA events after a warm-up (conv_bn at each dna_model1 shape,
     cuDNN with TF32 off and, as a second yardstick, on); no kernel may
     read below its bound; the BNLSTM's cooperative instance re-timed at the
     main path's shape beside its cluster instance; the GRU's two instances
     timed in turns at the main path's shape, with cuDNN's nn.GRU as a
     same-FLOP note; the "w" rows' bounds; the LSTM backward split into its
     recurrence and its dwh pass; the recurrent kernels at H = 384 / 512 and the beam search
     at W = 65 / 100; the whole call in bases/s, and a warm train step split
     into forward / loss / backward / update; the bf16 instances beside the
     float32 ones in turns, their plain versions, bounds at bf16 bytes and
     library calls; each bundled model's step split by stage in both modes,
     and the device's idle share over a warm call in both modes;
  6. run the port's benchmark and accuracy entry points on the card:
     `accuracy` at beam 30 on the full simulated corpora of synthetic_dna,
     synthetic_dna_slow and synthetic_rna, float32 through its main() (each
     axis within SKILL_TOL / KMER11_TOL of the committed ACCURACY.json row
     and above the smoke floors) and bf16 (floors only); the `bench` line
     (bf16 beam-30 calls on its default input, the two device axes) with
     the call's idle share; the 2,000-window step against five 400-window
     steps on the same windows (float32 >= 99.9% identical decodes; bf16
     printed against the 99.9% and held to the float32 steps), the stage
     where the two part, each conv's BN moments at both batches in ulps,
     the 2,000-window step with the 400-window step's BN affines (>= 99.9%
     identical in both modes) and, in bf16, the plain CPU path's 2,000 vs
     five 400; the host syncs inside one decode_step; each run's launch
     counts;
  7. print the per-kernel JSON line, then {"ok": true, "device": ...}.
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
# bf16 inference mode. A float32 sum-order residue flips a bfloat16 rounding
# (2^-8 relative) here and there, and the flips propagate through the convs
# and the stack; the bundled DNA_default on these synthetic squiggles moves
# its logits by ~0.1 of max |logit| (and a quarter of its decodes) when 1% of
# the window's samples move one bf16 ulp (on the CPU, in either mode), so
# card and CPU are not held to each other there but each to the float32
# reference: the card's bf16 logits no further from the CPU's float32 logits
# (RMS) than the CPU's bf16 logits are, within BF16_RMS_RATIO (two bf16 runs
# with other residues land within ~1% of each other), and as many windows
# decoding as in float32, within BF16_DECODE_SLACK of the windows. 1e-2 of
# max |logit| and 97% of the decodes card vs CPU are printed beside them
BF16_RMS_RATIO = 1.1
BF16_DECODE_SLACK = 0.05
BF16_LOGIT_TOL = 1e-2
BF16_MIN_SAME = 0.97
# the JAX package's own bound on bf16 against float32 logits (tests/test_model.py:107)
JAX_BF16_BOUND = 0.15
# the accuracy axes (chiron_tpu_torch/accuracy.py): call batch of each axis's
# model; float32 at beam 30 lands on the committed ACCURACY.json row within
# SKILL_TOL (about 0.005 identity) and KMER11_TOL; both modes clear the
# identity / kmer11 floors of tests/test_accuracy_smoke.py:64-71 (beam floors
# for synthetic_dna, the DNA_slow and RNA floors for the other two)
ACC_BATCH = {"synthetic_dna": 400, "synthetic_dna_slow": 300, "synthetic_rna": 100}
SKILL_TOL, KMER11_TOL = 0.01, 0.005
SMOKE_FLOORS = {"synthetic_dna": (0.74, 0.07), "synthetic_dna_slow": (0.69, 0.062),
                "synthetic_rna": (0.64, 0.036)}
# the 2,000-window step against five 400-window steps on the same windows, and
# the most its convs' BN mean (in ulps of rms(y)) and var (in ulps of E[y^2],
# what the var is taken from) may differ from the 400-window step's on equal
# inputs: the last bits
BIG_MIN_SAME = 0.999
AFFINE_MAX_ULPS = 16
# the bundled models, their presets and their conv_bn launches per batch
MODELS = {"DNA_default": ("dna-pre", "dna", 12), "DNA_slow": ("dna-slow-pre", "dna", 13),
          "RNA_default": ("rna-pre", "rna", 13)}
# where the run saves the windows that decode differently (``--out``)
OUT_DIR = os.path.join(REPO, "chiron_tpu_torch", "_build", "chip_smoke")


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
    kernel runs on the CUDA cores. Bytes: every term (at its element size:
    2 for the bf16 instance, whose y is bf16 too) and its affine read once,
    w read once, y and the moments written once."""
    bsz, t, cin = terms[0][0].shape
    k, _, cout = w.shape
    el = terms[0][0].element_size()
    rows_out = bsz * (-(-t // stride))
    flops = 2.0 * rows_out * k * cin * cout
    nbytes = (el * len(terms) * bsz * t * cin + 4.0 * (len(terms) * 2 * cin + k * cin * cout)
              + el * rows_out * cout + 4.0 * 2 * cout)
    if on_tensor_cores:
        return bound_ms(3 * flops, nbytes, PEAK_TF32) + ("3 x FLOP / 495 TFLOP/s TF32",)
    return bound_ms(flops, nbytes) + ("FLOP / 67 TFLOP/s float32",)


def recurrent_bound(kind, act, t, b, h, dirs=1, xw_bytes=4):
    """A recurrent inference kernel's bound from its inputs: per active (row,
    step) of a direction, LSTM h @ wh + ~12H gate ops, BNLSTM the LSTM's +
    ~40H for its three normalisations (CUDA cores); GRU h @ whg and (r * h) @
    whc as three TF32 products on the tensor cores (3xTF32) beside ~10H gate
    ops on the CUDA cores, whichever takes longer; bytes: the input
    projections in, the weights and vectors, lengths (and starts), h out.
    ``act``: active (row, step) pairs of one direction. ``xw_bytes``: the
    LSTM's xw and h element size (2 for its bf16 instance)."""
    cells = t * b
    if kind == "gru":
        nbytes = dirs * 4.0 * (cells * 3 * h + h * 3 * h + 2 * b + cells * h)
        t_ops = max(dirs * act * 3 * 2 * h * 3 * h / PEAK_TF32, dirs * act * 10 * h / PEAK_F32)
        t_bytes = nbytes / PEAK_BYTES
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    one = {"lstm": (act * (2 * h * 4 * h + 12 * h),
                    xw_bytes * (cells * 4 * h + cells * h) + 4.0 * (h * 4 * h + 2 * b)),
           "bnlstm": (act * (2 * h * 4 * h + 52 * h),
                      4.0 * (cells * 4 * h + h * 4 * h + 14 * h + b + cells * h))}[kind]
    return bound_ms(dirs * one[0], dirs * one[1])


def train_lstm_bounds(act, t, b, h):
    """The training LSTM's forward and backward bounds from their inputs: per
    active (row, step), forward h @ wh + ~12H gate ops, backward da @ wh^T and
    h^T da (dwh) + ~20H; bytes: xw, wh and lengths in, the residuals (gates,
    cc, hc) and out (forward), dxw and dwh (backward)."""
    rows = t * b
    fwd = bound_ms(act * (2 * h * 4 * h + 12 * h),
                   4.0 * (rows * 4 * h + h * 4 * h + b + 3 * rows * h + rows * 4 * h))
    bwd = bound_ms(act * (2 * 2 * h * 4 * h + 20 * h),
                   4.0 * (rows * 4 * h + 3 * rows * h + h * 4 * h + b + rows * 4 * h + h * 4 * h))
    return fwd, bwd


def beam_bound(steps, b, t, w, c=5):
    """The beam search's bound: per active step candidate scoring (~8 ops
    each), the [4W x W] hash merge compare and a top-W selection of ~cand *
    log2(cand) compares (cand = W * C); bytes: lp and lengths in, the trace
    and pb / pnb out."""
    cand = w * c
    return bound_ms(steps * (8 * cand + 4 * w * w + cand * np.log2(cand)),
                    4.0 * (b * t * c + b + b * t * w + 2 * b * w))


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


def write_reads(sig_dir, n_reads, samples, rng, dwell_mean=9.0):
    """Seeded synthetic squiggles: piecewise-constant levels (mean dwell ~9
    samples, the DNA_default regime; ~25 for slow translocation) plus noise,
    as integer raw counts."""
    os.makedirs(sig_dir)
    for i in range(n_reads):
        n_events = samples // 5
        dwell = np.maximum(rng.geometric(1 / dwell_mean, n_events), 2)
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


def main(out_dir=OUT_DIR):
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
    t_start = t0 = time.time()

    def phase(name):
        log(f"[{time.time() - t_start:.0f} s] {name}")

    logs, build_seconds = cuda_build.build_all()
    log(f"built {sorted(logs)} in {time.time() - t0:.1f} s; nvcc seconds by library (all "
        f"started together): " + json.dumps({k: round(v, 1) for k, v in build_seconds.items()}))
    for name, text in sorted(logs.items()):
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            # the redesigned kernels must not spill: ptxas prints a function's
            # spill bytes two lines after its "Compiling entry function"
            if "Compiling entry function" in line and any(
                    k in line for k in ("conv_bn_mma_kernel", "conv_bn_direct_kernel",
                                        "lstm_fwd_kernel", "lstm_infer_kernel",
                                        "lstm_bwd_kernel", "beam_warp_kernel",
                                        "beam_block_kernel", "beam_traceback_kernel",
                                        "bnlstm_cluster_kernel", "gru_kernel")):
                if "0 bytes spill stores, 0 bytes spill loads" not in lines[i + 2]:
                    fail(f"{name}: a redesigned kernel spills registers: {lines[i + 2].strip()}")

    # ---- 2. each kernel against its plain version on the card -------------
    phase("2. kernels against their plain versions")
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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def geometry(kind, b, hid, dirs=1, xw_bytes=4):
        """The cluster geometry a recurrent kernel takes, as printed text."""
        cl, rows, smem = lstm_grad.cluster_geometry(kind, b, hid, dirs, sms, xw_bytes)
        waves = -(-(-(-b // rows) * dirs) // (sms // cl))
        return f"cluster {cl}, rows {rows}, shared bytes {smem}, waves {waves}"

    def hold(name, err, tol, extra=""):
        ok = err <= tol
        log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e}) {extra}"
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        return err

    def bf16_hold(name, got, want, atol, min_same=0.999):
        """bfloat16 outputs in the working type: every element equal or one
        bf16 ulp apart (or, near zero, within the float32 gate atol), and
        identical on >= min_same of them. Returns the max abs difference."""
        def ordered(t):
            b = t.contiguous().view(torch.int16).to(torch.int32)
            return torch.where(b < 0, -(b & 0x7FFF), b)

        ulps = (ordered(got) - ordered(want)).abs()
        diff = (got.float() - want.float()).abs()
        off = int(((ulps > 1) & (diff > atol)).sum())
        same = float((ulps == 0).float().mean())
        ok = off == 0 and same >= min_same
        log(f"  {name}: identical {same:.6f} (>= {min_same}), max ulps {int(ulps.max())}, "
            f"elements more than 1 ulp and {atol:.0e} apart {off} (must be 0), max_abs_err "
            f"{float(diff.max()):.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        return float(diff.max())

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
                                               int(len(terms) == 2), 0)
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

    # the bf16 instances at the same shapes and at the one-term shapes of the
    # residual blocks (conv2b k=3, conv2c k=1 read one term): raws rounded to
    # bf16; held in the working type against the plain version, moments 1e-4,
    # bit-identical across two runs and to the float32 instance on the upcast
    # raws with y rounded (the bf16 instance is that function)
    conv_cases_bf16 = {
        **{case: ([(r.to(torch.bfloat16), a, b) for r, a, b in terms], w, relu, stride)
           for case, (terms, w, relu, stride) in conv_cases.items()},
        "k3_one_term_relu": ([(rnd(BATCH, SEG, c).to(torch.bfloat16), rnd(c).abs() + 0.5,
                               rnd(c, scale=0.2))], rnd(3, c, c, scale=(2 / (4 * c)) ** 0.5),
                             True, 1),
        "k1_one_term_relu": ([(rnd(BATCH, SEG, c).to(torch.bfloat16), rnd(c).abs() + 0.5,
                               rnd(c, scale=0.2))], rnd(1, c, c, scale=(2 / (2 * c)) ** 0.5),
                             True, 1)}
    conv_route_bf16 = {case: conv_lib.conv_bn_route(w.shape[1], w.shape[2], w.shape[0], stride,
                                                    int(len(terms) == 2), 1)
                       for case, (terms, w, _, stride) in conv_cases_bf16.items()}
    log(f"  conv_bn bf16 instance routes: {conv_route_bf16}")
    conv_err_bf16 = 0.0
    bf16 = torch.bfloat16
    for case, (terms, w, relu, stride) in conv_cases_bf16.items():
        y, s, q = conv_bn.conv_bn(terms, w, relu, stride, out_dtype=bf16)
        again = conv_bn.conv_bn(terms, w, relu, stride, out_dtype=bf16)
        f32 = conv_bn.conv_bn([(r.float(), a, b) for r, a, b in terms], w, relu, stride)
        py, ps, pq = conv_bn.conv_bn_plain(terms, w, relu, stride, out_dtype=bf16)
        torch.cuda.synchronize()
        if not all(torch.equal(a, g) for a, g in zip(again, (y, s, q))):
            failures.append(f"conv_bn bf16 {case} differs between two runs")
        if not (torch.equal(y, f32[0].to(bf16)) and torch.equal(s, f32[1])
                and torch.equal(q, f32[2])):
            failures.append(f"conv_bn bf16 {case} is not the float32 instance's function")
        mom = max(float(((s - ps).abs() / ps.abs().clamp(min=1.0)).max()),
                  float(((q - pq).abs() / pq.abs().clamp(min=1.0)).max()))
        conv_err_bf16 = max(conv_err_bf16, bf16_hold(f"conv_bn bf16 {case} y", y, py, 1e-4))
        hold(f"conv_bn bf16 {case} moments (relative)", mom, 1e-4)

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
    again = bilstm.bilstm_layer(*lstm_args)
    want = bilstm.bilstm_layer_plain(*lstm_args)
    torch.cuda.synchronize()
    lstm_err = hold(f"bilstm T=B=400 H=128 ({geometry('infer', BATCH, h, 2)})",
                    max_err(got, want), 1e-4)
    infer_same = all(torch.equal(a, g) for a, g in zip(again, got))
    # the inference kernel at other widths and batch edges: a ragged slice per
    # block (H = 100), a cluster of 8 (H = 256), a single row and a batch that
    # is no multiple of the row tile; the fused layer and one direction with
    # and without starts, each bit-identical across two runs
    for b_x, h_x in ((BATCH, 100), (BATCH, 256), (1, h), (BATCH - 99, h)):
        ws_x = (6 / (5 * h_x)) ** 0.5 / 2
        ln_x = torch.randint(0, t_len + 1, (b_x,), generator=gen).to(torch.int32)
        ln_x[-1] = t_len
        ln_x = ln_x.to(dev)
        args_x = (rnd(t_len, b_x, 4 * h_x), rnd(t_len, b_x, 4 * h_x),
                  rnd(h_x, 4 * h_x, scale=ws_x), rnd(h_x, 4 * h_x, scale=ws_x), ln_x,
                  (t_len - ln_x).to(torch.int32))
        one_args = [(args_x[1], args_x[3], ln_x, s) for s in (None, args_x[5])]
        got_x = [*bilstm.bilstm_layer(*args_x), *[lstm.lstm_layer(*a) for a in one_args]]
        again_x = [*bilstm.bilstm_layer(*args_x), *[lstm.lstm_layer(*a) for a in one_args]]
        want_x = [*bilstm.bilstm_layer_plain(*args_x),
                  *[lstm.lstm_layer_plain(*a) for a in one_args]]
        torch.cuda.synchronize()
        hold(f"bilstm T=400 B={b_x} H={h_x} ({geometry('infer', b_x, h_x, 2)})",
             max_err(got_x[:2], want_x[:2]), 1e-4)
        hold(f"lstm_layer T=400 B={b_x} H={h_x} without and with starts "
             f"({geometry('infer', b_x, h_x)})", max_err(got_x[2:], want_x[2:]), 1e-4)
        infer_same = infer_same and all(torch.equal(a, g) for a, g in zip(again_x, got_x))
    log(f"  bilstm and lstm_layer bit-identical across two runs at every shape: {infer_same}")
    if not infer_same:
        failures.append("the inference LSTM kernel differs between two runs")

    # the LSTM inference kernel's bf16 instance (rows 2 and 5) on bf16 xw: the
    # fused layer and one direction with and without starts, at T = 400 and B =
    # 400 (H = 128, DNA_default; H = 100, RNA_default), 1 and 301; held in the
    # working type against the plain versions (near zero within the float32
    # gate 1e-4), bit-identical across two runs and to the float32 instance on
    # the upcast xw with h rounded
    lstm_err_bf16 = {"bilstm": 0.0, "lstm_layer": 0.0}
    bf16_same = True
    bf16_lstm_args = None
    for b_x, h_x in ((BATCH, h), (BATCH, 100), (1, h), (BATCH - 99, h)):
        ws_x = (6 / (5 * h_x)) ** 0.5 / 2
        ln_x = torch.randint(0, t_len + 1, (b_x,), generator=gen).to(torch.int32)
        ln_x[-1] = t_len
        ln_x = ln_x.to(dev)
        args_x = (rnd(t_len, b_x, 4 * h_x).to(bf16), rnd(t_len, b_x, 4 * h_x).to(bf16),
                  rnd(h_x, 4 * h_x, scale=ws_x), rnd(h_x, 4 * h_x, scale=ws_x), ln_x,
                  (t_len - ln_x).to(torch.int32))
        if (b_x, h_x) == (BATCH, h):
            bf16_lstm_args = args_x
        one_args = [(args_x[1], args_x[3], ln_x, s) for s in (None, args_x[5])]
        got_x = [*bilstm.bilstm_layer(*args_x), *[lstm.lstm_layer(*a) for a in one_args]]
        again_x = [*bilstm.bilstm_layer(*args_x), *[lstm.lstm_layer(*a) for a in one_args]]
        f32_x = [*bilstm.bilstm_layer(args_x[0].float(), args_x[1].float(), *args_x[2:]),
                 *[lstm.lstm_layer(a[0].float(), *a[1:]) for a in one_args]]
        want_x = [*bilstm.bilstm_layer_plain(*args_x),
                  *[lstm.lstm_layer_plain(*a) for a in one_args]]
        torch.cuda.synchronize()
        geo = (f"{geometry('infer', b_x, h_x, 2, 2)}; one direction "
               f"{geometry('infer', b_x, h_x, 1, 2)}")
        for i, name in enumerate(("bilstm fw", "bilstm bw", "lstm_layer", "lstm_layer starts")):
            err = bf16_hold(f"{name} bf16 T=400 B={b_x} H={h_x}" + (f" ({geo})" if i == 0 else ""),
                            got_x[i], want_x[i], 1e-4)
            key = "bilstm" if i < 2 else "lstm_layer"
            lstm_err_bf16[key] = max(lstm_err_bf16[key], err)
        bf16_same = bf16_same and all(torch.equal(a, g) for a, g in zip(again_x, got_x)) \
            and all(torch.equal(g, f.to(bf16)) for g, f in zip(got_x, f32_x))
    log(f"  bf16 bilstm and lstm_layer bit-identical across two runs and to the float32 "
        f"instance's function at every shape: {bf16_same}")
    if not bf16_same:
        failures.append("the inference LSTM kernel's bf16 instance differs between runs or from "
                        "the float32 instance's function")

    # beam W=30 at B = T = 400 with length_bonus 0.6: random and peaky logits
    bonus = 0.6
    beam_lens = torch.randint(1, t_len + 1, (BATCH,), generator=gen).to(torch.int32)
    beam_lens[0], beam_lens[1] = 0, t_len
    beam_lens = beam_lens.to(dev)
    peak = torch.randint(0, 5, (BATCH, t_len), generator=gen)
    peaky = torch.full((BATCH, t_len, 5), -20.0).scatter_(2, peak[..., None], 20.0).to(dev)
    # "tied": logits from {0, 1}, so many candidates score exactly alike (the
    # warp kernel's exact rerun of a step whose rounds met tied heads)
    tied = torch.randint(0, 2, (BATCH, t_len, 5), generator=gen).float().to(dev)
    beam_inputs = {"random": torch.log_softmax(rnd(BATCH, t_len, 5, scale=2.0), -1),
                   "peaky": torch.log_softmax(peaky + rnd(BATCH, t_len, 5, scale=0.5), -1),
                   "tied": torch.log_softmax(tied, -1)}
    beam_err = tb_err = 0.0
    for case, lp in beam_inputs.items():
        trace, pb, pnb = beam.beam_search(lp, beam_lens, BEAM, bonus)
        again = beam.beam_search(lp, beam_lens, BEAM, bonus)
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
        same = all(torch.equal(a, g) for a, g in zip(again, (trace, pb, pnb)))
        beam_err = max(beam_err, hold(f"beam_search {case} pb/pnb", err, 1e-4,
                                      f"(rows whose trace differs: {mism}, must be 0; "
                                      f"bit-identical across two runs: {same}) "))
        if mism or not same:
            failures.append(f"beam_search {case} trace or run-to-run bits")
        tb_mism = int((chars != pchars).sum())
        tb_err = max(tb_err, hold(f"beam_traceback {case} chars", float(tb_mism), 0))
    # wider beams and a larger alphabet (the block kernel: W > 32 or C > 8), each
    # exact against the plain version on the same lp and bit-identical across runs
    for w_x, c_x in ((65, 5), (100, 5), (256, 5), (30, 10)):
        b_x = 128
        lp_x = torch.log_softmax(rnd(b_x, t_len, c_x, scale=2.0), -1)
        ln_x = beam_lens[:b_x].contiguous()
        got_x = beam.beam_search(lp_x, ln_x, w_x, bonus)
        again_x = beam.beam_search(lp_x, ln_x, w_x, bonus)
        want_x = beam.beam_search_plain(lp_x, ln_x, w_x, bonus)
        best_x = torch.argmax(beam._lae(*got_x[1:]), dim=1).to(torch.int32)
        chars_x = beam.beam_traceback(got_x[0], best_x)
        pchars_x = beam.beam_traceback_plain(got_x[0], best_x)
        torch.cuda.synchronize()
        mism = int((got_x[0] != want_x[0]).any(dim=(1, 2)).sum())
        err = max(float((g - r)[r > -1e29].abs().max()) for g, r in zip(got_x[1:], want_x[1:]))
        same = all(torch.equal(a, g) for a, g in zip(again_x, got_x))
        hold(f"beam_search W={w_x} C={c_x} B={b_x} T=400 ({beam.search_route(w_x, c_x)} kernel) "
             f"pb/pnb", err, 1e-4, f"(rows whose trace differs: {mism}, must be 0; bit-identical "
             f"across two runs: {same}) ")
        hold(f"beam_traceback W={w_x} C={c_x} chars", float(int((chars_x != pchars_x).sum())), 0)
        if mism or not same:
            failures.append(f"beam_search W={w_x} C={c_x} trace or run-to-run bits")
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
    # of 8 (H = 256), a single row, and a batch that is no multiple of the row
    # tile; the backward on the plain residuals at the same shapes
    bwd_same = True
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
        dhs_x = rnd(t_len, b_x, h_x)
        bwd_x = lstm_grad.lstm_bwd(*want_x[1:], dhs_x, wh_x, lens_x)
        bwd_again = lstm_grad.lstm_bwd(*want_x[1:], dhs_x, wh_x, lens_x)
        bwd_p = lstm_grad.lstm_bwd_plain(*want_x[1:], dhs_x, wh_x, lens_x)
        torch.cuda.synchronize()
        hold(f"lstm_bwd T=400 B={b_x} H={h_x} dxw ({geometry('bwd', b_x, h_x)})",
             float((bwd_x[0] - bwd_p[0]).abs().max()), 1e-4)
        hold(f"lstm_bwd T=400 B={b_x} H={h_x} dwh (relative to max |dwh|)",
             float((bwd_x[1] - bwd_p[1]).abs().max()) / float(bwd_p[1].abs().max()), 1e-4)
        bwd_same = bwd_same and all(torch.equal(a, g) for a, g in zip(bwd_again, bwd_x))
    log(f"  lstm_fwd_residuals bit-identical across two runs at every shape: {fwd_same}")
    if not fwd_same:
        failures.append("lstm_fwd_residuals differs between two runs")
    # the backward on the residuals the kernel forward wrote
    dxw_k, dwh_k = lstm_grad.lstm_bwd(*fwd[1:], dhs_t, wh_t, lens_t)
    dxw, dwh = lstm_grad.lstm_bwd(*fwd_p[1:], dhs_t, wh_t, lens_t)
    dxw_again, dwh_again = lstm_grad.lstm_bwd(*fwd_p[1:], dhs_t, wh_t, lens_t)
    dxw_p, dwh_p = lstm_grad.lstm_bwd_plain(*fwd_p[1:], dhs_t, wh_t, lens_t)
    torch.cuda.synchronize()
    dwh_scale = float(dwh_p.abs().max())
    dwh_abs = float((dwh - dwh_p).abs().max())
    bwd_err = max(hold(f"lstm_bwd T=400 B=300 H=128 dxw ({geometry('bwd', tb, h)})",
                       float((dxw - dxw_p).abs().max()), 1e-4), dwh_abs)
    hold("lstm_bwd dxw on the kernel forward's residuals", float((dxw_k - dxw_p).abs().max()),
         1e-4)
    hold("lstm_bwd dwh on the kernel forward's residuals (relative to max |dwh|)",
         float((dwh_k - dwh_p).abs().max()) / dwh_scale, 1e-4)
    hold("lstm_bwd dwh (relative to max |dwh|)", dwh_abs / dwh_scale, 1e-4,
         f"(max |dwh| {dwh_scale:.2f}) ")
    bwd_same = bwd_same and torch.equal(dwh, dwh_again) and torch.equal(dxw, dxw_again)
    if not bwd_same:
        failures.append("lstm_bwd differs between two runs")
    log(f"  lstm_bwd dxw and dwh bit-identical across two runs at every shape: {bwd_same}")

    # the other recurrent kernels: one LSTM direction (with and without start
    # offsets), the GRU and the BNLSTM, fused and single, with seeded lengths
    # that hold an empty row, full rows and partial rows. Eight rows are full:
    # with two or three rows active a BNLSTM column's variance can fall far
    # below eps, and rsqrt(var + 1e-5) then amplifies float32 rounding.
    def recurrent_inputs(t, b, hid):
        ws = (6 / (5 * hid)) ** 0.5 / 2
        ln = torch.randint(0, t + 1, (b,), generator=gen).to(torch.int32)
        ln[0], ln[1:9] = 0, t
        if b == 1:  # a single row: a full one
            ln[0] = t
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

    bn_limits = bnlstm.card_limits(dev)

    def gru_route(b, hid, dirs):
        """The GRU instance and geometry a shape takes, as printed text."""
        g = gru.geometry(b, hid, dirs)
        return (f"{g.instance} instance: {g.blocks} blocks of {gru.ROWS} rows and {g.threads} "
                f"threads, {gru.unit_tiles(g.instance == 'resident')} tile(s) of 16 units a "
                f"warp, shared bytes {g.smem_bytes}")

    def bn_route(b, hid):
        """The BNLSTM instance and geometry a shape takes, as printed text."""
        g = bnlstm.geometry(b, hid, 2, sms, *bn_limits)
        if g.instance == "cooperative":
            return (f"cooperative instance: {g.row_groups} blocks of {g.rows} rows a direction, "
                    f"shared bytes {g.smem_bytes}")
        return (f"cluster instance: {g.split} cluster(s) of {g.cluster} blocks a direction, each "
                f"{g.row_groups} row groups x {g.unit_slices} unit slices, {g.rows} rows x "
                f"{g.units} units a thread, {g.threads} threads, shared bytes {g.smem_bytes}")

    def recurrent_holds(tag, case):
        ln, st = case["lens"], case["starts"]
        xw, wh = case["lstm"]
        got = [lstm.lstm_layer(xw, wh, ln, s) for s in (None, st)]
        again = [lstm.lstm_layer(xw, wh, ln, s) for s in (None, st)]
        want = [lstm.lstm_layer_plain(xw, wh, ln, s) for s in (None, st)]
        torch.cuda.synchronize()
        errs = {"lstm_layer": hold(f"lstm_layer {tag} (without and with starts; "
                                   f"{geometry('infer', ln.shape[0], wh.shape[0])})",
                                   max_err(got, want), 1e-4)}
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            failures.append(f"lstm_layer {tag} differs between two runs")
        gx_f, cx_f, gx_b, cx_b, wh_f, wh_b = case["gru"]
        got = gru.bigru_layer(*case["gru"], ln, st)
        one = gru.gru_layer(gx_b, cx_b, *wh_b, ln, st)
        want = gru.bigru_layer_plain(*case["gru"], ln, st)
        torch.cuda.synchronize()
        hid = wh_f[0].shape[0]
        errs["bigru_layer"] = hold(f"bigru_layer {tag} ({gru_route(ln.shape[0], hid, 2)})",
                                   max_err(got, want), 1e-4)
        errs["gru_layer"] = hold(f"gru_layer {tag} (with starts; "
                                 f"{gru_route(ln.shape[0], hid, 1)})",
                                 max_err([one], want[1:]), 1e-4)
        if not torch.equal(one, got[1]):
            failures.append(f"bigru_layer {tag} differs from the single direction")
        xw_f, xw_b, w_f, w_b = case["bn"]
        route = bnlstm.geometry(ln.shape[0], w_f[0].shape[0], 2, sms, *bn_limits).instance
        before = bnlstm.instance_launches[route]
        got = bnlstm.bibnlstm_layer(*case["bn"], ln)
        again = bnlstm.bibnlstm_layer(*case["bn"], ln)
        one = bnlstm.bnlstm_layer(xw_f, *w_f, ln)
        want = bnlstm.bibnlstm_layer_plain(*case["bn"], ln)
        torch.cuda.synchronize()
        if bnlstm.instance_launches[route] != before + 3:
            failures.append(f"bibnlstm_layer {tag} did not run the {route} instance")
        errs["bibnlstm_layer"] = hold(f"bibnlstm_layer {tag} ({bn_route(ln.shape[0], w_f[0].shape[0])})",
                                      max_err(got, want), 1e-4)
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

    # every recurrent kernel past H = 256: the LSTM kernels' device-memory
    # variant (no cluster holds wh), the GRU's streamed instance (weights from
    # L2), the BNLSTM's two gate columns a thread; the tolerances above, and the LSTM
    # kernels bit-identical across two runs
    wide_same = True
    t_w = 100
    for h_x in (384, 512):
        ws_x = (6 / (5 * h_x)) ** 0.5 / 2
        for b_x in (1, 64, 301):
            ln_x = torch.randint(0, t_w + 1, (b_x,), generator=gen).to(torch.int32)
            ln_x[-1] = t_w
            ln_x = ln_x.to(dev)
            args_x = (rnd(t_w, b_x, 4 * h_x), rnd(t_w, b_x, 4 * h_x), rnd(h_x, 4 * h_x, scale=ws_x),
                      rnd(h_x, 4 * h_x, scale=ws_x), ln_x, (t_w - ln_x).to(torch.int32))
            got_x = bilstm.bilstm_layer(*args_x)
            again_x = bilstm.bilstm_layer(*args_x)
            want_x = bilstm.bilstm_layer_plain(*args_x)
            fwd_x = lstm_grad.lstm_fwd_residuals(args_x[0], args_x[2], ln_x)
            fwd_again = lstm_grad.lstm_fwd_residuals(args_x[0], args_x[2], ln_x)
            fwd_want = lstm_grad.lstm_fwd_residuals_plain(args_x[0], args_x[2], ln_x)
            dhs_x = rnd(t_w, b_x, h_x)
            bwd_x = lstm_grad.lstm_bwd(*fwd_want[1:], dhs_x, args_x[2], ln_x)
            bwd_again = lstm_grad.lstm_bwd(*fwd_want[1:], dhs_x, args_x[2], ln_x)
            bwd_want = lstm_grad.lstm_bwd_plain(*fwd_want[1:], dhs_x, args_x[2], ln_x)
            torch.cuda.synchronize()
            tag = f"T={t_w} B={b_x} H={h_x}"
            hold(f"bilstm {tag} ({geometry('infer', b_x, h_x, 2)})", max_err(got_x, want_x), 1e-4)
            hold(f"lstm_fwd_residuals {tag} (cluster, rows, shared bytes "
                 f"{lstm_grad.fwd_geometry(b_x, h_x)})", max_err(fwd_x, fwd_want), 1e-5)
            hold(f"lstm_bwd {tag} dxw ({geometry('bwd', b_x, h_x)})",
                 float((bwd_x[0] - bwd_want[0]).abs().max()), 1e-4)
            hold(f"lstm_bwd {tag} dwh (relative to max |dwh|)",
                 float((bwd_x[1] - bwd_want[1]).abs().max()) / float(bwd_want[1].abs().max()), 1e-4)
            wide_same = wide_same and all(torch.equal(a, g) for a, g in zip(
                [*again_x, *fwd_again, *bwd_again], [*got_x, *fwd_x, *bwd_x]))
        for b_x in (1, 64, 301):
            recurrent_holds(f"T={t_w} B={b_x} H={h_x}", recurrent_inputs(t_w, b_x, h_x))
    log(f"  bilstm, lstm_fwd_residuals and lstm_bwd at H = 384 / 512 bit-identical across two "
        f"runs: {wide_same}")
    # the GRU at every width and batch edge: the instance chosen, fused (1e-4
    # against plain) and single with starts, equal bit for bit, across runs and
    # to each instance forced (the resident one where it fits a block); a
    # zero-length batch exactly zero
    gru_same = True
    for h_x in (16, 100, 128, 256, 384, 512):
        for b_x in (1, 64, 301, 400):
            c_x = recurrent_inputs(30, b_x, h_x)
            ln_x, st_x = c_x["lens"], c_x["starts"]
            args_x = c_x["gru"]
            got_x = gru.bigru_layer(*args_x, ln_x, st_x)
            again_x = gru.bigru_layer(*args_x, ln_x, st_x)
            one_x = [gru.gru_layer(args_x[0], args_x[1], *args_x[4], ln_x),
                     gru.gru_layer(args_x[2], args_x[3], *args_x[5], ln_x, st_x)]
            forced = [gru.geometry(b_x, h_x, 2, i) for i in gru.instances(h_x)]
            other_x = [gru._launch("bigru", args_x[0:4:2], args_x[1:4:2], args_x[4:], ln_x, st_x,
                                   g) for g in forced]
            zero_x = gru.bigru_layer(*args_x, torch.zeros_like(ln_x), st_x)
            want_x = gru.bigru_layer_plain(*args_x, ln_x, st_x)
            torch.cuda.synchronize()
            same = all(torch.equal(a, g) for o in [again_x, one_x, *other_x]
                       for a, g in zip(o, got_x))
            gru_same = gru_same and same and not any(z.any() for z in zero_x)
            hold(f"bigru_layer T=30 B={b_x} H={h_x} ({gru_route(b_x, h_x, 2)}; single "
                 f"{gru.geometry(b_x, h_x, 1).instance}; {len(other_x)} instances forced)",
                 max_err(got_x, want_x), 1e-4)
    log(f"  bigru_layer equal bit for bit across runs, to two single launches and to each "
        f"instance forced, zero-length batches exactly zero, at every shape: {gru_same}")
    log(f"  GRU launches by instance over the holds above: {json.dumps(gru.instance_launches)}")
    if not gru_same:
        failures.append("a GRU launch differs between runs, directions or instances")
    if not all(gru.instance_launches.values()):
        failures.append("a GRU instance was not driven: " + json.dumps(gru.instance_launches))
    log(f"  BNLSTM launches by instance over the holds above: {json.dumps(bnlstm.instance_launches)}")
    if not all(bnlstm.instance_launches.values()):
        failures.append("a BNLSTM instance was not driven: " + json.dumps(bnlstm.instance_launches))
    if not wide_same:
        failures.append("an LSTM kernel at H = 384 / 512 differs between two runs")
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")

    # ---- 3. the main path: `call -p dna-pre`, beam 30 and beam 0, both modes
    phase("3. call paths")
    rng = np.random.RandomState(SEED)
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    work = tempfile.mkdtemp(dir=cuda_build.BUILD)
    sig_dir = os.path.join(work, "signal")
    n_reads, samples = 20, 40 * JUMP + 10  # 41 windows each: 820 = 2 full batches + 20
    write_reads(sig_dir, n_reads, samples, rng)
    n_windows = n_reads * (-(-samples // JUMP))
    n_batches = -(-n_windows // BATCH)

    def expected(n, conv=12, rnn="bilstm", dtype="float32"):
        """A call's launches over n batches: conv_bn and the LSTM kernel per
        dtype instance, the GRU / BNLSTM kernels (float32 in both modes)."""
        rnn_key = f"{rnn}_{dtype}" if rnn == "bilstm" else rnn
        return {f"conv_bn_{dtype}": conv * n, rnn_key: 3 * n, "beam_search": n,
                "beam_traceback": n}

    expect = expected(n_batches)

    def reset():
        conv_bn.launches = bilstm.launches = lstm.launches = 0
        for counter in (conv_bn.launches_by_dtype, bilstm.launches_by_dtype,
                        lstm.launches_by_dtype, beam.launches, gru.launches,
                        gru.instance_launches, bnlstm.launches, bnlstm.instance_launches):
            for k in counter:
                counter[k] = 0

    def counts():
        """Every launch counter; conv_bn and the LSTM inference kernel by the
        instance's element type (the per-dtype counters: a bf16 run that took
        a float32 instance shows here)."""
        return {**{f"conv_bn_{k}": n for k, n in conv_bn.launches_by_dtype.items()},
                **{f"bilstm_{k}": n for k, n in bilstm.launches_by_dtype.items()},
                **{f"lstm_layer_{k}": n for k, n in lstm.launches_by_dtype.items()},
                **beam.launches,
                **{f"{k}_layer": n for k, n in {**gru.launches, **bnlstm.launches}.items()},
                **{f"bnlstm_{k}": n for k, n in bnlstm.instance_launches.items()},
                **{f"gru_{k}": n for k, n in gru.instance_launches.items()}}

    def call(out, beam_width, model=None, preset="dna-pre", mode="dna", bf16_mode=False,
             inp=None):
        args = ["call", "-i", inp or sig_dir, "-o", out, "-p", preset, "--mode", mode,
                "--sig_norm", "1", "--beam", str(beam_width), "--device", "cuda"]
        if model is not None:
            args += ["-m", model]
        if bf16_mode:
            args += ["--bf16"]
        t = time.time()
        res = cli.main(args)
        torch.cuda.synchronize()
        return res, time.time() - t

    def counted_call(label, width, model=None, preset="dna-pre", mode="dna", bf16_mode=False,
                     inp=None, reads=n_reads, windows=n_windows):
        """One `call` with every count set to 0 just before and read just
        after; checks the run's summary and its fastq files."""
        reset()
        res, wall = call(os.path.join(work, f"out_{label}"), width, model, preset, mode,
                         bf16_mode, inp)
        cnt = counts()
        log(f"call -p {preset} --beam {width}{' --bf16' if bf16_mode else ''} ({label}): "
            f"{res['total_windows']} windows, {res['total_bases']} bases in {wall:.3f} s; "
            f"launches {cnt}")
        if res["n_files"] != reads or res["total_windows"] != windows:
            fail(f"{label}: expected {reads} files / {windows} windows, got {res}")
        result_dir = os.path.join(work, f"out_{label}", "result")
        fastqs = sorted(os.listdir(result_dir))
        if len(fastqs) != reads:
            fail(f"{label}: {len(fastqs)} fastq files written, expected {reads}")
        for f in fastqs:
            with open(os.path.join(result_dir, f)) as fh:
                lines = fh.read().splitlines()
            if len(lines) != 4 or not lines[1] or len(lines[1]) != len(lines[3]) \
                    or set(lines[1]) - set("ACGU" if mode == "rna" else "ACGT"):
                fail(f"{label}: malformed fastq {f}")
        return cnt

    def check_counts(label, cnt, want):
        """Every count of the run must be the expected one, 0 where none is named
        (so a bf16 run that launched a float32 instance fails, and the reverse).
        Every BNLSTM layer of these runs (B = 400, H = 128) takes the cluster
        instance, every GRU layer the resident one."""
        want = {"bnlstm_cluster": want.get("bibnlstm_layer", 0) + want.get("bnlstm_layer", 0),
                "gru_resident": want.get("bigru_layer", 0) + want.get("gru_layer", 0), **want}
        bad = {k: (n, want.get(k, 0)) for k, n in cnt.items() if n != want.get(k, 0)}
        if bad:
            fail(f"{label} run: launches (got, expected) {bad}")

    beam_counts = counted_call("beam30", BEAM)
    check_counts("beam-30", beam_counts, expect)
    check_counts("beam-0", counted_call("beam0", 0),
                 {"conv_bn_float32": expect["conv_bn_float32"],
                  "bilstm_float32": expect["bilstm_float32"]})
    bf16_counts = counted_call("beam30_bf16", BEAM, bf16_mode=True)
    check_counts("beam-30 --bf16", bf16_counts, expected(n_batches, dtype="bfloat16"))

    # warm repeats of the beam-30 call for the end-to-end rate, both modes
    call_rates = {}
    for tag, b16 in (("dna_pre_beam30", False), ("dna_pre_beam30_bf16", True)):
        res, wall = call(os.path.join(work, f"out_warm_{tag}"), BEAM, bf16_mode=b16)
        call_rates[tag] = {"windows": n_windows, "bases": res["total_bases"], "seconds": wall,
                           "bases_per_s": res["total_bases"] / wall,
                           "windows_per_s": n_windows / wall}
        log(f"warm call {tag}: {json.dumps(call_rates[tag])}")

    def same_decodes(a, b, n):
        """How many windows decode to the same bases in (tokens, lengths) a and b."""
        return sum(bool(a[1][i] == b[1][i] and (a[0][i, :a[1][i]] == b[0][i, :b[1][i]]).all())
                   for i in range(n))

    def load_batch(model, inp, preset):
        """The first full batch of a preset's stream over inp: (card, CPU) pairs
        of the float32 windows, their bf16 upload, and the lengths."""
        p = C.PRESETS[preset]
        fl = type("F", (), dict(batch_size=p["batch_size"], segment_len=p["segment_len"],
                                jump=p["jump"], start=0, sig_norm=1, reverse_fast5=False))()
        file_dir, files = pipeline.list_input_files(inp)
        x, sl, _, _, _ = next(iter(pipeline._batch_stream(file_dir, files, fl,
                                                          model.ratio(p["segment_len"]))))
        xc, slc = torch.from_numpy(x), torch.from_numpy(sl)
        return {"float32": (xc.to(dev), slc.to(dev), xc, slc),
                "bfloat16": (xc.to(torch.bfloat16).to(dev), slc.to(dev),
                             xc.to(torch.bfloat16), slc)}

    def rms(a):
        return float(a.double().pow(2).mean().sqrt())

    def step_card_vs_cpu(label, on_card, on_cpu, batch, logit_tol=LOGIT_TOL, min_same=0.99,
                         width=BEAM, rnn_kernel="bilstm", n_conv=12, f32_ref=None, lb=0.0):
        """One full batch, card against CPU. Float32 (``f32_ref`` None):
        logits within logit_tol of max |logit|, the card's decodes as the
        CPU's on at least min_same of the windows. bf16 (``f32_ref``: this
        function's result for the float32 step of the same batch): each side
        held to the CPU's float32 step (see BF16_RMS_RATIO), card vs CPU
        printed. Both: the beam kernel and beam_search_plain on ONE lp tensor
        (the card's log_softmax of the card's logits, both searches on the
        card) with identical traces on every window; the card's decode_step
        launches counted (n_conv conv_bn and 3 of rnn_kernel of the mode's
        instances, 1 search, 1 traceback). Where a window decodes differently
        card vs CPU, the two searches' first divergence is printed: the two
        candidates' margin beside what the two sides' roundings moved the
        scores. Returns the logits and step outputs of both sides."""
        bf16_mode = f32_ref is not None
        xg, slg, xc, slc = batch
        bsz = xc.shape[0]
        logits_c = on_cpu(xc, slc, bf16=bf16_mode)
        logits_g = on_card(xg, slg, bf16=bf16_mode)
        logit_err = float((logits_g.cpu() - logits_c).abs().max())
        scale = float(logits_c.abs().max())
        if bf16_mode:
            ref = f32_ref["logits_c"]
            rms_g, rms_c = rms(logits_g.cpu() - ref), rms(logits_c - ref)
            hold(f"{label} step logits: RMS from the CPU's float32 logits, card / CPU (both "
                 f"bf16)", rms_g / rms_c, BF16_RMS_RATIO,
                 f"(card {rms_g:.4e}, CPU {rms_c:.4e}; card vs CPU max |diff| "
                 f"{logit_err / scale:.3e} of max |logit| {scale:.2f}, "
                 f"{'within' if logit_err <= BF16_LOGIT_TOL * scale else 'past'} "
                 f"{BF16_LOGIT_TOL:.0e}) ")
        else:
            hold(f"{label} step logits card vs CPU (relative to max |logit|)",
                 logit_err / scale, logit_tol, f"(max |logit| {scale:.2f}) ")
        lp_g = torch.log_softmax(logits_g, -1)
        sl32 = slg.to(torch.int32)
        k_trace = beam.beam_search(lp_g, sl32, width, lb)[0]
        p_trace = beam.beam_search_plain(lp_g, sl32, width, lb)[0]
        torch.cuda.synchronize()
        on_same = bsz - int((k_trace != p_trace).any(dim=(1, 2)).sum())
        reset()
        step_g = pipeline.unpack_step_outputs(
            pipeline.decode_step(on_card, xg, slg, width, lb, bf16_mode).cpu().numpy())
        torch.cuda.synchronize()
        dt = "bfloat16" if bf16_mode else "float32"
        check_counts(f"{label} decode_step", counts(),
                     {f"conv_bn_{dt}": n_conv,
                      f"bilstm_{dt}" if rnn_kernel == "bilstm" else rnn_kernel: 3,
                      "beam_search": 1, "beam_traceback": 1})
        step_c = pipeline.unpack_step_outputs(
            pipeline.decode_step(on_cpu, xc, slc, width, lb, bf16_mode).numpy())
        same = same_decodes(step_g, step_c, bsz)
        differ = [i for i in range(bsz) if not (
            step_g[1][i] == step_c[1][i]
            and (step_g[0][i, :step_g[1][i]] == step_c[0][i, :step_c[1][i]]).all())]
        if differ:
            lp_card = lp_g.cpu()
            lp_cpu = torch.log_softmax(logits_c, -1)
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"beam_differs_{label.replace(' ', '_')}.npz")
            np.savez(path, logits=logits_g.cpu().numpy()[differ],
                     logits_cpu=logits_c.numpy()[differ], lp_card=lp_card.numpy()[differ],
                     lp_cpu=lp_cpu.numpy()[differ], seq_len=slc.numpy()[differ],
                     windows=np.array(differ), beam_width=width, length_bonus=lb)
            for i in differ[:3]:
                div = beam.first_divergence(lp_card[i], lp_cpu[i], slc[i].to(torch.int32),
                                            width, lb)
                log(f"  {label}: window {i} decodes differently end to end; first divergence "
                    f"{json.dumps(div)} (a near-tie when the margin is within the rounding)")
            log(f"  {label}: saved the {len(differ)} windows that differ to {path}")
        log(f"  {label} step decodes (beam {width}): {on_same}/{bsz} windows with identical "
            f"traces, kernel vs plain on one lp tensor on the card (must be all); {same}/{bsz} "
            f"identical card vs CPU end to end"
            + (f" (must be >= {min_same:.0%}: rounding of the logits and of log_softmax may "
               f"flip a near-tie beam)" if not bf16_mode else
               f" ({'at or above' if same >= BF16_MIN_SAME * bsz else 'below'} "
               f"{BF16_MIN_SAME:.0%})"))
        ok = on_same == bsz
        if bf16_mode:
            as_f32_g = same_decodes(step_g, f32_ref["step_c"], bsz)
            as_f32_c = same_decodes(step_c, f32_ref["step_c"], bsz)
            log(f"  {label} decodes as the CPU's float32 step: card {as_f32_g}/{bsz}, CPU "
                f"{as_f32_c}/{bsz} (the card must be within {BF16_DECODE_SLACK:.0%} of the "
                f"windows of the CPU)")
            ok = ok and as_f32_g >= as_f32_c - BF16_DECODE_SLACK * bsz
        else:
            ok = ok and same >= min_same * bsz
        if failures or not ok:
            fail(f"{label}: card step disagrees with the CPU step: {failures}, identical "
                 f"{on_same} on the same lp, {same} end to end, of {bsz}")
        return {"logits_g": logits_g, "step_g": step_g, "logits_c": logits_c,
                "step_c": step_c}

    def bf16_vs_f32(label, f32_step, bf16_step, bsz):
        """bf16 against float32 mode on the card, one batch: max logit difference
        (beside the JAX package's own 0.15) and the share of identical decodes."""
        diff = float((bf16_step["logits_g"] - f32_step["logits_g"]).abs().max())
        scale = float(f32_step["logits_g"].abs().max())
        same = same_decodes(f32_step["step_g"], bf16_step["step_g"], bsz)
        log(f"  {label} bf16 vs float32 on the card: max |logit difference| {diff:.4f} "
            f"({diff / scale:.2e} of max |logit| {scale:.2f}; the JAX package's own bound "
            f"{JAX_BF16_BOUND}), identical decodes {same}/{bsz} ({same / bsz:.1%})")
        return {"max_logit_diff": diff, "relative": diff / scale, "identical_decodes": same,
                "windows": bsz}

    # one full batch per bundled model and mode: the step on the card against the
    # same step on the CPU. f32: 12-13 batch-stat convs and 3 BiLSTM layers whose
    # float32 sums run in another order on the card than on the CPU; two
    # correct CPU implementations (the JAX package and the port) differ by
    # 2.6e-4 of max |logit| on a dna-pre batch, so 5e-4 is the float32 floor.
    # bf16: see BF16_RMS_RATIO.
    config = C.read_config(os.path.join(MODEL_DIR, "model.json"))
    tree, _ = restore_latest(MODEL_DIR)
    gpu_model = from_jax_params(tree, config, "cuda")
    cpu_model = from_jax_params(tree, config, "cpu")
    dna_batch = load_batch(gpu_model, sig_dir, "dna-pre")
    xg, slg, xc, slc = dna_batch["float32"]
    lb = float(config["length_bonus"])
    mode_cmp, model_steps, model_rates = {}, {}, {}
    steps = {"float32": step_card_vs_cpu("DNA_default float32", gpu_model, cpu_model,
                                         dna_batch["float32"], lb=lb)}
    steps["bfloat16"] = step_card_vs_cpu("DNA_default bfloat16", gpu_model, cpu_model,
                                         dna_batch["bfloat16"], f32_ref=steps["float32"], lb=lb)
    mode_cmp["DNA_default"] = bf16_vs_f32("DNA_default", steps["float32"], steps["bfloat16"],
                                          BATCH)
    # a beam wider than a warp on the main path (the block kernel)
    step_card_vs_cpu("DNA_default beam 80", gpu_model, cpu_model, dna_batch["float32"],
                     width=80, lb=lb)
    model_steps["DNA_default"] = (gpu_model, dna_batch, lb)

    # ---- 3a. the other bundled models, DNA_slow and RNA_default, both modes -----
    # seeded reads for the 2000-sample presets: 8 reads of 38 windows (304 = 1
    # full batch of 300 + 4 wrap-padded); slow translocation at ~25 samples a level
    for name in ("DNA_slow", "RNA_default"):
        preset, mode, n_conv = MODELS[name]
        p = C.PRESETS[preset]
        in_dir = os.path.join(work, f"signal_{name}")
        m_reads, m_samples = 8, 37 * p["jump"] + 10
        write_reads(in_dir, m_reads, m_samples, rng, 25.0 if name == "DNA_slow" else 9.0)
        m_windows = m_reads * (-(-m_samples // p["jump"]))
        m_batches = -(-m_windows // p["batch_size"])
        mdir = os.path.join(REPO, "chiron_tpu", "model", name)
        m_config = C.read_config(os.path.join(mdir, "model.json"))
        m_tree, _ = restore_latest(mdir)
        m_gpu = from_jax_params(m_tree, m_config, "cuda")
        m_cpu = from_jax_params(m_tree, m_config, "cpu")
        m_lb = float(m_config.get("length_bonus", 0.0) or 0.0)
        m_batch = load_batch(m_gpu, in_dir, preset)
        m_steps = {}
        for tag, b16 in (("float32", False), ("bfloat16", True)):
            label = f"{name}{'_bf16' if b16 else ''}"
            cnt = counted_call(label, BEAM, mdir, preset, mode, b16, in_dir, m_reads, m_windows)
            check_counts(label, cnt, expected(m_batches, n_conv, dtype=tag))
            res, wall = call(os.path.join(work, f"out_{label}_warm"), BEAM, mdir, preset, mode,
                             b16, in_dir)
            model_rates[label] = {"windows": m_windows, "bases": res["total_bases"],
                                  "seconds": wall, "bases_per_s": res["total_bases"] / wall,
                                  "windows_per_s": m_windows / wall}
            log(f"warm call {label}: {json.dumps(model_rates[label])}")
            m_steps[tag] = step_card_vs_cpu(
                f"{name} {tag}", m_gpu, m_cpu, m_batch[tag], n_conv=n_conv,
                f32_ref=m_steps["float32"] if b16 else None, lb=m_lb)
        mode_cmp[name] = bf16_vs_f32(name, m_steps["float32"], m_steps["bfloat16"],
                                     p["batch_size"])
        model_steps[name] = (m_gpu, m_batch, m_lb)
        del m_cpu

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
                     expected(n_batches, rnn=fused_name[cell]))
        # --bf16: only the projections change (the GRU / BNLSTM kernels run
        # float32 in both modes), the convs take their bf16 instances
        check_counts(f"{cell} --bf16", counted_call(f"{cell}_bf16", BEAM, mdir, bf16_mode=True),
                     expected(n_batches, rnn=fused_name[cell], dtype="bfloat16"))
        res, wall = call(os.path.join(work, f"out_{cell}_warm"), BEAM, mdir)
        cell_rates[cell] = {"windows": n_windows, "bases": res["total_bases"], "seconds": wall,
                            "bases_per_s": res["total_bases"] / wall,
                            "windows_per_s": n_windows / wall}
        log(f"warm call -p dna-pre --beam 30 ({cell}): {json.dumps(cell_rates[cell])}")
        cell_tree, _ = restore_latest(mdir)
        cell_models[cell] = from_jax_params(cell_tree, cfg, "cuda")
        cell_cpu = from_jax_params(cell_tree, cfg, "cpu")
        # a model with random weights emits ~200 bases a window from posteriors
        # with no structure: many hypotheses score within float32 rounding of
        # each other, and on an H100 97.5-99.5% of the windows decode as on
        # the CPU although the logits agree to 4e-6 of max |logit| (a window
        # replayed on the CPU: two candidates 1.9e-6 apart, where the two
        # log_softmax roundings moved the scores by up to 3.8e-6). So the
        # end-to-end share is held at 95% here in float32; the decoder itself
        # is exact on one lp tensor. In bf16 mode the bf16 step gates.
        cell_f32 = step_card_vs_cpu(cell, cell_models[cell], cell_cpu, dna_batch["float32"],
                                    min_same=0.95, rnn_kernel=fused_name[cell], lb=lb)
        step_card_vs_cpu(f"{cell} bfloat16", cell_models[cell], cell_cpu, dna_batch["bfloat16"],
                         rnn_kernel=fused_name[cell], f32_ref=cell_f32, lb=lb)
        del cell_cpu

    # ---- 3c. the forward-only stack at full width, each cell type -----------
    uni_x = rnd(BATCH, SEG, 256)
    uni_name = {"LSTM": "lstm_layer_float32", "GRU": "gru_layer", "BNLSTM": "bnlstm_layer"}
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
        out_f32 = out_c
        scale = float(out_c.abs().max())
        hold(f"unirnn_layers {cell} [400, 400, 256] card vs CPU (relative to max |logit|)",
             float((out_g.cpu() - out_c).abs().max()) / scale, LOGIT_TOL,
             f"(max |logit| {scale:.3f}; launches {kernel}: {cnt[kernel]}) ")
        if cell == "LSTM":  # bf16 mode: the single direction's bf16 instance (row 5)
            with torch.no_grad():
                reset()
                out_g = R.unirnn_layers(uni_g, uni_x.to(torch.bfloat16), slg, cell, bf16=True)
                torch.cuda.synchronize()
                cnt = counts()
                out_c = R.unirnn_layers(uni, uni_x.cpu().to(torch.bfloat16), slc, cell,
                                        bf16=True)
            check_counts("unirnn_layers LSTM bf16", cnt, {"lstm_layer_bfloat16": 3})
            uni_counts["lstm_layer_bfloat16"] = cnt["lstm_layer_bfloat16"]
            rms_g, rms_c = rms(out_g.cpu() - out_f32), rms(out_c - out_f32)
            hold("unirnn_layers LSTM bf16 [400, 400, 256]: RMS from the CPU's float32 output, "
                 "card / CPU", rms_g / rms_c, BF16_RMS_RATIO,
                 f"(card {rms_g:.3e}, CPU {rms_c:.3e}; card vs CPU max |diff| "
                 f"{float((out_g.cpu() - out_c).abs().max()) / float(out_c.abs().max()):.3e} of "
                 f"max |logit|; launches lstm_layer_bfloat16: 3) ")

    # ---- 3d. one `rna`-layer-type LSTM batch through apply_model, both modes -
    rna_cfg = {**config, "rnn": {**config["rnn"], "layer_type": "rna"}}
    rna_tree = to_numpy_tree(from_jax_params(
        M.init_model(torch.Generator().manual_seed(SEED), rna_cfg), rna_cfg, "cpu"))
    rna_gpu = from_jax_params(rna_tree, rna_cfg, "cuda")
    rna_cpu = from_jax_params(rna_tree, rna_cfg, "cpu")
    rna_f32 = None
    for tag, b16 in (("float32", False), ("bfloat16", True)):
        xg_t, slg_t, xc_t, slc_t = dna_batch[tag]
        reset()
        rna_g = rna_gpu(xg_t, slg_t, bf16=b16)
        torch.cuda.synchronize()
        check_counts(f"rna-type LSTM batch {tag}", counts(),
                     {f"conv_bn_{tag}": 12, f"bilstm_{tag}": 3})
        rna_c = rna_cpu(xc_t, slc_t, bf16=b16)
        scale = float(rna_c.abs().max())
        err = float((rna_g.cpu() - rna_c).abs().max()) / scale
        if not b16:
            rna_f32 = rna_c
            hold("rna-type LSTM stack float32, one batch, logits card vs CPU (relative to max "
                 "|logit|)", err, LOGIT_TOL, f"(max |logit| {scale:.3f}) ")
        else:
            rms_g, rms_c = rms(rna_g.cpu() - rna_f32), rms(rna_c - rna_f32)
            hold("rna-type LSTM stack bf16, one batch: RMS from the CPU's float32 logits, card / "
                 "CPU", rms_g / rms_c, BF16_RMS_RATIO,
                 f"(card {rms_g:.3e}, CPU {rms_c:.3e}; card vs CPU max |diff| {err:.3e} of max "
                 f"|logit| {scale:.3f}) ")
    del rna_cpu
    if failures:
        fail(f"card disagrees with the CPU: {failures}")

    # ---- 4. the training path: `train` at DNA_default width ----------------
    phase("4. train")
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
    phase("5. timing")

    # where one warm full-batch step's device time goes (CUDA events)
    def step_parts(model, batch, lb_m, bf16_mode=False):
        xg_m, slg_m = batch[:2]
        front = M.CNN_ZOO[model.config["cnn"]["model"]][1]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        rnn_cfg = model.config["rnn"]
        with torch.no_grad():
            ev[0].record()
            fea = L.materialize(front(model.params["cnn"], xg_m[..., None], bf16=bf16_mode),
                                bf16_mode)
            ev[1].record()
            logits = R.rnn_layers(model.params["rnn"], fea, slg_m, rnn_cfg["cell_type"],
                                  rnn_cfg["layer_type"], bf16=bf16_mode)
            ev[2].record()
            prob = pipeline.path_prob(logits)
            dec = beam.beam_search_decode(logits, slg_m, BEAM, lb_m)
            ev[3].record()
            pipeline.pack_step_outputs(*dec, prob)
            ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    def log_step_parts(label, *args):
        step_parts(*args)
        parts = np.mean([step_parts(*args) for _ in range(3)], axis=0)
        log(f"one {label} beam-30 step, device ms: " + json.dumps(dict(zip(
            ("cnn_front", "rnn_stack_and_head", "path_prob_and_beam_decode", "pack"),
            [float(v) for v in parts]))))

    for name, (m_gpu, m_batch, m_lb) in model_steps.items():
        for tag, b16 in (("float32", False), ("bfloat16", True)):
            log_step_parts(f"{MODELS[name][0]} {name} {tag}", m_gpu, m_batch[tag], m_lb, b16)
    for cell, cell_model in cell_models.items():
        log_step_parts(f"dna-pre {cell} float32", cell_model, dna_batch["float32"], lb)
    # the device's busy share over one warm call of each mode (torch.profiler
    # kernel time)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tag, b16 in (("float32", False), ("bfloat16", True)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_p = call(os.path.join(work, f"out_prof_{tag}"), BEAM, bf16_mode=b16)
        kern = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy_s = sum(kern.values()) / 1e6
        if busy_s > 0:
            top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
            log(f"profiled warm call -p dna-pre --beam 30 {tag}: wall {wall_p:.3f} s, device "
                f"busy {busy_s:.3f} s, idle share {1 - busy_s / wall_p:.3f}; top device time "
                f"(ms): " + json.dumps({k[:60]: round(v / 1e3, 3) for k, v in top}))
        else:
            log(f"profiled warm call {tag}: device busy share not measured (no device events)")

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
    # the bf16 instances at the same shapes, beside the float32 instance on the
    # same raws upcast (in turns: f32, bf16, bf16, f32). Library: the same
    # function, F.conv1d + F.batch_norm on the upcast normalised input (TF32
    # off); a cuDNN bf16 conv (bf16 products: another function) as a note only
    conv_shapes_bf16 = {}
    for case in ("k3_two_terms_relu", "k1_two_terms_relu", "k1_cin1"):
        terms, w, relu, stride = conv_cases_bf16[case]
        terms32 = [(r.float(), a, b) for r, a, b in terms]
        z = sum(r.float() * a + b for r, a, b in terms)
        z_ncw = (torch.relu(z) if relu else z).transpose(1, 2).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()
        z16, w16 = z_ncw.to(bf16), w_oik.to(bf16)
        pad = (w.shape[0] - 1) // 2

        def run_bf16():
            return conv_bn.conv_bn(terms, w, relu, stride, out_dtype=bf16)

        def run_f32():
            return conv_bn.conv_bn(terms32, w, relu, stride)

        turns = [time_ms(torch, fn, 10) for fn in (run_f32, run_bf16, run_bf16, run_f32)]
        b_ms, b_by, b_unit = conv_bound(terms, w, stride, conv_route_bf16[case] == 2)
        conv_shapes_bf16[case] = {
            "ms": (turns[1] + turns[2]) / 2, "f32_instance_ms": (turns[0] + turns[3]) / 2,
            "turns_f32_bf16_bf16_f32": turns,
            "plain_ms": time_ms(torch, lambda: conv_bn.conv_bn_plain(terms, w, relu, stride,
                                                                     out_dtype=bf16), 5),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            "library_ms": time_ms(torch, lambda: F.batch_norm(
                F.conv1d(z_ncw, w_oik, padding=pad), None, None, training=True), 10),
            "note_cudnn_bf16_conv_ms": time_ms(torch, lambda: F.batch_norm(
                F.conv1d(z16, w16, padding=pad), None, None, training=True), 10),
            "route": conv_route_bf16[case]}
        if conv_shapes_bf16[case]["ms"] < b_ms:
            fail(f"conv_bn bf16 {case}: reads below its bound {b_ms:.4f} ms")
    log("conv_bn bf16 instances at dna_model1's shapes (bound at bf16 bytes; library = "
        "F.conv1d + F.batch_norm on the upcast input, TF32 off; cuDNN's bf16 conv, another "
        "function, as a note): " + json.dumps(conv_shapes_bf16))
    main_conv = conv_shapes["k3_two_terms_relu"]
    timing = {"conv_bn": (main_conv["ms"], main_conv["plain_ms"], main_conv["library_ms"])}
    main_bf16 = conv_shapes_bf16["k3_two_terms_relu"]
    timing["conv_bn_bf16"] = (main_bf16["ms"], main_bf16["plain_ms"], main_bf16["library_ms"])
    lstm_lib = torch.nn.LSTM(256, h, batch_first=False, bidirectional=True).to(dev)
    x_lib = rnd(t_len, BATCH, 256)
    with torch.no_grad():
        timing["bilstm"] = (time_ms(torch, lambda: bilstm.bilstm_layer(*lstm_args), 5),
                            time_ms(torch, lambda: bilstm.bilstm_layer_plain(*lstm_args), 2, 1),
                            time_ms(torch, lambda: lstm_lib(x_lib), 5))
        # the bf16 instance (rows 2 and 5) at T = B = 400, H = 128, beside the
        # float32 instance on the same xw upcast, in turns (f32, bf16, bf16, f32);
        # library: cuDNN's float32 LSTM, as for the float32 rows
        a16 = bf16_lstm_args
        a32 = (a16[0].float(), a16[1].float(), *a16[2:])
        one16 = (a16[1], a16[3], a16[4], a16[5])
        one32 = (a32[1], a32[3], a32[4], a32[5])
        lstm_lib_one = torch.nn.LSTM(256, h).to(dev)
        lstm_turns = {
            "bilstm": [time_ms(torch, lambda: bilstm.bilstm_layer(*a), 5)
                       for a in (a32, a16, a16, a32)],
            "lstm_layer": [time_ms(torch, lambda: lstm.lstm_layer(*a), 5)
                           for a in (one32, one16, one16, one32)]}
        timing["bilstm_bf16"] = (
            sum(lstm_turns["bilstm"][1:3]) / 2,
            time_ms(torch, lambda: bilstm.bilstm_layer_plain(*a16), 2, 1), timing["bilstm"][2])
        timing["lstm_layer_bf16"] = (
            sum(lstm_turns["lstm_layer"][1:3]) / 2,
            time_ms(torch, lambda: lstm.lstm_layer_plain(*one16), 2, 1),
            time_ms(torch, lambda: lstm_lib_one(x_lib), 5))
    log("LSTM inference kernel at T = B = 400, H = 128, ms in turns (float32 instance on the "
        f"upcast xw, bf16, bf16, float32): {json.dumps(lstm_turns)}; bf16 geometry "
        f"{bilstm.inference_geometry(BATCH, h, 2, dev, bf16)} fused, "
        f"{bilstm.inference_geometry(BATCH, h, 1, dev, bf16)} one direction")
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
        # each GRU instance at the same shape, in turns (resident, streamed,
        # streamed, resident)
        gru_side = {"bigru_layer": {}, "gru_layer": {}}
        gru_in = {"bigru_layer": ("bigru", rec_case["gru"][0:4:2], rec_case["gru"][1:4:2],
                                  rec_case["gru"][4:]),
                  "gru_layer": ("gru", (gx_b,), (cx_b,), (wh_gru_b,))}
        gru_runs = {
            name: {i: (lambda a, g: lambda: gru._launch(*a, rl, rs, g))(
                gru_in[name], gru.geometry(BATCH, h, len(gru_in[name][1]), i))
                for i in gru.INSTANCES}
            for name in gru_in}
        for name, runs in gru_runs.items():
            for which in ("resident", "streamed", "streamed", "resident"):
                gru_side[name].setdefault(which, []).append(time_ms(torch, runs[which], 5))
        # cuDNN's bidirectional GRU at the same width (input projection included):
        # the same FLOP of recurrence, another function (r after the product)
        gru_lib = torch.nn.GRU(256, h, bidirectional=True).to(dev)
        gru_cudnn_ms = time_ms(torch, lambda: gru_lib(x_lib), 5)
    log(f"GRU at T = B = 400, H = 128, ms in turns (resident, streamed, streamed, resident): "
        f"{json.dumps(gru_side)}; the chosen geometry fused ({gru_route(BATCH, h, 2)}) and "
        f"single ({gru_route(BATCH, h, 1)}); cuDNN nn.GRU(256, 128, bidirectional) "
        f"{gru_cudnn_ms:.4f} ms (r applied after the recurrent product: another function, not "
        f"a library yardstick)")
    with torch.no_grad():
        timing["bibnlstm_layer"] = (
            time_ms(torch, lambda: bnlstm.bibnlstm_layer(*rec_case["bn"], rl), 5),
            time_ms(torch, lambda: bnlstm.bibnlstm_layer_plain(*rec_case["bn"], rl), 2, 1), None)
        timing["bnlstm_layer"] = (
            time_ms(torch, lambda: bnlstm.bnlstm_layer(bn_xw, *bn_w, rl), 5),
            time_ms(torch, lambda: bnlstm.bnlstm_layer_plain(bn_xw, *bn_w, rl), 2, 1), None)
        # the cooperative instance at the same shape, in the same run
        coop = bnlstm.Geometry("cooperative", 1, -(-BATCH // 8), 1, 8, 1, 4 * h,
                               bnlstm.coop_smem_bytes(h, 8))
        coop_ms = {
            "bibnlstm_layer": time_ms(torch, lambda: bnlstm._launch(
                "bibnlstm", rec_case["bn"][:2], rec_case["bn"][2:], rl, coop), 3),
            "bnlstm_layer": time_ms(torch, lambda: bnlstm._launch(
                "bnlstm", (bn_xw,), (bn_w,), rl, coop), 3)}
    log(f"BNLSTM at T = B = 400, H = 128, ms: cluster instance ({bn_route(BATCH, h)}) "
        f"{timing['bibnlstm_layer'][0]:.4f} fused / {timing['bnlstm_layer'][0]:.4f} one direction; "
        f"cooperative instance (50 blocks of 8 rows a direction, grid barriers) "
        f"{coop_ms['bibnlstm_layer']:.4f} / {coop_ms['bnlstm_layer']:.4f}")

    # the recurrent kernels past H = 256 (the PERF.md sub-rows), T = B = 400, the
    # training LSTM at B = 300, and the beam search at widths past one warp
    wide_ms, wide_act = {}, {}
    for h_x in (384, 512):
        c_x = recurrent_inputs(t_len, BATCH, h_x)
        ln_x, st_x = c_x["lens"], c_x["starts"]
        wide_act[h_x] = (float(ln_x.sum()), float(ln_x[:tb].sum()))
        xw_x, wh_x = c_x["lstm"]
        gx_x, cx_x, whg_x = c_x["gru"][2], c_x["gru"][3], c_x["gru"][5]
        xt_x, lt_x = xw_x[:, :tb].contiguous(), ln_x[:tb].contiguous()
        res_x = lstm_grad.lstm_fwd_residuals(xt_x, wh_x, lt_x)
        dh_x = rnd(t_len, tb, h_x)
        with torch.no_grad():
            wide_ms[f"H={h_x}"] = {
                "bilstm": time_ms(torch, lambda: bilstm.bilstm_layer(
                    xw_x, c_x["bn"][0], wh_x, wh_x, ln_x, st_x), 2, 1),
                "lstm_layer": time_ms(torch, lambda: lstm.lstm_layer(xw_x, wh_x, ln_x, st_x), 2, 1),
                "bigru_layer": time_ms(torch, lambda: gru.bigru_layer(*c_x["gru"], ln_x, st_x), 2, 1),
                "gru_layer": time_ms(torch, lambda: gru.gru_layer(gx_x, cx_x, *whg_x, ln_x, st_x),
                                     2, 1),
                "bibnlstm_layer": time_ms(torch, lambda: bnlstm.bibnlstm_layer(*c_x["bn"], ln_x),
                                          2, 1),
                "bnlstm_layer": time_ms(torch, lambda: bnlstm.bnlstm_layer(
                    c_x["bn"][0], *c_x["bn"][2], ln_x), 2, 1),
                "lstm_fwd_residuals": time_ms(torch, lambda: lstm_grad.lstm_fwd_residuals(
                    xt_x, wh_x, lt_x), 2, 1),
                "lstm_bwd": time_ms(torch, lambda: lstm_grad.lstm_bwd(*res_x[1:], dh_x, wh_x, lt_x),
                                    2, 1)}
        del c_x, xw_x, gx_x, cx_x, xt_x, res_x
    log("recurrent kernels at H = 384 / 512 (T = B = 400; the training LSTM at B = 300), ms: "
        + json.dumps(wide_ms))
    # the BNLSTM "w" rows' bounds, counted as rows 10 / 11's below (the timed
    # inputs' lengths, T = B = 400)
    # the "w" rows' bounds, from the timed inputs' lengths as rows 2-11's below
    wide_bounds = {}
    for h_x in (384, 512):
        act_x, act_t = wide_act[h_x]
        fwd_x, bwd_x = train_lstm_bounds(act_t, t_len, tb, h_x)
        wide_bounds[f"H={h_x}"] = {
            "bilstm": recurrent_bound("lstm", act_x, t_len, BATCH, h_x, 2),
            "lstm_layer": recurrent_bound("lstm", act_x, t_len, BATCH, h_x),
            "lstm_fwd_residuals": fwd_x, "lstm_bwd": bwd_x,
            "bigru_layer": recurrent_bound("gru", act_x, t_len, BATCH, h_x, 2),
            "gru_layer": recurrent_bound("gru", act_x, t_len, BATCH, h_x),
            "bibnlstm_layer": recurrent_bound("bnlstm", act_x, t_len, BATCH, h_x, 2),
            "bnlstm_layer": recurrent_bound("bnlstm", act_x, t_len, BATCH, h_x),
            "gru_route": gru_route(BATCH, h_x, 2), "bnlstm_route": bn_route(BATCH, h_x)}
    log("recurrent kernels at H = 384 / 512 (T = B = 400; the training LSTM at B = 300), "
        "bound ms (by): " + json.dumps(wide_bounds))
    wide_beam = {}
    for w_x in (65, 100):
        b_ms, b_by = beam_bound(float(beam_lens.sum()), BATCH, t_len, w_x)
        wide_beam[f"W={w_x}"] = {
            "ms": time_ms(torch, lambda: beam.beam_search(lp, beam_lens, w_x, bonus), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by}
    log("beam_search past one warp (block kernel, B = T = 400, C = 5): " + json.dumps(wide_beam))

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
    # row 7 split into its recurrence and its dwh pass (profiler kernel time)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lstm_grad.lstm_bwd(*res_t[1:], dhs_t, wh_t, lens_t)
        torch.cuda.synchronize()
    # (mean over the kernel events the profiler recorded: it may record fewer
    # than the launches made)
    bwd_split = {}
    for ev in prof.key_averages():
        part = ("recurrence" if "lstm_bwd_kernel" in ev.key else
                "dwh_pass" if "lstm_dwh" in ev.key else None)
        if part:
            bwd_split[part] = bwd_split.get(part, 0.0) + ev.self_device_time_total / ev.count / 1e3
            bwd_split[f"{part}_events"] = ev.count
    log(f"  lstm_bwd T=400 B=300 H=128, device ms per launch by part (profiler): "
        f"{json.dumps(bwd_split)}")

    # bounds from this run's inputs (bytes: each input read once, each output
    # written once; operations: what these inputs need)
    act = float(rl.sum())  # active (row, step) pairs per direction
    bounds_fwd, bounds_bwd = train_lstm_bounds(float(lens_t.sum()), t_len, tb, h)
    bounds = {"lstm_layer": recurrent_bound("lstm", act, t_len, BATCH, h),
              "bigru_layer": recurrent_bound("gru", act, t_len, BATCH, h, 2),
              "gru_layer": recurrent_bound("gru", act, t_len, BATCH, h),
              "bnlstm_layer": recurrent_bound("bnlstm", act, t_len, BATCH, h),
              "bibnlstm_layer": recurrent_bound("bnlstm", act, t_len, BATCH, h, 2),
              "lstm_fwd_residuals": bounds_fwd,
              "lstm_bwd": bounds_bwd,
              "conv_bn": (main_conv["bound_ms"], main_conv["bound_by"]),
              "bilstm": recurrent_bound("lstm", float(lens.sum()), t_len, BATCH, h, 2),
              "conv_bn_bf16": (main_bf16["bound_ms"], main_bf16["bound_by"]),
              "bilstm_bf16": recurrent_bound("lstm", float(bf16_lstm_args[4].sum()), t_len,
                                             BATCH, h, 2, xw_bytes=2),
              "lstm_layer_bf16": recurrent_bound("lstm", float(bf16_lstm_args[4].sum()), t_len,
                                                 BATCH, h, xw_bytes=2),
              "beam_search": beam_bound(float(beam_lens.sum()), BATCH, t_len, BEAM),
              # best, path reads, chars
              "beam_traceback": bound_ms(BATCH * t_len, 4.0 * (BATCH + 2 * BATCH * t_len))}
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
        "conv_bn_bf16": ("chiron_tpu_torch/csrc/conv_bn.cu",
                         "chiron_tpu/ops/pallas/convbn.py:188", conv_err_bf16),
        "bilstm_bf16": ("chiron_tpu_torch/csrc/bilstm.cu", "chiron_tpu/ops/pallas/lstm.py:254",
                        lstm_err_bf16["bilstm"]),
        "lstm_layer_bf16": ("chiron_tpu_torch/csrc/bilstm.cu",
                            "chiron_tpu/ops/pallas/lstm.py:141", lstm_err_bf16["lstm_layer"]),
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
    # call (float32; --bf16 for the bf16 instances), the train run, the GRU and
    # BNLSTM calls, the forward-only stacks
    path_launches = {**beam_counts, **train_counts, **uni_counts,
                     "conv_bn": beam_counts["conv_bn_float32"],
                     "bilstm": beam_counts["bilstm_float32"],
                     "lstm_layer": uni_counts["lstm_layer_float32"],
                     "conv_bn_bf16": bf16_counts["conv_bn_bfloat16"],
                     "bilstm_bf16": bf16_counts["bilstm_bfloat16"],
                     "lstm_layer_bf16": uni_counts["lstm_layer_bfloat16"],
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
    log(f"  bounds: conv_bn's operations are {main_conv['bound_unit']} (tensor cores); the "
        "GRU's products 3 x FLOP / 495 TFLOP/s TF32 (tensor cores); every other kernel's "
        "FLOP / 67 TFLOP/s float32 (CUDA cores); bytes / 3.35 TB/s")
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound "
            f"{k['bound_ms']:.4f} by {k['bound_by']}, library {k['library_ms']})")
        if k["ms"] < k["bound_ms"]:
            fail(f"{k['name']}: {k['ms']:.4f} ms reads below its bound {k['bound_ms']:.4f} ms: "
                 "the count of its work is wrong")
    log("  kernel no slower than its library call: " + json.dumps(
        {k["name"]: k["ms"] <= k["library_ms"] for k in kernels if k["library_ms"]}))

    # ---- 6. bench and accuracy ---------------------------------------------
    phase("6. bench and accuracy")
    t6 = time.time()
    import contextlib
    import io
    import traceback
    import warnings

    from chiron_tpu_torch import accuracy, bench

    committed = accuracy.committed_rows()

    def accuracy_launches(doc, dtype):
        """A document's launches: per axis ceil(windows / batch) batches of
        its model (DNA_default 12 conv_bn at batch 400; DNA_slow 13 at 300;
        RNA_default 13 at 100), each 3 bilstm, 1 search, 1 traceback."""
        nb = {axis: -(-doc[axis]["n_windows"] // bsz) for axis, bsz in ACC_BATCH.items()}
        return {f"conv_bn_{dtype}": sum(n * (12 if a == "synthetic_dna" else 13)
                                        for a, n in nb.items()),
                f"bilstm_{dtype}": 3 * sum(nb.values()), "beam_search": sum(nb.values()),
                "beam_traceback": sum(nb.values())}

    # float32 through the entry point, then the same corpora in bf16 mode
    acc_docs = {}
    acc_path = os.path.join(out_dir, "accuracy_float32.json")
    reset()
    accuracy.main(["--beam", str(BEAM), "--skip", "real_dna", "--out", acc_path])
    torch.cuda.synchronize()
    acc_counts = {"float32": counts()}
    with open(acc_path) as f:
        acc_docs["float32"] = json.load(f)
    reset()
    acc_docs["bfloat16"] = accuracy.measure(tempfile.mkdtemp(dir=work), BEAM, skip={"real_dna"},
                                            device="cuda", bf16=True)
    torch.cuda.synchronize()
    acc_counts["bfloat16"] = counts()
    with open(os.path.join(out_dir, "accuracy_bfloat16.json"), "w") as f:
        json.dump(acc_docs["bfloat16"], f, indent=2, sort_keys=True)
    for dt, doc in acc_docs.items():
        log(f"accuracy beam {BEAM} {dt}: launches {acc_counts[dt]}")
        check_counts(f"accuracy {dt}", acc_counts[dt], accuracy_launches(doc, dt))
    acc_fail = []
    for axis in accuracy.SYNTHETIC_AXES:
        ref = committed[axis]
        id_floor, k_floor = SMOKE_FLOORS[axis]
        for dt, doc in acc_docs.items():
            row = doc[axis]
            d_skill, d_kmer = row["skill"] - ref["skill"], row["kmer11_hit_rate"] - \
                ref["kmer11_hit_rate"]
            floors_ok = row["identity"] >= id_floor and row["kmer11_hit_rate"] >= k_floor
            rows_ok = abs(d_skill) <= SKILL_TOL and abs(d_kmer) <= KMER11_TOL
            ok = floors_ok and (rows_ok or dt == "bfloat16")
            log(f"  {axis} {dt}: identity {row['identity']:.4f} skill {row['skill']:.4f} "
                f"kmer11 {row['kmer11_hit_rate']:.4f} ({row['n_reads']} reads, "
                f"{row['n_windows']} windows); committed skill {ref['skill']:.4f} kmer11 "
                f"{ref['kmer11_hit_rate']:.4f}: skill {d_skill:+.4f} (+-{SKILL_TOL}), kmer11 "
                f"{d_kmer:+.4f} (+-{KMER11_TOL}) {'within' if rows_ok else 'past'}"
                f"{' (gated)' if dt == 'float32' else ' (printed)'}; smoke floors identity "
                f">= {id_floor}, kmer11 >= {k_floor} {'ok' if ok else 'FAIL'}")
            if not ok:
                acc_fail.append(f"{axis} {dt}")
    if acc_fail:
        fail(f"accuracy off its committed rows or under the smoke floors: {acc_fail}")

    # the bench's line through its entry point, every count set to 0 before it:
    # 1 warm-up + 5 timed calls, then 1 + 3 x 4 steps each of the two device axes
    reset()
    bench_out = io.StringIO()
    with contextlib.redirect_stdout(bench_out):
        bench.main([])
    torch.cuda.synchronize()
    bench_counts = counts()
    bench_line = json.loads(bench_out.getvalue().strip().splitlines()[-1])
    log(json.dumps(bench_line))
    nb = 6 * -(-bench_line["call_windows"] // BATCH)
    n_dev = 1 + 3 * 4
    check_counts("bench", bench_counts,
                 {"conv_bn_bfloat16": 12 * nb + 12 * n_dev + 13 * n_dev,
                  "bilstm_bfloat16": 3 * (nb + 2 * n_dev), "beam_search": nb + 2 * n_dev,
                  "beam_traceback": nb + 2 * n_dev})
    log(f"bench launches {bench_counts}")
    # the device's idle share over one warm call of the bench's input (the
    # warm-up call outside the profiled window)
    bench_dir = os.path.join(work, "bench")
    bench_input = bench.simulated_input(bench_dir)[0]
    pipeline.evaluation(bench.make_flags(bench_input, os.path.join(bench_dir, "warm"),
                                         bench.MODEL_DNA))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        pipeline.evaluation(bench.make_flags(bench_input, os.path.join(bench_dir, "profiled"),
                                             bench.MODEL_DNA))
        torch.cuda.synchronize()
        wall_b = time.time() - t
    busy_b = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e6
    bench_idle = 1 - busy_b / wall_b if busy_b > 0 else None
    log(f"profiled warm bench call (bf16, beam {BEAM}): wall {wall_b:.3f} s, device busy "
        f"{busy_b:.3f} s, idle share "
        f"{'not measured (no device events)' if bench_idle is None else f'{bench_idle:.3f}'}")

    # every kernel of the bench's step at B = 2,000 against its plain version on
    # the card, both instances: conv_bn (both routes), bilstm at T = 400, H =
    # 128 (the geometry inference_geometry picks for 2,000 rows), and below the
    # beam search and traceback on the 2,000-window step's own lp
    big_b = 5 * BATCH
    g2k = torch.Generator(device=dev).manual_seed(SEED)

    def rnd2k(*shape, scale=1.0):
        return torch.randn(*shape, generator=g2k, device=dev) * scale

    conv2k = {"k3_two_terms_relu": ([(rnd2k(big_b, SEG, c), rnd2k(c).abs() + 0.5,
                                      rnd2k(c, scale=0.2)) for _ in range(2)],
                                    rnd2k(3, c, c, scale=(2 / (4 * c)) ** 0.5), True),
              "k1_cin1": ([(rnd2k(big_b, SEG, 1), torch.ones(1, device=dev),
                            torch.zeros(1, device=dev))], rnd2k(1, 1, c, scale=(2 / (1 + c)) ** 0.5),
                          False)}
    for case, (terms, w, relu) in conv2k.items():
        for dt in (torch.float32, torch.bfloat16):
            terms_dt = [(r.to(dt), a, b_) for r, a, b_ in terms]
            y, s_, q = conv_bn.conv_bn(terms_dt, w, relu, 1, out_dtype=dt)
            py, ps, pq = conv_bn.conv_bn_plain(terms_dt, w, relu, 1, out_dtype=dt)
            torch.cuda.synchronize()
            mom = max(float(((s_ - ps).abs() / ps.abs().clamp(min=1.0)).max()),
                      float(((q - pq).abs() / pq.abs().clamp(min=1.0)).max()))
            name = f"conv_bn {case} B=2000 {str(dt).split('.')[-1]}"
            if dt == torch.float32:
                hold(f"{name} y", float((y - py).abs().max()), 1e-4)
            else:
                bf16_hold(f"{name} y", y, py, 1e-4)
            hold(f"{name} moments (relative)", mom, 1e-4)
            del y, py
    del conv2k, terms
    ln2k = torch.randint(0, t_len + 1, (big_b,), generator=gen).to(torch.int32)
    ln2k[0], ln2k[-1] = 0, t_len
    ln2k = ln2k.to(dev)
    args2k = (rnd2k(t_len, big_b, 4 * h), rnd2k(t_len, big_b, 4 * h),
              rnd2k(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2),
              rnd2k(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2), ln2k,
              (t_len - ln2k).to(torch.int32))
    hold(f"bilstm T=400 B=2000 H=128 ({geometry('infer', big_b, h, 2)})",
         max_err(bilstm.bilstm_layer(*args2k), bilstm.bilstm_layer_plain(*args2k)), 1e-4)
    args2k = (args2k[0].to(bf16), args2k[1].to(bf16), *args2k[2:])
    got2k, want2k = bilstm.bilstm_layer(*args2k), bilstm.bilstm_layer_plain(*args2k)
    for i, name in enumerate(("fw", "bw")):
        bf16_hold(f"bilstm {name} bf16 T=400 B=2000 H=128"
                  + (f" ({geometry('infer', big_b, h, 2, 2)})" if i == 0 else ""),
                  got2k[i], want2k[i], 1e-4)
    del args2k, got2k, want2k
    if failures:
        fail(f"a kernel disagrees with its plain version at B = 2000: {failures}")

    # the 2,000-window step against five 400-window steps on the same windows:
    # the five copies are permutations of one full batch of the bench's corpus,
    # so the batch-stat BN moments of every step are those of that batch (up
    # to float32 sum order), while rows i and i + 400 hold different windows.
    # Each 2,000-window run's conv outputs, LSTM inputs (xw), LSTM outputs and
    # logits are held bit for bit (first 400 rows) against the 400-window
    # step's, which names the first stage where the two part. A second
    # 2,000-window run takes each conv's BN affine from the unpermuted
    # 400-window step (models/layers.py calls bn_affine once a batch-stat conv),
    # so all five of its copies are held to that one step: its own BN (mean,
    # var), on inputs that the pinned affines keep equal upstream, are read
    # against the 400-window step's in float32 ulps. In bf16 the plain CPU path
    # on the same windows (2,000 against five 400) is a second witness.
    big_batch = load_batch(gpu_model, bench_input, "dna-pre")
    perms = [torch.arange(BATCH)] + [torch.randperm(BATCH, generator=torch.Generator()
                                                    .manual_seed(k)) for k in range(1, 5)]
    inv = [torch.argsort(p).numpy() for p in perms]
    big_cmp, steps2k = {}, {}
    bn_affine, conv_bn_fn, bilstm_fn = L.bn_affine, L.conv_bn, R.bilstm_layer
    trace = {"affines": None, "pin": None, "ref": None, "cmp": None}

    def traced_bn_affine(sums, sqs, count, scale, offset):
        a, b_ = bn_affine(sums, sqs, count, scale, offset)
        if trace["affines"] is not None:
            mean = sums / count
            trace["affines"].append((mean, torch.clamp(sqs / count - mean * mean, min=0.0),
                                     sqs / count, a, b_))
            if trace["pin"] is not None:
                a, b_ = trace["pin"][len(trace["affines"]) - 1][3:]
        return a, b_

    def stage(name, t, dim):
        """A stage output's first 400 rows (batch dim ``dim``): kept as the
        reference, or compared bit for bit with the reference's."""
        rows = t.narrow(dim, 0, BATCH)
        if trace["ref"] is not None:
            trace["ref"].append(rows.clone())
        if trace["cmp"] is not None:
            ref_rows = small_ref[len(trace["cmp"])]
            trace["cmp"].append((name, float((rows != ref_rows).float().mean())))

    def traced_conv_bn(*args, **kw):
        out = conv_bn_fn(*args, **kw)
        stage("conv", out[0], 0)
        return out

    def traced_bilstm(xw_fw, xw_bw, *args):
        stage("xw_fw", xw_fw, 1)
        stage("xw_bw", xw_bw, 1)
        out = bilstm_fn(xw_fw, xw_bw, *args)
        stage("h_fw", out[0], 1)
        stage("h_bw", out[1], 1)
        return out

    def parting(cmp):
        """The stages that differ, in order, as 'name#index: share of elements'."""
        return [f"{name}#{i}: {share:.2e}" for i, (name, share) in enumerate(cmp) if share]

    def ulps(got, want, unit_of):
        """max |got - want| in float32 ulps of unit_of."""
        unit = torch.abs(unit_of.float()).clamp(min=torch.finfo(torch.float32).tiny)
        return float(((got - want).abs() / torch.pow(2.0, torch.floor(torch.log2(unit)) - 23))
                     .max())

    def as_small(big, k):
        return tuple(a[k * BATCH:(k + 1) * BATCH] for a in big)

    class FixedLogits:
        """decode_step's model, returning given logits on the card: the CPU
        path's logits decoded by the card's beam kernels."""
        config = gpu_model.config

        def __init__(self, logits):
            self.logits = logits.to(dev)

        def __call__(self, x, seq_len, bf16=False):
            return self.logits

    def step(model, x, sl, b16):
        return pipeline.unpack_step_outputs(
            pipeline.decode_step(model, x, sl, BEAM, lb, b16).cpu().numpy())

    L.bn_affine, L.conv_bn, R.bilstm_layer = traced_bn_affine, traced_conv_bn, traced_bilstm
    try:
        for dt, b16 in (("float32", False), ("bfloat16", True)):
            xg_b, slg_b, xc_b, slc_b = big_batch[dt]
            parts = [(xg_b[p.to(dev)], slg_b[p.to(dev)]) for p in perms]
            big_x, big_sl = torch.cat([x for x, _ in parts]), torch.cat([s for _, s in parts])
            with torch.no_grad():
                # the 400-window step of the unpermuted batch: the reference
                trace.update(affines=[], ref=[])
                small = [step(gpu_model, *parts[0], b16)]
                small_aff, small_ref = trace["affines"], trace["ref"]
                trace.update(affines=None, ref=None)
                small += [step(gpu_model, x, s_, b16) for x, s_ in parts[1:]]
                # the 2,000-window step as it runs, its launches counted
                trace.update(affines=[], cmp=[])
                reset()
                big = step(gpu_model, big_x, big_sl, b16)
                torch.cuda.synchronize()
                check_counts(f"2000-window step {dt}", counts(),
                             {f"conv_bn_{dt}": 12, f"bilstm_{dt}": 3, "beam_search": 1,
                              "beam_traceback": 1})
                big_aff, big_stages = trace["affines"], trace["cmp"]
                # the same step with every conv's affine pinned to the 400-window step's
                trace.update(affines=[], cmp=[], pin=small_aff)
                pinned = step(gpu_model, big_x, big_sl, b16)
                pin_aff, pin_stages = trace["affines"], trace["cmp"]
                trace.update(affines=[], cmp=None)
                pinned_logits = gpu_model(big_x, big_sl, bf16=b16)
                trace.update(affines=None, pin=None)
                del small_ref
                big_logits = gpu_model(big_x, big_sl, bf16=b16)
                small_logits = torch.cat([gpu_model(x, s_, bf16=b16) for x, s_ in parts])
                for run, run_logits in ((big_stages, big_logits), (pin_stages, pinned_logits)):
                    run.append(("logits", float((run_logits[:BATCH] != small_logits[:BATCH])
                                                .float().mean())))
                # the pinned run's five copies against the unpermuted 400-window step
                pinned_ref = torch.cat([small_logits[:BATCH][p.to(dev)] for p in perms])
                same_pinned = sum(same_decodes(as_small(pinned, k),
                                               tuple(a[p.numpy()] for a in small[0]), BATCH)
                                  for k, p in enumerate(perms))
                diff_pinned = float((pinned_logits - pinned_ref).abs().max())
                del pinned_logits, pinned_ref
                # bf16: the plain CPU path on the same windows, decoded by the card's kernels
                same_cpu = diff_cpu = t_cpu = None
                if b16:
                    t_cpu = time.time()
                    cpu_parts = [(xc_b[p], slc_b[p]) for p in perms]
                    cpu_big = cpu_model(torch.cat([x for x, _ in cpu_parts]),
                                        torch.cat([s_ for _, s_ in cpu_parts]), bf16=b16)
                    cpu_small = torch.cat([cpu_model(x, s_, bf16=b16) for x, s_ in cpu_parts])
                    t_cpu = time.time() - t_cpu
                    cpu_big_step = step(FixedLogits(cpu_big), big_x, big_sl, b16)
                    same_cpu = sum(same_decodes(as_small(cpu_big_step, k), step(
                        FixedLogits(cpu_small[k * BATCH:(k + 1) * BATCH]), x, s_, b16), BATCH)
                        for k, (x, s_) in enumerate(parts))
                    diff_cpu = float((cpu_big - cpu_small).abs().max())
                    del cpu_big, cpu_small
            torch.cuda.synchronize()
            if not len(big_aff) == len(pin_aff) == len(small_aff) > 0:
                fail(f"{dt}: BN affines read {len(big_aff)}, {len(pin_aff)}, {len(small_aff)}")

            def aff_ulps(aff):
                return [(ulps(m2, m4, e4.sqrt()), ulps(v2, v4, e4))
                        for (m2, v2, *_), (m4, v4, e4, *_) in zip(aff, small_aff)]

            pin_ulps, big_ulps = aff_ulps(pin_aff), aff_ulps(big_aff)
            aff_max = max(max(u) for u in pin_ulps)
            aff_ok = aff_max <= AFFINE_MAX_ULPS
            aff_same = sum(bool(torch.equal(x2[3], x4[3]) and torch.equal(x2[4], x4[4]))
                           for x2, x4 in zip(big_aff, small_aff))
            log(f"  {dt} BN moments of the {len(small_aff)} batch-stat convs, 2000-window "
                f"step vs the 400-window step, as float32 ulps (mean in ulps of rms(y), var "
                f"in ulps of E[y^2]); with the affines pinned upstream: "
                f"{json.dumps(pin_ulps)} (last bits: <= {AFFINE_MAX_ULPS} "
                f"{'ok' if aff_ok else 'FAIL'}); as the step runs: {json.dumps(big_ulps)}, "
                f"{aff_same}/{len(small_aff)} affines (a, b) bit-identical")
            log(f"  {dt} first 400 rows, 2000-window step vs the 400-window step, stages that "
                f"differ (share of elements; {len(big_stages)} stages: conv outputs, per "
                f"LSTM layer xw_fw, xw_bw, h_fw, h_bw, then the logits): as it runs "
                f"{parting(big_stages) or 'none'}; affines pinned {parting(pin_stages) or 'none'}")
            steps2k[dt] = (big, small, big_logits, small_logits)
            same = sum(same_decodes(as_small(big, k), small[k], BATCH) for k in range(5))
            # control: the permuted 400-window steps against the unpermuted one, window by window
            control = min(same_decodes(tuple(a[inv[k]] for a in small[k]), small[0], BATCH)
                          for k in range(1, 5))
            diff = float((big_logits - small_logits).abs().max())
            scale = float(small_logits.abs().max())
            met = same >= BIG_MIN_SAME * big_b
            row = {"identical_decodes": same, "windows": big_b, "max_logit_diff": diff,
                   "max_logit": scale, "permuted_400_control_min": control,
                   "min_same_met": met, "affines_bit_identical": aff_same,
                   "pinned_moment_ulps_max": aff_max, "stages_differing": parting(big_stages),
                   "pinned_stages_differing": parting(pin_stages),
                   "pinned_identical_decodes": same_pinned,
                   "pinned_max_logit_diff": diff_pinned,
                   "cpu_plain_identical_decodes": same_cpu, "cpu_plain_max_logit_diff": diff_cpu,
                   "cpu_plain_seconds": t_cpu}
            pinned_ok = same_pinned >= BIG_MIN_SAME * big_b
            ok = aff_ok and pinned_ok
            if not b16:
                ok = ok and met
                gate = f">= {BIG_MIN_SAME:.1%}: {'met' if met else 'NOT MET'}"
            else:
                # bf16: float32 residues of another sum order flip bf16 roundings
                # downstream (see BF16_RMS_RATIO), so BIG_MIN_SAME is printed, met
                # or not, beside the stages and witnesses above; the step is
                # held to the float32 five 400-window steps as the bf16 call steps
                # are held to float32 (BF16_RMS_RATIO, BF16_DECODE_SLACK)
                _, f32_small, _, f32_logits = steps2k["float32"]
                rms_big, rms_small = rms(big_logits - f32_logits), rms(small_logits - f32_logits)
                as_f32_big = sum(same_decodes(as_small(big, k), f32_small[k], BATCH)
                                 for k in range(5))
                as_f32_small = sum(same_decodes(small[k], f32_small[k], BATCH)
                                   for k in range(5))
                ok = ok and (rms_big / rms_small <= BF16_RMS_RATIO
                             and as_f32_big >= as_f32_small - BF16_DECODE_SLACK * big_b)
                gate = (f">= {BIG_MIN_SAME:.1%}: {'met' if met else 'NOT MET'}; held to the "
                        f"float32 400-window steps: RMS from their logits, 2000 / 400 "
                        f"{rms_big:.4e} / {rms_small:.4e} = {rms_big / rms_small:.3f} (<= "
                        f"{BF16_RMS_RATIO}); decoding as they do {as_f32_big} / {as_f32_small} "
                        f"of {big_b} (within {BF16_DECODE_SLACK:.0%})")
                row.update(rms_ratio=rms_big / rms_small, as_float32_2000=as_f32_big,
                           as_float32_400=as_f32_small)
            big_cmp[dt] = row
            log(f"  2000-window step {dt} vs five 400-window steps: {same}/{big_b} windows "
                f"decode identically ({gate}), max |logit difference| {diff:.3e} (max |logit| "
                f"{scale:.2f}); control, a permuted 400-window step vs the unpermuted one: >= "
                f"{control}/{BATCH} identical")
            log(f"  2000-window step {dt} with each conv's BN affine pinned to the unpermuted "
                f"400-window step's, its five copies against that step: {same_pinned}/{big_b} "
                f"decode identically (>= {BIG_MIN_SAME:.1%} {'ok' if pinned_ok else 'FAIL'}), "
                f"max |logit difference| {diff_pinned:.3e}")
            if b16:
                log(f"  plain CPU path, 2000 vs five 400 on the same windows (its logits decoded "
                    f"by the card's beam kernels; forward {t_cpu:.1f} s): {same_cpu}/{big_b} "
                    f"identical, max |logit difference| {diff_cpu:.3e}")
            log(f"  2000-window step {dt}: {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the 2000-window {dt} step disagrees with five 400-window steps")
    finally:
        L.bn_affine, L.conv_bn, R.bilstm_layer = bn_affine, conv_bn_fn, bilstm_fn
    # where the bench's device step goes at B = 2,000 (bf16, CUDA events)
    log_step_parts("dna-pre DNA_default bfloat16 B=2000", gpu_model, (big_x, big_sl), lb, True)
    # the beam kernel and its plain version on the 2,000-window step's lp
    lp2k = torch.log_softmax(steps2k["float32"][2], -1)
    sl2k = big_sl.to(torch.int32)
    trace2k, pb2k, pnb2k = beam.beam_search(lp2k, sl2k, BEAM, lb)
    ptrace2k = beam.beam_search_plain(lp2k, sl2k, BEAM, lb)[0]
    best2k = torch.argmax(beam._lae(pb2k, pnb2k), dim=1).to(torch.int32)
    tb2k = int((beam.beam_traceback(trace2k, best2k)
                != beam.beam_traceback_plain(trace2k, best2k)).sum())
    beam_rows = int((trace2k != ptrace2k).any(dim=(1, 2)).sum())
    log(f"  beam_search W=30 B=2000 on the step's lp: rows whose trace differs from the plain "
        f"version's {beam_rows} (must be 0); beam_traceback chars that differ {tb2k} (must be 0)")
    if beam_rows or tb2k:
        fail("the beam kernels disagree with their plain versions at B = 2000")
    # host syncs inside one bf16 step at batch 2,000 (torch's sync debug mode),
    # each named by the innermost frame of the port's code that reached it
    syncs = []

    def record_sync(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            port = [f"{os.path.relpath(fr.filename, REPO)}:{fr.lineno}"
                    for fr in traceback.extract_stack()[:-1]
                    if fr.filename.startswith(os.path.join(REPO, "chiron_tpu_torch"))]
            syncs.append(port[-1] if port else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.no_grad():
                pipeline.decode_step(gpu_model, big_x, big_sl, BEAM, lb, True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sorted(set(syncs))
    log(f"  host syncs inside one decode_step (B = 2000, bf16): {len(syncs)} sites {syncs}")
    log(json.dumps({"bench": bench_line, "bench_call_idle_share": bench_idle,
                    "accuracy": {dt: {a: {k: doc[a][k] for k in ("identity", "skill",
                                                                  "kmer11_hit_rate")}
                                      for a in accuracy.SYNTHETIC_AXES}
                                 for dt, doc in acc_docs.items()},
                    "step_2000_vs_5x400": big_cmp, "decode_step_sync_sites": syncs}))
    log(f"phase 6 took {time.time() - t6:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({**{f"call_{k}": r for k, r in call_rates.items()},
                    "train_s400_b300": train_rate,
                    **{f"call_dna_pre_beam30_{c}": r for c, r in cell_rates.items()},
                    **{f"call_{k}_beam30": r for k, r in model_rates.items()},
                    "bf16_vs_float32_on_the_card": mode_cmp}))
    phase("done")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU")
    parser.add_argument("--out", default=OUT_DIR,
                        help="directory for the windows that decode differently card vs CPU")
    main(parser.parse_args().out)
