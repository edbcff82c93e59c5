#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chiron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

DIR (default chiron_tpu_torch/_build/chip_smoke, gitignored) receives the
windows of a call step that decode differently on the card and on the CPU,
and phase 10's work directory (its configs, metrics and rankings; its
corpora, caches and checkpoints are removed at the end of the phase).

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
     training LSTM's and the CTC loss's launch counts set to 0 just before
     and read just after (6 forward + 6 backward, and one ctc_alpha and one
     ctc_beta_grad, per step); check the files it writes and that
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
     into forward / loss / backward / update; the CTC loss's two kernels
     beside its plain version and F.ctc_loss at the train step's shape, held
     to the plain version (values 1e-5 relative, gradients 1e-5); the bf16
     instances beside the
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
     identical in both modes); the host syncs inside one decode_step; each
     run's launch counts (the plain CPU path's 2,000 vs five 400, and the JAX
     package's, are tools_dev/bf16_batch_check.py's, on a CPU);
  7. the CNN zoo: for every front of the JAX package's zoo that no bundled
     model runs (ZOO: at its published widths, a dynamic_net with every
     layer type and one of tools/grid_search.py's form) and for
     DNA_default's front with the CNN-only logit head, a seeded checkpoint
     with DNA_default's RNN: `call` at beam 30 on one full dna-pre batch in
     both modes, every count checked (conv_bn as fused_convs computes it from
     the config), its step on the card against the CPU (float32: logits 5e-4
     of max |logit|, >= 95% identical decodes, as the random-weight GRU /
     BNLSTM models; bf16: BF16_RMS_RATIO), and where each step's device time
     goes; conv_bn at every new shape those calls gave it, each instance with
     the route it takes, held against its plain version and timed beside its
     bound and cuDNN; `train` on gate_conv_net and on the CNN-only head
     (loss falling, launches counted) and one of their steps on the card
     against the CPU;
  8. serving and the training sources: export DNA_default through the
     port's export_model (segment 400, beam 30, and a second bundle at
     beam 0) into DIR/serving, serve it on 127.0.0.1 (batch 400, the card)
     and send it phase 3's windows from 4 client threads at once: phase 3's
     first batch with its logits, 800, 137 (wrap-padded) and 1 windows;
     every response bit for bit the port's decode_step on the card with
     length_bonus 0 on the same wrap-padded batch, -1 past each length, the
     first batch's logits phase 3's card logits, every launch count as the
     requests' steps predict; latency p50 / p95 of 400-window requests with
     1 client (20 requests) and 4 concurrent clients (10 each), windows/s,
     the lock's held time, the card's idle share over a profiled 4-client
     run, the protocol's host time; run_call through the server on three of
     phase 3's reads, each fastq byte for byte a one-read `call -b 400 --beam
     30 --length_bonus 0`'s; the beam-0 bundle for two requests; then phase
     4's reads as a .bin folder, a TFRecord (int16 signals) and a window
     cache, each equal to the in-RAM .signal/.label arrays, and `train -s 400
     -b 300 -x 10` from each with the training LSTM's launches counted;
  9. multi-GPU (chiron_tpu_torch/parallel) on the one card: the sharded
     decode over [cuda:0] * 4 on phase 3's first batch at beam 30 and 0,
     equal bit for bit to four decode_steps on contiguous rows (and over
     [cuda:0] to phase 3's step), with no host sync inside the step (torch's
     sync debug mode set to raise), its launches counted and its device time
     beside the 1-shard step's; two training ranks sharing cuda:0 through
     gloo (-s 400 -b 300, DNA_default's bundled weights) against the
     one-process global-batch step (loss 1e-5 relative, phase 4's gradient
     gate, the training LSTM launched in each rank); one step in an NCCL
     group of one rank through initialize_distributed, equal bit for bit to
     the step without a group; `call --n_devices` past the visible GPUs
     raising with the device count;
 10. the model tools (chiron_tpu_torch/tools/{net2wide,make_bundled_models,
     grid_search,mfu}.py), each run with every count set to 0 just before
     and read just after, its counts added to the kernel line's: RNA_default
     widened from H = 100 to 128 and DNA_default from 128 to 256 (noise 0),
     one full rna-pre / dna-pre batch of each at beam 30 against the
     original's card logits (1e-4 of max |logit|, >= 99% identical decodes),
     the gap at the default noise printed, and the BiLSTM kernel at H = 256
     and a full batch timed beside row 2; the bundled-model recipe in DIR:
     the DNA corpus at each of its variants (RECIPE_READS reads a variant),
     `_train dna` at its width (400 x 400, the window cache) with its first
     step's loss card vs CPU (1e-4 relative), `stage_finetune` from the
     bundled DNA_default, the RNA corpus and `_train rna` (2000 x 100),
     `stage_install` into DIR, `call -p dna-pre --beam 30` with the
     installed model and `_read_logits` card vs CPU (1e-4 of max); each
     training run's windows/s; `grid_search` over its 16 candidates at its
     widths (64 x 300, GRID_STEPS steps each) on phase 4's reads, every loss
     finite, each candidate's s/step; the analytic FLOPs a sample of the
     three bundled models and the share of the bf16 peak at phase 6's device
     samples/s, beside the card's name and power limit;
 11. the last modules, each run counted and added to the kernel line's counts:
     11a `ops/ctc_mc.mc_decode` at S = 300 on phase 3's first dna-pre batch's
     logits, twice with one seed (identical), its sampled class frequencies
     within 5 binomial SD of the softmax, its mode strings equal to the CPU's
     wherever the CPU's top path holds >= 60% of the samples, its agreement
     with phase 3's beam-30 decode, device and host ms; 11b `section_decoding`
     on the same logits (frames past each window's length set to blank), gated
     the same way section by section; 11c the attention decoder (hidden 128,
     64 steps, seeded weights carried across by `params.attention_from_jax`)
     over DNA_default's encoder features of that batch: greedy tokens card vs
     CPU on >= 99% of the windows, teacher-forced logits 1e-4 of max |logit|,
     loss 1e-5, gradients 1e-4 of each leaf's max, device ms; 11d the native
     host library built with g++ (fails otherwise), phase 3's reads parsed and
     glued natively and on the numpy paths (equal, host ms a read), and one
     `call -p dna-pre` on the numpy paths whose fastq equals phase 3's; 11e the
     fast5 tools are not run (no h5py on the card's machine: the CPU tests hold
     them);
 12. Bonito's HAC CRF model (CRF_CONFIG: dna_r9.4.1_e8_hac@v3.3 at its
     published widths, the benchmark configuration's seeded weights) written
     as a model directory: `call -l 4000 -j 3500 -b 400 --sig_norm 0` on 20
     seeded reads (820 windows, 3 batches) in both modes, twice each, every
     count set to 0 just before (conv_bn 3, the one-direction LSTM kernel 5
     and each CRF kernel 1 a batch, in the mode's instances; the LSTM's 5 on
     csrc/lstm_c16.cu in float32, on the streamed instance in bf16) and the frames
     the CRF kernels decoded equal to the windows' ceil(samples / 5); the
     fastq files; the first batch's step against the plain reference
     (reference/bonito_crf.py) on the card on its first CRF_REF_ROWS windows
     (float32 held, bf16 printed); the three CRF kernels against their plain
     version on that batch's scores (B = 400, T = 800, 1,024 states; a row on
     another path must be a near-tie: both paths within 1e-3 a frame under the
     plain version's log posteriors) and the
     stem's three convs (swish prologue, k // 2 padding, T = 4,000) against
     theirs in both modes, each timed beside its plain version, its bound and
     (the stem) cuDNN, no kernel below its bound; row 5h, one LSTM layer at
     the batch's shape (T = 800, B = 400, H = 384, flip mode) on
     csrc/lstm_c16.cu, held to its plain version (1e-4) and bit-identical
     across two runs, timed beside the streamed instance, nn.LSTM and its
     bound; their rows join the kernel line, and the CRF kernels join the
     spill check of phase 1 (lstm_infer_kernel_c16 is in it by its name);
 13. print the per-kernel JSON line, then {"ok": true, "device": ...}.
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
# where the run saves the windows that decode differently (``--out``), at most
# SAVED_WINDOWS a step (a random-weight model's bf16 step differs on most of its
# 400 windows, ~30 MB of logits)
OUT_DIR = os.path.join(REPO, "chiron_tpu_torch", "_build", "chip_smoke")
SAVED_WINDOWS = 16
# phase 12, Bonito's HAC CRF model (dna_r9.4.1_e8_hac@v3.3) at its published
# widths, with the seeded weights of the benchmark's Bonito_HAC_r941
# (benchmark/configs/bonito_hac_r941.json: weights.seed and weights.gains),
# called as its cell calls it: -l 4000 -j 3500 -b 400 --sig_norm 0
CRF_CONFIG = {"cnn": {"model": "bonito_stem", "features": 384, "winlen": 19, "stride": 5},
              "rnn": {"layer_num": 5, "hidden_num": 384, "cell_type": "LSTM",
                      "layer_type": "alternating"},
              "decoder": {"type": "crf", "state_len": 5, "scale": 5.0, "blank_score": 2.0}}
CRF_WEIGHTS_SEED, CRF_GAINS = 20261018, {"conv": 3.0, "lstm": 3.0, "head": 2.75}
CRF_SEG, CRF_JUMP = 4000, 3500
# the card's float32 step against the plain reference (reference/bonito_crf.py)
# on the card, on the first CRF_REF_ROWS windows of a batch: the Viterbi scores
# within CRF_SCORE_GAP of the largest (the cell's sound readings are 1.2-2.6e-4,
# one perturbed score column reads 0.2), and at least CRF_MIN_SAME of the
# windows decoding to the same string (random weights flip a decode at a near-tie)
CRF_REF_ROWS, CRF_SCORE_GAP, CRF_MIN_SAME = 16, 1e-3, 0.75
# phase 7, the CNN zoo: every front of the JAX package's zoo that no bundled
# model runs, at its published widths (the JAX package's defaults), a
# dynamic_net with every layer type (a VALID conv, both pools, a conv of 250
# input channels: no multiple of 4) and one of the form tools/grid_search.py
# writes (its 15 / 3 / 3 kernels, 5 / 1 / 1 strides, 256 channels), each with
# DNA_default's RNN, and DNA_default's front with the CNN-only logit head
# (rnn.layer_num 0)
ZOO = {
    "res_x": {"model": "res_x"},
    "rna_model1": {"model": "rna_model1"},
    "rna_model3": {"model": "rna_model3"},
    "rna_test": {"model": "rna_test"},
    "variant_wavnet": {"model": "variant_wavnet"},
    "incp_v2": {"model": "incp_v2"},
    "gate_conv_net": {"model": "gate_conv_net"},
    "gate_conv_net_low": {"model": "gate_conv_net_low"},
    "gate_conv_net_high": {"model": "gate_conv_net_high"},
    "dynamic_net": {"model": "dynamic_net", "tp": ["res", "conv", "p_avg", "conv", "p_max"],
                    "hu": [256, 250, 0, 256, 0], "kw": [5, 1, 3, 3, 2], "st": [2, 1, 1, 1, 2],
                    "pd": ["SAME", "VALID", "SAME", "SAME", "VALID"]},
    "dynamic_net_grid": {"model": "dynamic_net", "tp": ["res"] * 3, "hu": [256] * 3,
                         "kw": [15, 3, 3], "st": [5, 1, 1], "pd": ["SAME"] * 3},
    "custom": {"model": "custom"},
    "cnn_logit": {"model": "dna_model1"},
}
ZOO_TRAIN = ("gate_conv_net", "cnn_logit")
ZOO_TRAIN_STEPS = 30
# phase 10, the model tools: the recipe's corpora cut to RECIPE_READS reads a
# variant (4,000 bases a DNA read, 2,500 an RNA read, as the recipe has them),
# its schedules to these step counts, grid_search's to GRID_STEPS a candidate
RECIPE_READS = 2
RECIPE_DNA_STEPS, RECIPE_FINETUNE_STEPS, RECIPE_RNA_STEPS, GRID_STEPS = 20, 10, 5, 10


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


def conv_bound(terms, w, stride):
    """conv_bn's bound from its inputs, set by the function and not by the
    route a kernel took: where k * C_in > 16 the product fits the tensor
    cores, as three TF32 products (3 x the FLOP over the TF32 peak); a
    narrower input is bounded on the CUDA cores. Bytes: every term (at its
    element size: 2 for the bf16 instance, whose y is bf16 too) and its
    affine read once, w read once, y and the moments written once."""
    bsz, t, cin = terms[0][0].shape
    k, _, cout = w.shape
    el = terms[0][0].element_size()
    rows_out = bsz * (-(-t // stride))
    flops = 2.0 * rows_out * k * cin * cout
    nbytes = (el * len(terms) * bsz * t * cin + 4.0 * (len(terms) * 2 * cin + k * cin * cout)
              + el * rows_out * cout + 4.0 * 2 * cout)
    if k * cin > 16:
        return bound_ms(3 * flops, nbytes, PEAK_TF32) + ("3 x FLOP / 495 TFLOP/s TF32",)
    return bound_ms(flops, nbytes) + ("FLOP / 67 TFLOP/s float32",)


def recurrent_bound(kind, act, t, b, h, dirs=1, xw_bytes=4):
    """A recurrent inference kernel's bound from its inputs: per active (row,
    step) of a direction, LSTM h @ wh + ~12H gate ops, BNLSTM the LSTM's +
    ~40H for its three normalisations (CUDA cores); GRU h @ whg and (r * h) @
    whc, and "lstm_c16" (csrc/lstm_c16.cu, the LSTM route "cluster16") h @ wh,
    as three TF32 products on the tensor cores (3xTF32) beside ~10H / ~12H
    gate ops on the CUDA cores, whichever takes longer; bytes: the input
    projections in, the weights and vectors, lengths (and starts), h out.
    ``act``: active (row, step) pairs of one direction. ``xw_bytes``: the
    LSTM's xw and h element size (2 for its bf16 instance)."""
    cells = t * b
    if kind in ("gru", "lstm_c16"):
        gates, gate_ops = (3, 10) if kind == "gru" else (4, 12)
        nbytes = dirs * 4.0 * (cells * gates * h + h * gates * h + 2 * b + cells * h)
        t_ops = max(dirs * act * 3 * 2 * h * gates * h / PEAK_TF32,
                    dirs * act * gate_ops * h / PEAK_F32)
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


def ctc_bounds(act, t, b, u, c):
    """The CTC kernels' bounds from their inputs: per active (row, frame) and
    slot of S = 2U + 1, the forward's two logaddexps and two adds (~14 ops),
    the backward's beta, posterior and class sum (~20); bytes: logits in, lp
    and the active frames' alpha out (forward); lp and that alpha in, dlogits
    out (backward); the labels and lengths in both."""
    s = 2 * u + 1
    small = b * u + 2 * b
    fwd = bound_ms(14.0 * act * s, 4.0 * (2 * b * t * c + act * s + small + 2 * b))
    bwd = bound_ms(20.0 * act * s, 4.0 * (2 * b * t * c + act * s + small + 2 * b))
    return fwd, bwd


def beam_bound(steps, b, t, w, c=5):
    """The beam search's bound: per active step candidate scoring (~8 ops
    each), the [4W x W] hash merge compare and a top-W selection of ~cand *
    log2(cand) compares (cand = W * C); bytes: lp and lengths in, the trace
    and pb / pnb out."""
    cand = w * c
    return bound_ms(steps * (8 * cand + 4 * w * w + cand * np.log2(cand)),
                    4.0 * (b * t * c + b + b * t * w + 2 * b * w))


def crf_bounds(frames, b, t, s):
    """The CRF kernels' bounds from their inputs, over ``frames`` active (row,
    frame) pairs of S states: per pair and state, the backward scan's
    logsumexp over 5 edges (an add and an exp an edge, a log: 11 ops) and the
    forward scan's alpha logsumexp, posterior and Viterbi step (21); bytes:
    each scan reads the frame's 4 S float32 scores, beta is written by the
    backward scan and read by the forward one, a traceback byte a state is
    written; the traceback reads a byte a frame along the path and writes the
    path (int32 [B, T])."""
    beta = bound_ms(11.0 * frames * s, 4.0 * frames * (4 * s + s) + 4.0 * b)
    viterbi = bound_ms(21.0 * frames * s, 4.0 * frames * (4 * s + s) + frames * s + 16.0 * b)
    traceback = bound_ms(2.0 * frames, frames + 4.0 * b * t + 8.0 * b)
    return {"crf_beta": beta, "crf_viterbi": viterbi, "crf_traceback": traceback}


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


def fused_convs(cnn):
    """conv_bn launches a batch of a CNN front, from its config: the convs
    that layers.fused_conv_ok sends to the kernel (dilation 1, SAME, relu or
    linear, no bias); 4 a residual block."""
    name = cnn["model"]
    if name == "dynamic_net":
        return sum(4 if tp == "res" else int(tp == "conv" and pd == "SAME")
                   for tp, pd in zip(cnn["tp"], cnn["pd"]))
    if name == "res_x":
        return 4 * (int(cnn.get("layer_num", 10)) - 1)
    if name == "variant_wavnet":  # residual blocks, each wavenet's identity and proj
        return 4 * int(cnn.get("res_layer", 1)) + 2 * int(cnn.get("dilate_layer", 7)) * int(
            cnn.get("dilate_repeat", 1))
    # incp_v2: conv1-4 and 8 of each inception's 10 convs (not its two dilated
    # ones); the gate_conv_net family: its residual block and each gated
    # block's identity (the gate and conv carry a bias)
    return {"dna_model1": 12, "rna_model1": 12, "rna_model3": 13, "rna_test": 20,
            "incp_v2": 4 + 9 * 8, "gate_conv_net": 8, "gate_conv_net_low": 8,
            "gate_conv_net_high": 8, "custom": 0}[name]


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


def serve_and_train_sources(torch, work, out_dir, sig_dir, train_dir, gpu_model, first_logits,
                            reset, counts, check_counts, smi):
    """Phase 8: serve DNA_default on the card to concurrent clients, basecall
    through the server, and train from the .bin, TFRecord and cache sources.
    ``first_logits``: phase 3's card logits of the first dna-pre batch.
    Returns the serving numbers."""
    import socket
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chiron_tpu_torch import cli
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.io import binfmt, tfrecord
    from chiron_tpu_torch.io.cache import cached_dataset
    from chiron_tpu_torch.io.labels import read_raw_data_sets
    from chiron_tpu_torch.io.signal import read_signal_for_eval
    from chiron_tpu_torch.models.model import output_len
    from chiron_tpu_torch.ops import lstm_grad
    from chiron_tpu_torch.serve import client as sclient, export, protocol, server as sserver
    from chiron_tpu_torch.train import loop

    dev = torch.device("cuda")
    t_out = output_len(gpu_model.config, SEG)
    # phase 3's reads windowed as `call -p dna-pre --sig_norm 1` windows them: the
    # first 400 are phase 3's first batch
    file_dir, files = pipeline.list_input_files(sig_dir)
    parts = [read_signal_for_eval(os.path.join(file_dir, f), 0, step=JUMP, seg_length=SEG,
                                  normalize=1) for f in files]
    windows = np.concatenate([p[0] for p in parts]).astype(np.float32)
    lengths = np.concatenate([p[1] for p in parts]).astype(np.int32)
    if len(windows) < 2 * BATCH + 20:
        fail(f"phase 3's reads give {len(windows)} windows, expected {2 * BATCH + 20}")

    def reference(x, sl, width, want_logits=False):
        """The port's decode_step on the card with length_bonus 0 on each
        batch as the server forms it (wrap-padded), cut to t_out columns
        and -1 past each length; the model's forward for the logits."""
        out = {"decoded": [], "decoded_length": [], "log_prob": [], "prob_logits": [],
               "logits": []}
        for ofs in range(0, len(x), BATCH):
            bx, bl = x[ofs:ofs + BATCH], sl[ofs:ofs + BATCH]
            take = len(bx)
            bx = np.pad(bx, ((0, BATCH - take), (0, 0)), mode="wrap")
            bl = np.pad(bl, (0, BATCH - take), mode="wrap")
            xd, ld = torch.from_numpy(bx).to(dev), torch.from_numpy(bl).to(dev)
            dec, dlen, score, prob = pipeline.unpack_step_outputs(
                pipeline.decode_step(gpu_model, xd, ld, width, 0.0).cpu().numpy())
            dec = dec[:, :t_out].astype(np.int32)
            dec[np.arange(t_out)[None, :] >= dlen[:, None]] = -1
            for k, v in (("decoded", dec), ("decoded_length", dlen), ("log_prob", score),
                         ("prob_logits", prob)):
                out[k].append(v[:take])
            if want_logits:
                with torch.no_grad():
                    out["logits"].append(gpu_model(xd, ld)[:take].cpu().numpy())
        return {k: np.concatenate(v) for k, v in out.items() if v}

    def same(label, got, want):
        """Every array of a response bit for bit as the reference's; -1 past
        each decoded length."""
        for k, v in want.items():
            g = got.get(k)
            if g is None or g.dtype != v.dtype or g.shape != v.shape \
                    or g.tobytes() != v.tobytes():
                fail(f"serving {label}: {k} differs from decode_step on the card "
                     f"({None if g is None else (g.dtype, g.shape)} vs {(v.dtype, v.shape)})")
        dec, dlen = got["decoded"], got["decoded_length"]
        if not ((dec == -1) == (np.arange(dec.shape[1])[None, :] >= dlen[:, None])).all():
            fail(f"serving {label}: decoded is not -1 exactly past each length")

    class TimedLock:
        """The engine's device lock, recording how long each hold lasts."""

        def __init__(self, lock):
            self.lock, self.held = lock, []

        def __enter__(self):
            self.lock.acquire()
            self.t = time.perf_counter()

        def __exit__(self, *exc):
            self.held.append(time.perf_counter() - self.t)
            self.lock.release()

    def step_counts(steps, width=BEAM, forwards=0):
        n = steps + forwards
        want = {"conv_bn_float32": 12 * n, "bilstm_float32": 3 * n}
        if width:
            want.update(beam_search=steps, beam_traceback=steps)
        return want

    def drive(port, per_client, label):
        """Each client thread sends its list of (x, seq_len, want_logits) in
        turn; returns each thread's (latency s, response) lists and the wall
        from the first send to the last response."""
        results = [[] for _ in per_client]
        errors = []
        gate = threading.Barrier(len(per_client) + 1)

        def run(i):
            try:
                client = sclient.PredictionClient(port=port, timeout=120.0)
                try:
                    gate.wait(60)
                    for x, sl, lg in per_client[i]:
                        t = time.perf_counter()
                        r = client.predict(x, sl, request_id=len(results[i]), want_logits=lg)
                        results[i].append((time.perf_counter() - t, r))
                finally:
                    client.close()
            except BaseException as e:  # reported below, after every join
                errors.append(repr(e))
                gate.abort()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(per_client))]
        for t in threads:
            t.start()
        try:
            gate.wait(60)
        except threading.BrokenBarrierError:
            pass  # a client failed to start: reported below
        t0 = time.perf_counter()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            fail(f"serving {label}: client errors {errors}, "
                 f"{sum(t.is_alive() for t in threads)} clients still waiting")
        return results, wall

    serve_dir = os.path.join(out_dir, "serving")
    bundles = {w: export.export_model(MODEL_DIR, os.path.join(serve_dir, f"beam{w}"), version=1,
                                      segment_len=SEG, beam=w) for w in (BEAM, 0)}
    log(f"exported DNA_default as {bundles}")
    numbers = {}
    t = time.time()
    server = sserver.serve(bundles[BEAM], port=0, batch_size=BATCH, block=False)
    try:
        engine = server.engine
        port = server.server_address[1]
        log(f"serving {bundles[BEAM]} on 127.0.0.1:{port} ({engine.device}, beam {engine.beam}, "
            f"batch {engine.batch_size}); engine built and warmed in {time.time() - t:.2f} s")
        timed = engine._lock = TimedLock(engine._lock)
        # four clients at once: phase 3's first batch (with its logits), two
        # steps, a wrap-padded 137 and a single window
        checks = [("first batch + logits", windows[:BATCH], lengths[:BATCH], True),
                  ("800 windows", windows[:2 * BATCH], lengths[:2 * BATCH], False),
                  ("137 windows", windows[BATCH:BATCH + 137], lengths[BATCH:BATCH + 137], False),
                  ("1 window", windows[-1:], lengths[-1:], False)]
        reset()
        res, _ = drive(port, [[c[1:]] for c in checks], "checks")
        with timed.lock:  # the counters are module globals: read them under the lock
            cnt = counts()
        check_counts("serving, 4 concurrent checks", cnt, step_counts(5, forwards=1))
        for (label, x, sl, lg), [(_, r)] in zip(checks, res):
            same(label, r, reference(x, sl, BEAM, lg))
        if not np.array_equal(res[0][0][1]["logits"], first_logits.cpu().numpy()):
            fail("serving: the first batch's logits are not phase 3's card logits of that batch")
        log(f"  4 concurrent requests (400 + logits, 800, 137, 1 windows): every array bit "
            f"for bit as decode_step on the card (length_bonus 0) on the same wrap-padded "
            f"batch, -1 past each length; the first batch's logits are phase 3's card logits; "
            f"launches {cnt}")

        # latency and rate: 400-window requests, one client then four at once
        payloads = [(windows[:BATCH], lengths[:BATCH]),
                    (windows[BATCH + 20:2 * BATCH + 20], lengths[BATCH + 20:2 * BATCH + 20])]
        want = [reference(x, sl, BEAM) for x, sl in payloads]
        for n_clients, per in ((1, 20), (4, 10)):
            reqs = [[(*payloads[(c + k) % 2], False) for k in range(per)]
                    for c in range(n_clients)]
            reset()
            timed.held.clear()
            res, wall = drive(port, reqs, f"{n_clients} clients")
            with timed.lock:
                cnt = counts()
            check_counts(f"serving, {n_clients} clients", cnt, step_counts(n_clients * per))
            lat = []
            for c, rows in enumerate(res):
                for k, (dt, r) in enumerate(rows):
                    same(f"{n_clients} clients", r, want[(c + k) % 2])
                    lat.append(dt)
            lat = np.array(lat) * 1e3
            numbers[f"clients_{n_clients}"] = {
                "requests": len(lat), "windows_per_request": BATCH,
                "latency_ms_p50": float(np.percentile(lat, 50)),
                "latency_ms_p95": float(np.percentile(lat, 95)),
                "latency_ms_max": float(lat.max()), "wall_s": wall,
                "windows_per_s": len(lat) * BATCH / wall,
                "lock_held_ms_mean": 1e3 * float(np.mean(timed.held)),
                "lock_held_s_total": float(np.sum(timed.held))}
            log(f"  serving {n_clients} client(s) x {per} requests of {BATCH} windows: "
                + json.dumps(numbers[f"clients_{n_clients}"]) + f"; launches {cnt}")
        # the card's idle share over a second 4-client run, profiled
        reqs = [[(*payloads[(c + k) % 2], False) for k in range(10)] for c in range(4)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_p = drive(port, reqs, "profiled 4 clients")
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e6
        numbers["clients_4_profiled"] = {
            "wall_s": wall_p, "device_busy_s": busy,
            "idle_share": 1 - busy / wall_p if busy > 0 else "not measured (no device events)"}
        log("  profiled 4 clients x 10: " + json.dumps(numbers["clients_4_profiled"]))

        # the protocol's host time for one 400-window request and its response
        req = {"x": windows[:BATCH], "seq_len": lengths[:BATCH], "request_id": np.asarray(0)}
        host = {}
        for name, msg in (("request", req), ("response", want[0])):
            reps = 20
            t = time.perf_counter()
            for _ in range(reps):
                data = protocol.pack(msg)
            host[f"pack_{name}_ms"] = 1e3 * (time.perf_counter() - t) / reps
            a, b = socket.socketpair()
            try:
                sender = threading.Thread(target=a.sendall, args=(data * reps,), daemon=True)
                sender.start()
                t = time.perf_counter()
                for _ in range(reps):
                    protocol.read_message(b)
                host[f"read_{name}_ms"] = 1e3 * (time.perf_counter() - t) / reps
                sender.join(60)
            finally:
                a.close()
                b.close()
            host[f"{name}_bytes"] = len(data)
        numbers["protocol_host"] = host
        log("  protocol host time per 400-window request: " + json.dumps(host))

        # run_call through the server on three reads, each against a one-read `call`
        three = os.path.join(work, "serve_reads")
        os.makedirs(three)
        for f in files[:3]:
            shutil.copy(os.path.join(file_dir, f), three)
        flags = type("F", (), dict(
            input=three, output=os.path.join(work, "serve_call"), host="127.0.0.1", port=port,
            batch_size=BATCH, segment_len=SEG, jump=JUMP, start=0, extension="fastq",
            mode="dna", reverse_fast5=False, concise=False, model="remote", sig_norm=1))()
        reset()
        summary = sclient.run_call(flags)
        with timed.lock:
            cnt = counts()
        check_counts("serving run_call", cnt, step_counts(3))
        for f in files[:3]:
            one = os.path.join(work, f"one_{f}")
            os.makedirs(os.path.join(one, "in"))
            shutil.copy(os.path.join(file_dir, f), os.path.join(one, "in"))
            cli.main(["call", "-i", os.path.join(one, "in"), "-o", os.path.join(one, "out"),
                      "-p", "dna-pre", "--sig_norm", "1", "-b", str(BATCH), "--beam", str(BEAM),
                      "--length_bonus", "0", "--device", "cuda"])
            name = os.path.splitext(f)[0] + ".fastq"
            with open(os.path.join(flags.output, "result", name)) as a, \
                    open(os.path.join(one, "out", "result", name)) as b:
                served, called = a.read(), b.read()
            if not served or served != called:
                fail(f"run_call through the server wrote another {name} than a one-read call")
        log(f"  run_call through the server on 3 reads ({summary}): each fastq byte for byte "
            f"the one-read `call -b {BATCH} --beam {BEAM} --length_bonus 0`'s; launches {cnt}")
    finally:
        server.shutdown()
        server.server_close()

    # the beam-0 bundle (the export's default) for two requests
    server = sserver.serve(bundles[0], port=0, batch_size=BATCH, block=False)
    try:
        reqs = [(windows[:BATCH], lengths[:BATCH], False),
                (windows[BATCH:BATCH + 137], lengths[BATCH:BATCH + 137], False)]
        reset()
        res, _ = drive(server.server_address[1], [reqs], "beam 0")
        with server.engine._lock:
            cnt = counts()
        check_counts("serving beam 0", cnt, step_counts(2, width=0))
        for (x, sl, _), (_, r) in zip(reqs, res[0]):
            same("beam 0", r, reference(x, sl, 0))
        log(f"  beam-0 bundle: 2 requests (400, 137 windows) bit for bit as decode_step at "
            f"beam 0; launches {cnt}")
    finally:
        server.shutdown()
        server.server_close()

    # train from each further source on the card: phase 4's reads as a .bin
    # folder, as a TFRecord (signals rounded to int16, what the format holds),
    # and through the window cache
    arrays = read_raw_data_sets(train_dir, seq_length=SEG)
    bin_dir = os.path.join(work, "train_bin")
    os.makedirs(bin_dir)
    per_file = 200
    for k, ofs in enumerate(range(0, len(arrays[0]), per_file)):
        sl = slice(ofs, ofs + per_file)
        binfmt.write_bin(os.path.join(bin_dir, f"data_batch_{k}.bin"), arrays[0][sl],
                         arrays[1][sl], [r[:n] for r, n in zip(arrays[2][sl], arrays[3][sl])],
                         arrays[3][sl])
    binfmt.write_meta(bin_dir, SEG, per_file, "median", "RawGenomeCorrected_000",
                      "BaseCalled_template", "dna")
    ev, evl, lb, lbl = binfmt.read_bin_folder(bin_dir)
    u = arrays[2].shape[1]
    if not (np.array_equal(ev, arrays[0]) and np.array_equal(evl, arrays[1])
            and np.array_equal(lbl, arrays[3]) and np.array_equal(lb[:, :u], arrays[2])
            and (lb[:, u:] == -1).all()):
        fail(".bin folder: the records are not the in-RAM .signal/.label windows")
    tf_sig = os.path.join(work, "train_int16")
    os.makedirs(tf_sig)
    reads = []
    for name in sorted(os.listdir(train_dir)):
        if name.endswith(".signal"):
            pre = os.path.join(train_dir, name[:-len(".signal")])
            sig = np.round(np.loadtxt(pre + ".signal")).astype(np.int16)
            with open(pre + ".label") as f:
                rows = [(int(s), int(e), b) for s, e, b in (line.split() for line in f)]
            reads.append((name, sig, rows))
            np.savetxt(os.path.join(tf_sig, name), sig, fmt="%d")
            shutil.copy(pre + ".label", tf_sig)
    tf_path = os.path.join(work, "train.tfrecords")
    tfrecord.write_training_tfrecord(tf_path, reads)
    t_ev, t_evl, t_lb, t_lbl = tfrecord.read_tfrecord_data_sets(tf_path, seq_length=SEG)
    s_ev, s_evl, s_lb, s_lbl = read_raw_data_sets(tf_sig, seq_length=SEG)
    if not (t_ev.shape == s_ev.shape and np.array_equal(t_evl, s_evl)
            and np.array_equal(t_lb, s_lb) and np.array_equal(t_lbl, s_lbl)
            and np.allclose(t_ev, s_ev, rtol=1e-6, atol=0)):
        fail("TFRecord: its windows are not the in-RAM .signal/.label windows")
    cache_dir = os.path.join(work, "train_cache")
    disk = cached_dataset(train_dir, cache_dir, SEG, seed=7)
    ram = loop.Dataset(*arrays, seed=7)
    for _ in range(2 * -(-ram.n // TRAIN_BATCH) + 1):  # across two epoch boundaries
        a, b = disk.next_batch(TRAIN_BATCH), ram.next_batch(TRAIN_BATCH)
        if not all(np.array_equal(a[k], b[k]) for k in a):
            fail("window cache: a batch differs from the in-RAM Dataset's")
    disk.close()
    log(f"  sources: .bin folder ({len(ev)} windows in {k + 1} files), TFRecord "
        f"({len(t_ev)} windows of {len(reads)} int16 reads), cache ({ram.n} windows): each "
        f"equal to the in-RAM .signal/.label arrays")
    sources = {"bin": (bin_dir, []), "tfrecord": (work, ["-f", os.path.basename(tf_path)]),
               "cache": (train_dir, ["--train_cache", cache_dir])}
    train_runs = {}
    for name, (data, extra) in sources.items():
        for k in lstm_grad.launches:
            lstm_grad.launches[k] = 0
        t = time.time()
        result = cli.main(["train", "-i", data, "-o", os.path.join(work, "log_sources"),
                           "-m", name, "--configure", os.path.join(MODEL_DIR, "model.json"),
                           "-s", str(SEG), "-b", str(TRAIN_BATCH), "-x", "10",
                           "-t", str(TRAIN_RATE), "--device", "cuda", *extra])
        torch.cuda.synchronize()
        wall = time.time() - t
        launches_t = dict(lstm_grad.launches)
        if any(n != 6 * 10 for n in launches_t.values()) or not result["losses"] \
                or not np.all(np.isfinite(result["losses"])):
            fail(f"train from {name}: launches {launches_t} (expected 60 each), losses "
                 f"{result['losses']}")
        train_runs[name] = {"seconds": wall, "losses": result["losses"], "launches": launches_t}
        log(f"  train -s {SEG} -b {TRAIN_BATCH} -x 10 from {name}: {wall:.2f} s, losses "
            f"{result['losses']}, launches {launches_t}")
    numbers["train_sources"] = train_runs
    numbers["card"] = smi
    return numbers


def param_leaves(tree):
    """The array leaves of a nested params tree (dicts and lists), in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in param_leaves(v)]
    return [tree] if isinstance(tree, np.ndarray) else []


def multi_gpu(torch, work, gpu_model, tree, config, batch, lb, phase3_step, train_dir,
              reset, counts, check_counts, smi):
    """Phase 9: the data-parallel paths (chiron_tpu_torch/parallel) on the one
    card. ``batch``: phase 3's first dna-pre batch on the card (x, seq_len);
    ``phase3_step``: phase 3's unpacked card step of that batch at beam 30.
    Returns the numbers."""
    import functools

    from chiron_tpu_torch import cli
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.parallel import dryrun
    from chiron_tpu_torch.parallel.dist import free_port, make_sharded_decode_step, run_ranks
    from chiron_tpu_torch.parallel.mesh import initialize_distributed
    from chiron_tpu_torch.train import loop

    dev = torch.device("cuda", 0)
    xg, slg = batch
    numbers = {"card": smi}
    # 9a: the sharded decode over [cuda:0] * 4 equals four decode_steps on rows
    # 0-99, 100-199, ... bit for bit (each shard normalised by its own moments),
    # and over [cuda:0] phase 3's step
    shards = 4
    rows = BATCH // shards
    for width in (BEAM, 0):
        step = functools.partial(pipeline.decode_step, beam=width, length_bonus=lb)
        sharded = make_sharded_decode_step(step, [dev] * shards)
        single = make_sharded_decode_step(step, [dev])
        reset()
        got = sharded(gpu_model, xg, slg)
        torch.cuda.synchronize()
        launches = counts()
        want = {"conv_bn_float32": 12 * shards, "bilstm_float32": 3 * shards}
        if width:
            want.update(beam_search=shards, beam_traceback=shards)
        check_counts(f"9a sharded decode, beam {width}", launches, want)
        parts = torch.cat([step(gpu_model, xg[i * rows:(i + 1) * rows],
                                slg[i * rows:(i + 1) * rows]) for i in range(shards)])
        one = single(gpu_model, xg, slg)
        torch.cuda.synchronize()
        if not torch.equal(got, parts):
            fail(f"9a: the {shards}-shard decode at beam {width} is not {shards} decode_steps "
                 "on contiguous rows")
        if not torch.equal(one, step(gpu_model, xg, slg)):
            fail(f"9a: the 1-shard decode at beam {width} is not the decode_step")
        # nothing in the sharded step waits on the host: each shard is enqueued
        # while the ones before it run (on k cards they run together)
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = sharded(gpu_model, xg, slg)
        except RuntimeError as e:
            fail(f"9a: the {shards}-shard decode at beam {width} syncs with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not torch.equal(again, got):
            fail(f"9a: the {shards}-shard decode at beam {width} is not repeatable")
        if width:
            unpacked = pipeline.unpack_step_outputs(one.cpu().numpy())
            if not all(np.array_equal(a, b) for a, b in zip(unpacked, phase3_step)):
                fail("9a: the 1-shard decode at beam 30 is not phase 3's card step")
        same = int(sum(np.array_equal(a, b) for a, b in zip(
            pipeline.unpack_step_outputs(got.cpu().numpy())[0],
            pipeline.unpack_step_outputs(one.cpu().numpy())[0])))
        ms = {"shards_4": time_ms(torch, lambda: sharded(gpu_model, xg, slg), 5),
              "shards_1": time_ms(torch, lambda: single(gpu_model, xg, slg), 5)}
        numbers[f"sharded_decode_beam{width}"] = {"launches": launches, "device_ms": ms,
                                                  "decodes_as_1_shard": same, "windows": BATCH}
        log(f"  9a beam {width}: 4 shards == 4 decode_steps on rows of {rows} bit for bit, "
            f"no host sync inside; 1 shard == {'phase 3 step' if width else 'decode_step'}; launches {launches}; "
            f"device ms 4 shards {ms['shards_4']:.3f} vs 1 shard {ms['shards_1']:.3f} ({smi}); "
            f"{same}/{BATCH} windows decode as with 1 shard (per-shard BN moments)")

    # 9b: two ranks sharing cuda:0 through gloo (NCCL refuses two ranks on one
    # GPU), -s 400 -b 300 (150 rows a rank), DNA_default's config and bundled
    # weights, against the one-process global-batch step on the card
    dataset = loop.load_dataset(train_dir, SEG)
    # two steps: the first is held, the second (warm) timed
    batches = [dataset.next_batch(TRAIN_BATCH) for _ in range(2)]
    job = (config, tree, batches, "Adam", TRAIN_RATE, float(config["fl_gamma"]))
    alone = dryrun.data_parallel_steps(0, 1, dev, *job)
    t = time.time()
    ranks = run_ranks(dryrun.data_parallel_steps, [dev, dev], args=job, backend="gloo",
                      timeout=300)
    ranks_wall = time.time() - t
    loss_err = abs(ranks[0]["losses"][0] - alone["losses"][0]) / abs(alone["losses"][0])
    grads_1, grads_2 = alone["grads"], ranks[0]["grads"]
    top = max(float(np.abs(g).max()) for g in grads_1.values())
    ratio = max(float(np.abs(grads_2[k] - g).max()) / (1e-2 * float(np.abs(g).max()) + 1e-4 * top)
                for k, g in grads_1.items())
    same_ranks = ranks[0]["losses"] == ranks[1]["losses"] and all(
        np.array_equal(ranks[0]["grads"][k], ranks[1]["grads"][k]) for k in grads_1)
    want_launches = {"lstm_fwd_residuals": 12, "lstm_bwd": 12}
    log(f"  9b two gloo ranks on cuda:0, {TRAIN_BATCH // 2} rows each: loss "
        f"{ranks[0]['losses'][0]:.6f} vs one process {alone['losses'][0]:.6f} (relative "
        f"{loss_err:.2e}, must be <= 1e-5; second step {ranks[0]['losses'][1]:.6f} vs "
        f"{alone['losses'][1]:.6f}); gradients worst leaf err / (1e-2 own max + 1e-4 top) "
        f"{ratio:.3f} (must be <= 1); ranks equal {same_ranks}; launches "
        f"{[r['launches'] for r in ranks]} (6 + 6 a step); step seconds (cold, warm) "
        f"{[r['seconds'] for r in ranks]} vs one process {alone['seconds']}; "
        f"{ranks_wall:.1f} s with start-up ({smi})")
    if loss_err > 1e-5 or ratio > 1.0 or not same_ranks or any(
            r["launches"] != want_launches for r in ranks):
        fail("9b: the two-rank step is not the one-process global-batch step")
    numbers["gloo_two_ranks"] = {"loss": ranks[0]["losses"][0], "loss_alone": alone["losses"][0],
                                 "loss_rel_err": loss_err, "grad_gate_ratio": ratio,
                                 "launches": [r["launches"] for r in ranks],
                                 "warm_step_seconds": [r["seconds"][1] for r in ranks],
                                 "warm_step_seconds_alone": alone["seconds"][1],
                                 "wall_with_start_up": ranks_wall}

    # 9c: one step in an NCCL group of one rank through initialize_distributed:
    # every collective runs and must change no bit
    import torch.distributed as dist

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            fail(f"9c: backend {dist.get_backend()}, expected nccl")
        grouped = dryrun.data_parallel_steps(0, 1, dev, *job)
    finally:
        dist.destroy_process_group()
    bitwise = grouped["losses"] == alone["losses"] and all(
        np.array_equal(grouped["grads"][k], g) for k, g in grads_1.items()) and all(
        np.array_equal(a, b) for a, b in zip(
            param_leaves(grouped["params"]), param_leaves(alone["params"])))
    log(f"  9c NCCL group of one rank: losses {grouped['losses']}, gradients, losses and "
        f"params after two steps equal to the steps without a group bit for bit: {bitwise}; "
        f"launches {grouped['launches']}")
    if not bitwise or grouped["launches"] != want_launches:
        fail("9c: the step in an NCCL group of one differs from the step without a group")
    numbers["nccl_one_rank"] = {"bitwise": bitwise, "warm_step_seconds": grouped["seconds"][1]}

    # 9d: more GPUs than the machine has
    try:
        cli.main(["call", "-i", os.path.join(work, "signal"), "-o", os.path.join(work, "out_9d"),
                  "-p", "dna-pre", "--n_devices", str(torch.cuda.device_count() + 1),
                  "--device", "cuda"])
    except RuntimeError as e:
        if f"torch.cuda.device_count() is {torch.cuda.device_count()}" not in str(e):
            fail(f"9d: the error does not name the device count: {e}")
        log(f"  9d call --n_devices {torch.cuda.device_count() + 1} raises: {e}")
    else:
        fail("9d: call --n_devices past the visible GPUs did not raise")
    return numbers


def model_tools(torch, work, out_dir, sig_dir, train_dir, dna, rna, reset, counts,
                check_counts, smi, bench_line, row2_ms, device="cuda"):
    """Phase 10: the model tools (chiron_tpu_torch/tools/{net2wide,
    make_bundled_models,grid_search,mfu}.py) on the card. ``dna`` / ``rna``:
    (model, the float32 (x, seq_len) of phase 3's first dna-pre / rna-pre
    batch on the card, length bonus); ``sig_dir`` / ``train_dir``: phase 3's
    and phase 4's reads; ``bench_line``: phase 6's bench line; ``row2_ms``:
    phase 5's time of the BiLSTM kernel at H = 128. Returns the numbers and
    the launches of the tools' runs by kernel-line name."""
    import contextlib
    import io

    from chiron_tpu_torch import cli
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.models.model import init_model, model_ratio
    from chiron_tpu_torch.ops import bilstm, lstm_grad
    from chiron_tpu_torch.ops.ctc_loss import ctc_focal_loss
    from chiron_tpu_torch.params import from_jax_params
    from chiron_tpu_torch.tools import grid_search, mfu, net2wide
    from chiron_tpu_torch.tools import make_bundled_models as mbm
    from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_corpus
    from chiron_tpu_torch.train import loop
    from chiron_tpu_torch.train.checkpoint import restore_latest

    numbers, launches = {"card": smi}, {}
    kernel_names = {"conv_bn_float32": "conv_bn", "bilstm_float32": "bilstm",
                    "beam_search": "beam_search", "beam_traceback": "beam_traceback",
                    "lstm_fwd_residuals": "lstm_fwd_residuals", "lstm_bwd": "lstm_bwd"}

    def counted(label, fn, want):
        """fn() with every count set to 0 just before and read just after;
        each count must be the expected one (0 where none is named). The
        counts are added to the kernel line's."""
        reset()
        for k in lstm_grad.launches:
            lstm_grad.launches[k] = 0
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t
        cnt = counts()
        check_counts(label, cnt, {k: n for k, n in want.items() if k not in lstm_grad.launches})
        got_t = dict(lstm_grad.launches)
        want_t = {k: want.get(k, 0) for k in got_t}
        if got_t != want_t:
            fail(f"{label}: training LSTM launches {got_t}, expected {want_t}")
        for k, n in {**cnt, **got_t}.items():
            if n:
                launches[kernel_names[k]] = launches.get(kernel_names[k], 0) + n
        log(f"  {label}: {wall:.2f} s; launches {dict((k, n) for k, n in {**cnt, **got_t}.items() if n)}")
        return out, wall

    def decodes_alike(a, b):
        return sum(bool(a[1][i] == b[1][i] and (a[0][i, :a[1][i]] == b[0][i, :b[1][i]]).all())
                   for i in range(len(a[1])))

    def step_out(model, x, sl, lb):
        return pipeline.unpack_step_outputs(
            pipeline.decode_step(model, x, sl, BEAM, lb).cpu().numpy())

    # ---- 10a. net2wide: RNA_default 100 -> 128 and DNA_default 128 -> 256 -------
    for name, (model, (x, sl), lb), h_new, n_conv in (("RNA_default", rna, 128, 13),
                                                      ("DNA_default", dna, 256, 12)):
        src = os.path.join(cli.MODEL_ROOT, name)
        wdir = os.path.join(work, f"wide_{name}")
        net2wide.widen_model_dir(src, wdir, h_new, noise=0.0)
        wcfg = C.read_config(os.path.join(wdir, "model.json"))
        wide = from_jax_params(restore_latest(wdir)[0], wcfg, device)
        with torch.no_grad():
            ref = model(x, sl)
            ref_step = step_out(model, x, sl, lb)
            wide_step, _ = counted(f"10a widened {name} decode_step (H = {h_new})",
                                   lambda: step_out(wide, x, sl, lb),
                                   {"conv_bn_float32": n_conv, "bilstm_float32": 3,
                                    "beam_search": 1, "beam_traceback": 1})
            gap = float((wide(x, sl) - ref).abs().max()) / float(ref.abs().max())
            noisy_tree = net2wide.widen_params(restore_latest(src)[0],
                                               int(model.config["rnn"]["hidden_num"]), h_new)
            noisy = from_jax_params(noisy_tree, wcfg, device)
            noisy_gap = float((noisy(x, sl) - ref).abs().max()) / float(ref.abs().max())
        same = decodes_alike(wide_step, ref_step)
        bsz = x.shape[0]
        log(f"  10a {name} widened to H = {h_new} (noise 0): logits {gap:.3e} of max |logit| "
            f"from the original's on the card (must be <= 1e-4), {same}/{bsz} decodes "
            f"identical (must be >= 99%); at the default noise 1e-2 the gap is "
            f"{noisy_gap:.3e} of max |logit|")
        if not (gap <= 1e-4 and same >= 0.99 * bsz):
            fail(f"10a: the widened {name} does not compute the original's function")
        numbers[f"net2wide_{name}"] = {"hidden": h_new, "logit_gap": gap,
                                       "identical_decodes": same, "windows": bsz,
                                       "logit_gap_noise_1e-2": noisy_gap}
    # the resident BiLSTM instance at H = 256 and a full dna-pre batch (the
    # widened DNA_default's layers), beside row 2 at H = 128
    t_len, h = SEG, 256
    gen = torch.Generator().manual_seed(SEED)
    ws = (6 / (5 * h)) ** 0.5 / 2
    full = torch.full((BATCH,), t_len, dtype=torch.int32, device=device)
    args256 = (torch.randn(t_len, BATCH, 4 * h, generator=gen).to(device),
               torch.randn(t_len, BATCH, 4 * h, generator=gen).to(device),
               (torch.randn(h, 4 * h, generator=gen) * ws).to(device),
               (torch.randn(h, 4 * h, generator=gen) * ws).to(device), full,
               torch.zeros(BATCH, dtype=torch.int32, device=device))
    lstm_lib = torch.nn.LSTM(256, h, bidirectional=True).to(device)
    x_lib = torch.randn(t_len, BATCH, 256, generator=gen).to(device)
    with torch.no_grad():
        ms256 = time_ms(torch, lambda: bilstm.bilstm_layer(*args256), 5)
        plain256 = time_ms(torch, lambda: bilstm.bilstm_layer_plain(*args256), 2, 1)
        lib256 = time_ms(torch, lambda: lstm_lib(x_lib), 5)
    b256, by256 = recurrent_bound("lstm", t_len * BATCH, t_len, BATCH, h, dirs=2)
    cl, rows, smem = lstm_grad.cluster_geometry(
        "infer", BATCH, h, 2, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"  10a bilstm at H = 256, T = B = {BATCH} (cluster {cl}, rows {rows}, shared bytes "
        f"{smem}): {ms256:.3f} ms (bound {b256:.3f} by {by256}, plain {plain256:.3f}, "
        f"nn.LSTM bidirectional {lib256:.3f}); row 2 at H = 128: {row2_ms:.3f} ms")
    if ms256 < b256:
        fail(f"10a: bilstm at H = 256 reads {ms256:.4f} ms, below its bound {b256:.4f} ms")
    numbers["bilstm_h256_ms"] = {"ms": ms256, "plain_ms": plain256, "library_ms": lib256,
                                 "bound_ms": b256, "bound_by": by256, "row2_h128_ms": row2_ms,
                                 "cluster": cl, "rows": rows}

    # ---- 10b. the recipe: corpus, _train dna at 400 x 400, finetune, install -----
    rwork = os.path.join(out_dir, "model_tools")
    shutil.rmtree(rwork, ignore_errors=True)
    os.makedirs(rwork)
    # the bundled table seeds the work directory: the recipe's rule that an
    # existing dna_pore_model.tsv skips the EM estimate
    shutil.copy2(os.path.join(cli.MODEL_ROOT, "DNA_default", "pore_model.tsv"),
                 os.path.join(rwork, "dna_pore_model.tsv"))
    t = time.time()
    dna_km = KmerModel.load(os.path.join(rwork, "dna_pore_model.tsv"))
    for i, (kw, seed) in enumerate(zip(mbm.DNA_VARIANTS, mbm.DNA_SEEDS)):
        kw = {k: v for k, v in kw.items() if k != "n_reads"}
        simulate_corpus(os.path.join(rwork, "train_dna", f"v{i}"), RECIPE_READS, 4000,
                        seed=seed, model=dna_km, cfg=SimConfig(**kw))
    simulate_corpus(os.path.join(rwork, "valid_dna"), RECIPE_READS, 4000,
                    seed=mbm.DNA_VALID_SEED, model=dna_km, cfg=SimConfig())
    log(f"  10b DNA corpus: {len(mbm.DNA_VARIANTS)} variants x {RECIPE_READS} reads of 4,000 "
        f"bases, {RECIPE_READS} validation reads, in {time.time() - t:.1f} s")

    def train_counts(steps, validations, n_conv=12):
        return {"lstm_fwd_residuals": 6 * steps, "lstm_bwd": 6 * steps,
                "conv_bn_float32": n_conv * validations, "bilstm_float32": 3 * validations}

    def rate(result, batch):
        """s/step and windows/s over the run's last metrics interval. The
        trainer writes the interval's seconds / save_every (10: the recipe
        sets none), also for a shorter interval."""
        with open(os.path.join(result["model_dir"], "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = rows[-1]["step"] - (rows[-2]["step"] if len(rows) > 1 else 0)
        sps = rows[-1]["seconds_per_step"] * 10 / steps
        return {"losses": result["losses"], "seconds_per_step": sps,
                "windows_per_s": batch / sps, "interval_steps": steps}

    recipe = {}
    result, wall = counted(f"10b _train dna ({RECIPE_DNA_STEPS} steps, 400 x 400)",
                           lambda: mbm._train(rwork, "dna", RECIPE_DNA_STEPS, device=device),
                           train_counts(RECIPE_DNA_STEPS, -(-RECIPE_DNA_STEPS // 10)))
    recipe["train_dna"] = {**rate(result, 400), "wall_seconds": wall}
    if not np.all(np.isfinite(result["losses"])):
        fail(f"10b: _train dna losses {result['losses']}")
    # the first step's loss on CPU_STEP_BATCH windows, card vs CPU (its weights:
    # the trainer's seed-0 init; the windows: a batch of the run's cache)
    dcfg = C.read_config(os.path.join(result["model_dir"], "model.json"))
    init_tree = init_model(torch.Generator().manual_seed(0), dcfg)
    data = loop.load_dataset(os.path.join(rwork, "train_dna"), SEG, sig_norm=1,
                             cache_dir=os.path.join(rwork, "cache_train_dna"))
    first = data.next_batch(CPU_STEP_BATCH, shuffle=False)
    if hasattr(data, "close"):
        data.close()

    def first_loss(dev):
        m = from_jax_params(init_tree, dcfg, dev)
        b = loop.batch_to_device(first, model_ratio(dcfg, SEG), torch.device(dev))
        with torch.no_grad():
            return float(ctc_focal_loss(m(b["signal"], b["seq_len"], training=True),
                                        b["seq_len"], b["label"], b["label_len"],
                                        float(dcfg["fl_gamma"])))

    loss_g, loss_c = first_loss(device), first_loss("cpu")
    rel = abs(loss_g - loss_c) / abs(loss_c)
    log(f"  10b first step's loss on {CPU_STEP_BATCH} windows: card {loss_g:.6f}, CPU "
        f"{loss_c:.6f}, relative {rel:.3e} (must be <= 1e-4)")
    if not rel <= 1e-4:
        fail("10b: the recipe's first-step loss on the card disagrees with the CPU")
    recipe["first_step_loss"] = {"card": loss_g, "cpu": loss_c, "relative": rel}
    # the scratch run's directory is the one stage_finetune seeds: keep it apart
    os.replace(os.path.join(rwork, "models", "DNA_retrain"),
               os.path.join(rwork, "models", "DNA_scratch"))
    result, wall = counted(f"10b stage_finetune dna ({RECIPE_FINETUNE_STEPS} steps)",
                           lambda: mbm.stage_finetune(rwork, "dna", RECIPE_FINETUNE_STEPS,
                                                      device=device),
                           train_counts(RECIPE_FINETUNE_STEPS, -(-RECIPE_FINETUNE_STEPS // 10)))
    recipe["finetune_dna"] = {**rate(result, 400), "wall_seconds": wall}
    # RNA: the synthetic k-mer model at the recipe's base settings and each variant
    t = time.time()
    rna_km = KmerModel.synthetic()
    for i, (kw, seed) in enumerate(zip(mbm.RNA_VARIANTS, mbm.RNA_SEEDS)):
        simulate_corpus(os.path.join(rwork, "train_rna", f"v{i}"), RECIPE_READS, 2500,
                        seed=seed, model=rna_km, cfg=SimConfig(**{**mbm._RNA_BASE, **kw}))
    simulate_corpus(os.path.join(rwork, "valid_rna"), RECIPE_READS, 2500,
                    seed=mbm.RNA_VALID_SEED, model=rna_km, cfg=SimConfig(**mbm._RNA_BASE))
    log(f"  10b RNA corpus: {len(mbm.RNA_VARIANTS)} variants x {RECIPE_READS} reads of 2,500 "
        f"bases in {time.time() - t:.1f} s")
    result, wall = counted(f"10b _train rna ({RECIPE_RNA_STEPS} steps, 2000 x 100, H = 100)",
                           lambda: mbm._train(rwork, "rna", RECIPE_RNA_STEPS, device=device),
                           train_counts(RECIPE_RNA_STEPS, 1, n_conv=13))
    recipe["train_rna"] = {**rate(result, 100), "wall_seconds": wall}
    if not np.all(np.isfinite(result["losses"])):
        fail(f"10b: _train rna losses {result['losses']}")
    installed = os.path.join(rwork, "installed")
    for name in ("DNA_default", "RNA_default"):
        os.makedirs(os.path.join(installed, name))
    mbm.stage_install(rwork, model_root=installed)
    inst = os.path.join(installed, "DNA_default")
    if sorted(os.listdir(inst)) != ["checkpoint", f"ema-{RECIPE_FINETUNE_STEPS}.npz",
                                    f"final-{RECIPE_FINETUNE_STEPS}.npz", "model.json",
                                    "pore_model.tsv"]:
        fail(f"10b: stage_install wrote {sorted(os.listdir(inst))}")
    n_reads = len(os.listdir(sig_dir))
    n_windows = n_reads * (-(-(40 * JUMP + 10) // JUMP))
    n_batches = -(-n_windows // BATCH)
    res, _ = counted("10b call -p dna-pre --beam 30 with the installed DNA_default",
                     lambda: cli.main(["call", "-i", sig_dir, "-o", os.path.join(work, "out_10b"),
                                       "-p", "dna-pre", "-m", inst, "--sig_norm", "1",
                                       "--beam", str(BEAM), "--device", device]),
                     {"conv_bn_float32": 12 * n_batches, "bilstm_float32": 3 * n_batches,
                      "beam_search": n_batches, "beam_traceback": n_batches})
    if res["n_files"] != n_reads or res["total_windows"] != n_windows \
            or len(os.listdir(os.path.join(work, "out_10b", "result"))) != n_reads:
        fail(f"10b: the installed model's call gave {res}")
    # _read_logits of one read, card vs CPU: gated with the bundled DNA_default
    # (stage_realdata's align model; fixed weights, so a fixed gap on a given
    # card), printed with the installed model, whose weights the card's
    # training steps made in this run
    read = np.loadtxt(os.path.join(sig_dir, sorted(os.listdir(sig_dir))[0]), dtype=np.float32)
    lp_errs = {}
    for tag, mdir in (("bundled DNA_default", os.path.join(cli.MODEL_ROOT, "DNA_default")),
                      ("installed DNA_default", inst)):
        mcfg, mtree = C.read_config(os.path.join(mdir, "model.json")), restore_latest(mdir)[0]
        lp_g = mbm._read_logits(mtree, mcfg, read, device=device)
        lp_c = mbm._read_logits(mtree, mcfg, read, device="cpu")
        if lp_g.shape != (len(read), 5):
            fail(f"10b: _read_logits gave {lp_g.shape} for a {len(read)}-sample read")
        lp_errs[tag] = float(np.abs(lp_g - lp_c).max()) / float(np.abs(lp_c).max())
    log(f"  10b _read_logits of a {len(read)}-sample read, card vs CPU, relative to max "
        f"|log-prob|: {json.dumps(lp_errs)} (the bundled model's must be <= 1e-4)")
    if not lp_errs["bundled DNA_default"] <= 1e-4:
        fail("10b: _read_logits on the card disagrees with the CPU")
    recipe["read_logits_error"] = lp_errs
    for k in ("train_dna", "finetune_dna", "train_rna"):
        log(f"  10b {k}: {json.dumps(recipe[k])}")
    numbers["recipe"] = recipe

    # ---- 10c. grid_search over DEFAULT_GRID on phase 4's reads -----------------
    gdir = os.path.join(rwork, "grid")
    n_cand = len(grid_search.generate_configs())
    results, wall = counted(f"10c grid_search ({n_cand} candidates x {GRID_STEPS} steps, "
                            "64 x 300)",
                            lambda: grid_search.search(train_dir, gdir, max_steps=GRID_STEPS,
                                                       device=device),
                            train_counts(n_cand * GRID_STEPS, 0))
    bad = [r for r in results if "error" in r or not np.isfinite(r["final_loss"])]
    if bad or len(results) != n_cand or not os.path.exists(os.path.join(gdir, "ranking.json")):
        fail(f"10c: grid_search candidates failed: {bad}")
    grid = {}
    for r in sorted(results, key=lambda r: r["index"]):
        with open(os.path.join(gdir, "runs", f"cand_{r['index']:03d}", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(r["config"]) as f:
            cfg = json.load(f)
        grid[f"cand_{r['index']:03d}"] = {
            "hu": cfg["cnn"]["hu"][0], "kw": cfg["cnn"]["kw"], "st": cfg["cnn"]["st"],
            "rnn_hidden": cfg["rnn"]["hidden_num"], "final_loss": r["final_loss"],
            "seconds_per_step": rows[-1]["seconds_per_step"]}
    log(f"  10c s/step a candidate (the last {GRID_STEPS // 2} steps): " + json.dumps(
        {k: round(v["seconds_per_step"], 4) for k, v in grid.items()}))
    numbers["grid_search"] = {"seconds": wall, "candidates": grid}

    # ---- 10d. mfu: the analytic count and the share of the bf16 peak -----------
    # the tool's entry point at phase 6's device rates, beside each count's terms
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        mfu.main(["--samples_per_s_fast", str(bench_line["device_samples_per_second_batch2000"]),
                  "--samples_per_s_slow",
                  str(bench_line["device_samples_per_second_slow_batch400"]), "--device", device])
    counts_mfu = {}
    for line in printed.getvalue().splitlines():
        row = json.loads(line)
        cfg = C.read_config(os.path.join(cli.MODEL_ROOT, row["model"], "model.json"))
        row["terms_per_sample"] = {k: v / row["window"]
                                   for k, v in mfu.flop_terms(cfg, row["window"]).items()}
        name = row.pop("model")
        counts_mfu[name] = row
        log(f"  10d {name}: " + json.dumps(row))
    if any("share_of_bf16_peak" not in counts_mfu[m] or counts_mfu[m]["card"] != smi
           for m in ("DNA_default", "DNA_slow")):
        fail(f"10d: mfu printed no share beside the card for a device axis: {counts_mfu}")
    numbers["mfu"] = counts_mfu
    # what comes back through --out stays small: the corpora, caches and
    # checkpoints go, the configs, metrics and ranking stay
    for root, dirs, names in os.walk(rwork, topdown=False):
        for n in names:
            if not n.endswith((".json", ".jsonl")):
                os.remove(os.path.join(root, n))
    return numbers, launches


def last_modules(torch, work, sig_dir, gpu_model, batch, phase3_step, reset, counts,
                 check_counts, smi):
    """Phase 11: the last modules of the port on the card. ``batch``: phase
    3's first dna-pre batch (x, seq_len) on the card; ``phase3_step``: its
    beam-30 step outputs (tokens, lengths, ...); ``sig_dir``: phase 3's reads,
    whose beam-30 call wrote <work>/out_beam30. Returns the numbers and the
    launches of the phase's runs by kernel-line name."""
    import importlib.util

    from chiron_tpu_torch import cli
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.io import signal as sigio
    from chiron_tpu_torch.models.attention import init_attention_decoder
    from chiron_tpu_torch.ops import ctc_mc, host_build
    from chiron_tpu_torch.params import attention_from_jax
    from chiron_tpu_torch.train.loop import edit_distance

    xg, slg = batch
    numbers, launches = {"card": smi}, {}
    kernel_names = {"conv_bn_float32": "conv_bn", "bilstm_float32": "bilstm",
                    "beam_search": "beam_search", "beam_traceback": "beam_traceback"}
    encoder_launches = {"conv_bn_float32": 12, "bilstm_float32": 3}
    failures = []

    def counted(label, fn, want):
        """fn() with every count set to 0 just before and read just after;
        each count must be the expected one; added to the kernel line's."""
        reset()
        out = fn()
        torch.cuda.synchronize()
        cnt = counts()
        check_counts(label, cnt, want)
        for k, n in cnt.items():
            if n:
                launches[kernel_names[k]] = launches.get(kernel_names[k], 0) + n
        log(f"  {label}: launches {dict((k, n) for k, n in cnt.items() if n)}")
        return out

    def hold(name, value, limit, sense="<="):
        ok = value <= limit if sense == "<=" else value >= limit
        log(f"  {name}: {value:.4g} ({sense} {limit:.4g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    def host_ms(fn, reps=3):
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return 1e3 * (time.perf_counter() - t) / reps, out

    def top_shares(decoded, s):
        return np.asarray([ctc_mc._mode_and_qs(decoded[:, i, :], s)[1] / s
                           for i in range(decoded.shape[1])])

    def mc_on(logits, lens, gen, s):
        """(strings, decoded on the host, device ms, host ms) of one mc_decode."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        decoded, _ = ctc_mc._sample_and_collapse(logits, lens, gen, s)
        end.record()
        end.synchronize()
        t = time.perf_counter()
        host = decoded.cpu().numpy()
        strings, _ = ctc_mc.modes_to_strings(host, s)
        return strings, host, start.elapsed_time(end), 1e3 * (time.perf_counter() - t)

    def cpu_mc(logits, lens, s):
        gen = torch.Generator().manual_seed(0)
        decoded, _ = ctc_mc._sample_and_collapse(logits.cpu(), lens.cpu(), gen, s)
        decoded = decoded.numpy()
        return ctc_mc.modes_to_strings(decoded, s)[0], top_shares(decoded, s)

    # ---- 11a. mc_decode at S = 300 on phase 3's first batch ----------------------
    s = 300
    with torch.no_grad():
        logits = counted("11a DNA_default forward (the batch's logits)",
                         lambda: gpu_model(xg, slg), encoder_launches)
    lens = slg.to(torch.int32)
    runs = [mc_on(logits, lens, torch.Generator(device="cuda").manual_seed(SEED), s)
            for _ in range(2)]
    same_runs = runs[0][0] == runs[1][0] and np.array_equal(runs[0][1], runs[1][1])
    log(f"  11a mc_decode twice with one seed: identical {same_runs}")
    if not same_runs:
        failures.append("11a mc_decode repeat")
    paths = ctc_mc.sample_paths(logits, torch.Generator(device="cuda").manual_seed(SEED), s)
    p = torch.softmax(logits.double(), -1).reshape(-1, logits.shape[-1])
    freq = torch.bincount(paths.reshape(-1).long(), minlength=p.shape[1]).double()
    z = ((freq - s * p.sum(0)).abs() / torch.sqrt(s * (p * (1 - p)).sum(0))).max().item()
    hold("11a sampled class frequencies vs softmax (worst class, binomial SDs)", z, 5.0)
    cpu_strings, cpu_shares = cpu_mc(logits, lens, s)
    held = np.flatnonzero(cpu_shares >= 0.6)
    mismatched = [int(i) for i in held if runs[0][0][i] != cpu_strings[i]]
    log(f"  11a windows where the CPU's top path holds >= 60% of {s} samples: {len(held)} of "
        f"{len(lens)} (largest share {cpu_shares.max():.3f}); card != CPU there: {mismatched}")
    if mismatched:
        failures.append("11a mode strings card vs CPU")
    beam_strs = ["".join("ACGT"[c] for c in phase3_step[0][i, :phase3_step[1][i]])
                 for i in range(len(lens))]
    mc_strs = runs[0][0]
    ident = [1 - edit_distance([ord(c) for c in a], [ord(c) for c in b]) / max(len(a), len(b), 1)
             for a, b in zip(mc_strs, beam_strs)]
    numbers["mc_decode"] = {
        "windows": len(lens), "samples": s, "device_ms": runs[1][2], "host_ms": runs[1][3],
        "held_windows_cpu": int(len(held)), "same_as_beam30": sum(
            a == b for a, b in zip(mc_strs, beam_strs)), "identity_to_beam30": float(np.mean(
                ident)), "mean_bases_mc": float(np.mean([len(a) for a in mc_strs])),
        "mean_bases_beam30": float(np.mean([len(b) for b in beam_strs])), "worst_z": z}
    log(f"  11a mc_decode: {json.dumps(numbers['mc_decode'])}")

    # ---- 11b. section_decoding on the same logits --------------------------------
    # section_decoding reads no lengths: the frames past each window's length
    # (a read's last window is mostly padding) get the blank logit its pad
    # frames get, or one ~390-frame section would pad every section to 390
    past = torch.arange(logits.shape[1], device=logits.device)[None, :] >= lens[:, None]
    blank_frame = torch.zeros(logits.shape[-1], device=logits.device)
    blank_frame[-1] = 30.0
    logits = torch.where(past[..., None], blank_frame, logits)
    t = time.perf_counter()
    sections = [ctc_mc.section_decoding(logits, generator=torch.Generator(
        device="cuda").manual_seed(SEED), sample_n=s) for _ in range(2)]
    sec_ms = 1e3 * (time.perf_counter() - t) / 2
    if sections[0] != sections[1]:
        failures.append("11b section_decoding repeat")
    sec_batch, sec_lens, spans = ctc_mc.section_spans(logits.cpu().numpy(), 0.6)
    sec_g = torch.from_numpy(sec_batch).cuda()
    sec_l = torch.from_numpy(sec_lens).cuda()
    g_strings, _, sec_dev_ms, sec_host_ms = mc_on(
        sec_g, sec_l, torch.Generator(device="cuda").manual_seed(SEED), s)
    c_strings, c_shares = cpu_mc(sec_g, sec_l, s)
    sec_held = np.flatnonzero(c_shares >= 0.6)
    sec_bad = [int(k) for k in sec_held if g_strings[k] != c_strings[k]]
    joined = [""] * len(lens)
    for k, (i, _, _) in enumerate(spans):
        joined[i] += g_strings[k]
    log(f"  11b section_decoding: {len(spans)} sections (longest {sec_batch.shape[1]} frames); "
        f"repeat identical {sections[0] == sections[1]}; equal to the joined section "
        f"strings {joined == sections[0]}; sections the CPU's top path holds >= 60%: "
        f"{len(sec_held)}; card != CPU there: {sec_bad[:20]} ({len(sec_bad)})")
    if sec_bad or joined != sections[0] or len(sec_held) < len(spans) // 2:
        failures.append("11b sections card vs CPU")
    numbers["section_decoding"] = {
        "sections": len(spans), "longest": int(sec_batch.shape[1]), "wall_ms": sec_ms,
        "mc_device_ms": sec_dev_ms, "mc_host_ms": sec_host_ms, "held_sections": int(len(
            sec_held)), "same_as_beam30": sum(a == b for a, b in zip(sections[0], beam_strs))}
    log(f"  11b section_decoding: {json.dumps(numbers['section_decoding'])}")

    # ---- 11c. the attention decoder over DNA_default's encoder features ------------
    hidden, steps = 128, 64
    with torch.no_grad():
        enc = counted("11c DNA_default encoder (the features that feed the head)",
                      lambda: gpu_model.encode(xg, slg), encoder_launches)
    tree = {k: v.numpy() for k, v in init_attention_decoder(
        torch.Generator().manual_seed(SEED), enc.shape[-1], hidden).items()}
    dec_g, dec_c = attention_from_jax(tree, "cuda"), attention_from_jax(tree, "cpu")
    enc_c, lens_c = enc.cpu(), slg.cpu()
    with torch.no_grad():
        tok_g, lg_g = dec_g.decode(enc, slg, steps)
        tok_c, lg_c = dec_c.decode(enc_c, lens_c, steps)
        decode_ms = time_ms(torch, lambda: dec_g.decode(enc, slg, steps), 3, warm=1)
    same_tok = float((tok_g.cpu() == tok_c).all(1).float().mean())
    hold("11c greedy tokens card vs CPU (share of windows all equal)", same_tok, 0.99, ">=")
    tgt = torch.full((len(lens), steps), -1, dtype=torch.int64)
    for i in range(len(lens)):
        n = min(int(phase3_step[1][i]), steps)
        tgt[i, :n] = torch.from_numpy(phase3_step[0][i, :n].astype(np.int64))
    tlen = (tgt >= 0).sum(1)

    def forced(dec, e, ln, dev):
        dec.requires_grad_(True)
        for prm in dec.parameters():
            prm.grad = None
        tf_logits = dec.teacher_forced_logits(e, ln, tgt.to(dev))
        loss = dec.loss(e, ln, tgt.to(dev), tlen.to(dev))
        loss.backward()
        return (tf_logits.detach().cpu(), float(loss.detach()),
                {k: prm.grad.cpu() for k, prm in dec.flat.items()})

    lg_tf_g, loss_g, grads_g = forced(dec_g, enc, slg, "cuda")
    lg_tf_c, loss_c, grads_c = forced(dec_c, enc_c, lens_c, "cpu")
    hold("11c teacher-forced logits card vs CPU (/ max |logit|)",
         float((lg_tf_g - lg_tf_c).abs().max()) / float(lg_tf_c.abs().max()), 1e-4)
    hold("11c teacher-forced loss card vs CPU (relative)", abs(loss_g - loss_c) / abs(loss_c),
         1e-5)
    hold("11c gradients card vs CPU (worst leaf, / its max)",
         max(float((grads_g[k] - g).abs().max()) / float(g.abs().max()) for k, g in
             grads_c.items()), 1e-4)
    loss_ms = time_ms(torch, lambda: forced(dec_g, enc, slg, "cuda"), 3, warm=1)
    numbers["attention"] = {"windows": len(lens), "frames": int(enc.shape[1]),
                            "enc_dim": int(enc.shape[-1]), "hidden": hidden, "steps": steps,
                            "decode_ms": decode_ms, "loss_backward_ms": loss_ms,
                            "same_tokens": same_tok, "loss": loss_c,
                            "max_logit_decode_gap": float((lg_g.cpu() - lg_c).abs().max())}
    log(f"  11c attention: {json.dumps(numbers['attention'])}")

    # ---- 11d. the native host library: parse and glue against the numpy paths -------
    try:
        lib_path = host_build.build()
    except host_build.NativeBuildError as e:
        fail(f"11d: the native host library does not build: {e}")
    if not host_build.native_available():
        fail("11d: the native host library does not load")
    log(f"  11d native host library built with g++ -> {lib_path}")
    files = sorted(f for f in os.listdir(sig_dir) if f.endswith(".signal"))
    parse = {"native": 0.0, "numpy": 0.0}
    for f in files:
        with open(os.path.join(sig_dir, f), "rb") as fh:
            raw = fh.read()
        ms, native = host_ms(lambda: sigio.parse_signal_text(raw))
        parse["native"] += ms
        with host_build.numpy_paths():
            ms, plain = host_ms(lambda: sigio.parse_signal_text(raw))
        parse["numpy"] += ms
        if native.tobytes() != plain.tobytes():
            fail(f"11d: {f} parses differently native vs numpy")
    recorded = []
    assemble = pipeline.simple_assembly_qs

    def recording(*args, **kw):
        recorded.append((args, kw))
        return assemble(*args, **kw)

    out_numpy = os.path.join(work, "out_beam30_numpy_paths")
    n_batches = -(-sum(len(range(0, sigio.read_signal(os.path.join(sig_dir, f)).size, JUMP))
                       for f in files) // BATCH)
    pipeline.simple_assembly_qs = recording
    try:
        with host_build.numpy_paths():
            counted("11d call -p dna-pre --beam 30 on the numpy paths", lambda: cli.main(
                ["call", "-i", sig_dir, "-o", out_numpy, "-p", "dna-pre", "--mode", "dna",
                 "--sig_norm", "1", "--beam", str(BEAM), "--device", "cuda"]),
                {"conv_bn_float32": 12 * n_batches, "bilstm_float32": 3 * n_batches,
                 "beam_search": n_batches, "beam_traceback": n_batches})
    finally:
        pipeline.simple_assembly_qs = assemble
    for sub in ("result", "segments"):
        native_dir, numpy_dir = (os.path.join(work, "out_beam30", sub),
                                 os.path.join(out_numpy, sub))
        for f in sorted(os.listdir(native_dir)):
            with open(os.path.join(native_dir, f), "rb") as a, \
                    open(os.path.join(numpy_dir, f), "rb") as b:
                if a.read() != b.read():
                    fail(f"11d: {sub}/{f} differs between phase 3's call (native host code) "
                         "and the call on the numpy paths")
    glue = {"native": 0.0, "numpy": 0.0}
    for args, kw in recorded:
        ms, native = host_ms(lambda: assemble(*args, **kw))
        glue["native"] += ms
        with host_build.numpy_paths():
            ms, plain = host_ms(lambda: assemble(*args, **kw))
        glue["numpy"] += ms
        if any(a.tobytes() != b.tobytes() for a, b in zip(native, plain)):
            fail("11d: the glue assembler's counts differ native vs numpy")
    numbers["native"] = {
        "reads": len(files), "assembled_reads": len(recorded),
        "parse_ms_per_read": {k: v / len(files) for k, v in parse.items()},
        "glue_ms_per_read": {k: v / max(len(recorded), 1) for k, v in glue.items()},
        "fastq_equal_to_phase3": True}
    log(f"  11d native host code: {json.dumps(numbers['native'])}")

    # ---- 11e. the fast5 tools -------------------------------------------------------
    log("  11e: chiron export, tools/file_batch, tools/labeler, tools/regen_goldens and the "
        "fast5 half of io/labels run on the host and read fast5 with h5py "
        f"(h5py here: {importlib.util.find_spec('h5py') is not None}); "
        "tests/test_torch_fast5_export.py and tests/test_torch_regen_goldens.py hold them "
        "to the JAX package on the CPU, and phase 8 trains from the .bin / TFRecord / "
        ".signal sources they write")
    if failures:
        fail(f"phase 11: {failures}")
    return numbers, launches


def crf_model(torch, work, reset, counts, check_counts, smi):
    """Phase 12: Bonito's HAC CRF model (CRF_CONFIG) on the card. Returns its
    numbers and its rows of the kernel line (the stem's conv_bn instances in
    both modes, the three CRF kernels)."""
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch import cli
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.io.signal import read_signal_for_eval
    from chiron_tpu_torch.models import crf as mcrf, layers as L, model as M
    from chiron_tpu_torch.ops import conv_bn, crf, lstm
    from chiron_tpu_torch.reference import bonito_crf as RB
    from chiron_tpu_torch.train.checkpoint import save_checkpoint

    dev = torch.device("cuda")
    blank = CRF_CONFIG["decoder"]["blank_score"]
    numbers, failures = {"card": smi}, []

    def hold(name, err, tol):
        ok = err <= tol
        log(f"  {name}: {err:.3e} (tolerance {tol:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        return err

    # the model directory, written as the benchmark's runner writes it, and
    # 20 reads of 41 windows each (39 of 4,000 samples, then 3,510 and 10)
    state = RB.init_bonito(CRF_WEIGHTS_SEED, gains=CRF_GAINS)
    mdir = os.path.join(work, "bonito_hac")
    save_checkpoint(mdir, mcrf.from_bonito(state, CRF_CONFIG["rnn"]["layer_num"]), 0)
    with open(os.path.join(mdir, "model.json"), "w") as f:
        json.dump(CRF_CONFIG, f)
    sig = os.path.join(work, "signal_crf")
    n_reads, samples = 20, 40 * CRF_JUMP + 10
    write_reads(sig, n_reads, samples, np.random.RandomState(SEED + 12))
    per_read = [min(CRF_SEG, samples - s) for s in range(0, samples, CRF_JUMP)]
    lens = np.array(per_read * n_reads)
    batches = -(-len(lens) // BATCH)
    last = lens[(batches - 1) * BATCH:]  # the last batch repeats its own windows
    padded = np.concatenate([lens[:(batches - 1) * BATCH],
                             np.pad(last, (0, BATCH - len(last)), mode="wrap")])
    frames = int(sum(-(-int(n) // 5) for n in padded))  # ceil(samples / stride) a window

    # `call` in both modes, every count set to 0 just before and read just after
    launches = {}
    for tag, b16 in (("float32", False), ("bfloat16", True)):
        args = ["call", "-i", sig, "-m", mdir, "-l", str(CRF_SEG), "-j", str(CRF_JUMP),
                "-b", str(BATCH), "--sig_norm", "0", "--device", "cuda"]
        args += ["--bf16"] if b16 else []
        for run in ("counted", "warm"):
            out = os.path.join(work, f"out_crf_{tag}_{run}")
            reset()
            f0 = crf.frames_decoded()
            t = time.time()
            res = cli.main(args[:3] + ["-o", out] + args[3:])
            torch.cuda.synchronize()
            wall = time.time() - t
            cnt = counts()
            got_frames = crf.frames_decoded() - f0
            log(f"call -m bonito_hac{' --bf16' if b16 else ''} ({run}): "
                f"{res['total_windows']} windows in {batches} batches, {res['total_bases']} "
                f"bases in {wall:.3f} s ({res['total_bases'] / wall:.0f} bases/s); frames "
                f"decoded {got_frames}; launches {dict((k, n) for k, n in cnt.items() if n)}")
            check_counts(f"bonito_hac call {tag} ({run})", cnt,
                         {f"conv_bn_{tag}": 3 * batches, f"lstm_layer_{tag}": 5 * batches,
                          "crf_beta": batches, "crf_viterbi": batches,
                          "crf_traceback": batches})
            # float32 at H = 384 takes the cluster-of-16 kernel, bf16 the streamed instance
            by_route = {k: n for k, n in lstm.launches_by_route.items() if n}
            want_route = {"streamed" if b16 else "cluster16": 5 * batches}
            log(f"  lstm_layer launches by route: {by_route}")
            if by_route != want_route:
                fail(f"bonito_hac call {tag}: lstm_layer routes {by_route}, expected {want_route}")
            if got_frames != frames:
                fail(f"bonito_hac call {tag}: {got_frames} frames decoded, expected {frames}")
            if res["n_files"] != n_reads or res["total_windows"] != len(lens):
                fail(f"bonito_hac call {tag}: expected {n_reads} files / {len(lens)} "
                     f"windows, got {res}")
            result_dir = os.path.join(out, "result")
            fastqs = sorted(os.listdir(result_dir))
            if len(fastqs) != n_reads:
                fail(f"bonito_hac call {tag}: {len(fastqs)} fastq files, expected {n_reads}")
            for name in fastqs:
                with open(os.path.join(result_dir, name)) as fh:
                    lines = fh.read().splitlines()
                if len(lines) != 4 or not lines[1] or len(lines[1]) != len(lines[3]) \
                        or set(lines[1]) - set("ACGT"):
                    fail(f"bonito_hac call {tag}: malformed fastq {name}")
            numbers[f"call_{tag}_{run}"] = {"seconds": wall, "bases": res["total_bases"],
                                            "bases_per_s": res["total_bases"] / wall}
            if run == "counted":
                for k, n in cnt.items():
                    if n:
                        launches[k] = launches.get(k, 0) + n

    # the first batch's windows as the call makes them (median / MAD)
    wins, samp = [], []
    for i in range(n_reads):
        w, n = read_signal_for_eval(os.path.join(sig, f"read{i:02d}.signal"), 0,
                                    step=CRF_JUMP, seg_length=CRF_SEG, normalize=0)
        wins.append(w)
        samp.append(n)
    x = torch.from_numpy(np.concatenate(wins)[:BATCH]).to(dev)
    n_samp = np.concatenate(samp)[:BATCH]
    fr = torch.from_numpy(M.window_frames(CRF_CONFIG, n_samp, CRF_SEG)).to(dev)
    model = pipeline.load_model(mdir, C.read_config(os.path.join(mdir, "model.json")), dev)

    # the step against the plain reference on the card (float32, TF32 off)
    ref = RB.BonitoCRF(state, dev)
    with torch.no_grad():
        r_str, r_score, _ = ref.basecall(x[:CRF_REF_ROWS], fr[:CRF_REF_ROWS])
    r_score = r_score.cpu().numpy()
    for tag, b16 in (("float32", False), ("bfloat16", True)):
        dec, n_out, score, _ = pipeline.unpack_step_outputs(
            pipeline.decode_step(model, x, fr, 0, 0.0, b16).cpu().numpy())
        got = ["".join("ACGT"[c] for c in dec[i, :n_out[i]]) for i in range(CRF_REF_ROWS)]
        gap = float(np.abs(score[:CRF_REF_ROWS] - r_score).max() / np.abs(r_score).max())
        same = sum(g == r for g, r in zip(got, r_str)) / CRF_REF_ROWS
        numbers[f"step_{tag}_vs_reference"] = {"score_gap": gap, "same_strings": same,
                                               "bases": int(n_out[:CRF_REF_ROWS].sum())}
        log(f"  step {tag} vs the plain reference on {CRF_REF_ROWS} windows: score gap "
            f"{gap:.3e}, identical strings {same:.3f}, {int(n_out[:CRF_REF_ROWS].sum())} "
            f"bases (reference {sum(map(len, r_str))})")
        if not b16:  # bf16 is printed beside it: its gap is the working type's
            hold("bonito_hac step float32 vs reference: score gap", gap, CRF_SCORE_GAP)
            if same < CRF_MIN_SAME:
                failures.append("bonito_hac step float32 vs reference: identical strings")

    # the CRF kernels against their plain version on the batch's float32 scores
    with torch.no_grad():
        z = M.crf_scores(model.params, model.config, model.encode(x, fr)).contiguous()
    lc = fr.contiguous()
    s_count = z.shape[2] // 4
    beta = crf.crf_beta(z, lc, blank)
    tb, score, prob, final = crf.crf_viterbi(z, lc, beta, blank)
    path = crf.crf_traceback(tb, final, lc)
    beta_p = crf.crf_beta_plain(z, lc, blank)
    tb_p, score_p, prob_p, final_p, post_p = crf.crf_forward_plain(z, lc, beta_p, blank,
                                                                   posteriors=True)
    path_p = crf.crf_traceback_plain(tb_p, final_p, lc)
    t_max = z.shape[1]
    live = torch.arange(t_max + 1, device=dev)[None, :, None] <= lc.long()[:, None, None]
    pred = crf.predecessors(s_count, dev)
    rows_i = torch.arange(BATCH, device=dev)

    def path_score(cols, fin):
        """Each row's path (columns, from its final state) scored under the
        plain version's log posteriors."""
        st, total = fin.long(), torch.zeros(BATCH, dtype=torch.float64, device=dev)
        for t in range(t_max - 1, -1, -1):
            on, c = t < lc, cols[:, t].long().clamp(min=0)
            total += torch.where(on, post_p[rows_i, t, st, c].double(), 0.0)
            st = torch.where(on, pred[st, c], st)
        return total

    # a row on another path is a near-tie: both paths score alike under the
    # plain version's posteriors (random weights leave many)
    other = (path != path_p).any(dim=1)
    tie = ((path_score(path, final) - path_score(path_p, final_p)).abs()
           / lc.clamp(min=1).double()).masked_fill(~other, 0.0)
    pc, pp = path.cpu(), path_p.cpu()
    other_bases = sum(not torch.equal(pc[r][pc[r] >= 1], pp[r][pp[r] >= 1])
                      for r in torch.nonzero(other).flatten().tolist())
    del post_p
    crf_err = {
        "beta_rel": float(((beta - beta_p).abs() * live).max() / beta_p.abs().max()),
        "score_per_frame": float(((score - score_p).abs() / lc.clamp(min=1).float()).max()),
        "prob_abs": float((prob - prob_p).abs().max()),
        "rows_on_another_path": int(other.sum()), "rows_with_other_bases": other_bases,
        "near_tie_gap_per_frame": float(tie.max())}
    log(f"CRF kernels at B={BATCH} T={t_max} S={s_count} (the first batch's scores): "
        + json.dumps(crf_err))
    hold("crf_beta vs plain (beta, relative to max |beta|)", crf_err["beta_rel"], 1e-6)
    hold("crf_viterbi vs plain (Viterbi score a frame)", crf_err["score_per_frame"], 1e-3)
    hold("crf_viterbi vs plain (mean posterior gap)", crf_err["prob_abs"], 1e-4)
    hold("crf_traceback vs plain (rows on another path: their path scores' gap a frame "
         "under the plain posteriors)", crf_err["near_tie_gap_per_frame"], 1e-3)
    timing = {
        "crf_beta": (time_ms(torch, lambda: crf.crf_beta(z, lc, blank), 10),
                     time_ms(torch, lambda: crf.crf_beta_plain(z, lc, blank), 2, 1), None),
        "crf_viterbi": (time_ms(torch, lambda: crf.crf_viterbi(z, lc, beta, blank), 10),
                        time_ms(torch, lambda: crf.crf_forward_plain(z, lc, beta_p, blank), 2, 1),
                        None),
        "crf_traceback": (time_ms(torch, lambda: crf.crf_traceback(tb, final, lc), 20),
                          time_ms(torch, lambda: crf.crf_traceback_plain(tb_p, final_p, lc),
                                  2, 1), None)}
    bounds = crf_bounds(float(lc.sum()), BATCH, t_max, s_count)
    err = {"crf_beta": crf_err["beta_rel"] * float(beta_p.abs().max()),
           "crf_viterbi": float((score - score_p).abs().max()),
           "crf_traceback": crf_err["near_tie_gap_per_frame"]}
    del z, beta, beta_p, tb_p

    # the stem's three convs (swish prologue on the second and third, k // 2
    # padding) against their plain version and cuDNN, at T = 4,000, B = 400
    stem = {}
    for tag, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x0 = L.store_activation(x, dt == torch.bfloat16)[..., None]
        terms = ((x0, torch.ones(1, device=dev), torch.zeros(1, device=dev)),)
        row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
               "bound_by": []}
        for i, (k, c_out, stride) in enumerate(M._bonito_stem_shapes(CRF_CONFIG["cnn"])):
            p = model.params["cnn"][f"conv{i + 1}"]
            args = (terms, p["w"], False, stride, dt, i > 0, k // 2)
            got = conv_bn.conv_bn(*args)
            want = conv_bn.conv_bn_plain(*args)
            scale = float(want[0].float().abs().max())
            e = float((got[0].float() - want[0].float()).abs().max())
            # float32 at conv_bn's tolerance; bf16 within one ulp of the largest value
            hold(f"stem conv{i + 1} {tag} k={k} {terms[0][0].shape[2]}->{c_out} stride "
                 f"{stride} vs plain (relative to max |y|)", e / scale,
                 1e-4 if dt == torch.float32 else 1 / 128)
            xin = conv_bn._prologue(terms, False, i > 0).to(dt).transpose(1, 2).contiguous()
            w_lib = p["w"].permute(2, 1, 0).contiguous().to(dt)
            row["ms"] += time_ms(torch, lambda: conv_bn.conv_bn(*args), 10)
            row["plain_ms"] += time_ms(torch, lambda: conv_bn.conv_bn_plain(*args), 3, 1)
            row["library_ms"] += time_ms(torch, lambda: torch.nn.functional.conv1d(
                xin, w_lib, None, stride, k // 2), 10)
            b_ms, b_by, _ = conv_bound(terms, p["w"], stride)
            row["bound_ms"] += b_ms
            row["bound_by"].append(b_by)
            row["err"] = max(row["err"], e)
            terms = ((got[0], torch.ones(c_out, device=dev), p["b"]),)
        stem[tag] = row
        log(f"  stem {tag} (three convs): {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
            f"cuDNN {row['library_ms']:.4f}, bound {row['bound_ms']:.4f})")
    # row 5h: one of the five LSTM layers at the batch's shape (T = 800, B = 400,
    # H = 384, float32, the first batch's frames a row, in flip mode as the
    # reversed layers run) through the cluster-of-16 kernel, beside the streamed
    # instance of csrc/bilstm.cu, nn.LSTM and the bound
    hid = CRF_CONFIG["rnn"]["hidden_num"]
    w_scale = (6 / (5 * hid)) ** 0.5 / 2
    xw_h = torch.randn(t_max, BATCH, 4 * hid, generator=torch.Generator().manual_seed(SEED),
                       ).to(dev)
    wh_h = (torch.randn(hid, 4 * hid, generator=torch.Generator().manual_seed(SEED + 1))
            * w_scale).to(dev)
    ln_h = fr.to(torch.int32).contiguous()
    st_h = (t_max - ln_h).to(torch.int32)
    route_h = lstm.route(BATCH, hid, 1, torch.float32,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    got_h = lstm.lstm_layer(xw_h, wh_h, ln_h, st_h)
    again_h = lstm.lstm_layer(xw_h, wh_h, ln_h, st_h)
    want_h = lstm.lstm_layer_plain(xw_h, wh_h, ln_h, st_h)
    torch.cuda.synchronize()
    err_h = hold(f"lstm_layer T={t_max} B={BATCH} H={hid} flip mode ({route_h}, rows and "
                 f"clusters {lstm.c16_geometry(BATCH, lstm.c16_clusters(dev))}) vs plain",
                 float((got_h - want_h).abs().max()), 1e-4)
    if route_h != "cluster16" or not torch.equal(got_h, again_h):
        failures.append(f"lstm_layer at H = {hid}: route {route_h}, bit-identical "
                        f"{torch.equal(got_h, again_h)}")
    lib_h = torch.nn.LSTM(hid, hid).to(dev)
    x_h = torch.randn(t_max, BATCH, hid, device=dev)
    with torch.no_grad():
        timing["lstm_layer_hac"] = (
            time_ms(torch, lambda: lstm.lstm_layer(xw_h, wh_h, ln_h, st_h), 5),
            time_ms(torch, lambda: lstm.lstm_layer_plain(xw_h, wh_h, ln_h, st_h), 1, 0),
            time_ms(torch, lambda: lib_h(x_h), 5))
        streamed_h = time_ms(torch, lambda: lstm._launch(xw_h, wh_h, ln_h, st_h, "streamed"), 3)
    bounds["lstm_layer_hac"] = recurrent_bound(
        "lstm_c16" if route_h == "cluster16" else "lstm", float(ln_h.sum()), t_max, BATCH, hid)
    err["lstm_layer_hac"] = err_h
    log(f"  row 5h, lstm_layer T={t_max} B={BATCH} H={hid}: {timing['lstm_layer_hac'][0]:.3f} ms "
        f"({route_h}); streamed instance {streamed_h:.3f} ms; nn.LSTM "
        f"{timing['lstm_layer_hac'][2]:.3f} ms; bound {bounds['lstm_layer_hac'][0]:.4f} ms")
    numbers["row_5h_ms"] = {"cluster16": timing["lstm_layer_hac"][0], "streamed": streamed_h,
                            "library_ms": timing["lstm_layer_hac"][2],
                            "bound_ms": bounds["lstm_layer_hac"][0]}
    del xw_h, x_h, lib_h, want_h
    if failures:
        fail(f"Bonito's HAC CRF model on the card: {failures}")

    source = {"crf": ("chiron_tpu_torch/csrc/crf.cu",
                      "no JAX kernel: Bonito's CTC_CRF.decode_batch (bonito/crf/model.py)"),
              "stem": ("chiron_tpu_torch/csrc/conv_bn.cu", "chiron_tpu/ops/pallas/convbn.py:188")}
    rows = []
    ms, plain_ms, lib_ms = timing["lstm_layer_hac"]
    rows.append({"name": "lstm_layer_hac", "route": "cuda", "source":
                 "chiron_tpu_torch/csrc/lstm_c16.cu",
                 "replaces": "chiron_tpu/ops/pallas/lstm.py:141",
                 "launches": launches.get("lstm_layer_float32", 0),
                 "max_abs_err": err["lstm_layer_hac"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bounds["lstm_layer_hac"][0], "bound_by": bounds["lstm_layer_hac"][1],
                 "library_ms": lib_ms})
    for name in ("crf_beta", "crf_viterbi", "crf_traceback"):
        ms, plain_ms, lib_ms = timing[name]
        rows.append({"name": name, "route": "cuda", "source": source["crf"][0],
                     "replaces": source["crf"][1], "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                     "library_ms": lib_ms})
    for name, tag in (("conv_bn_stem", "float32"), ("conv_bn_stem_bf16", "bfloat16")):
        r = stem[tag]
        rows.append({"name": name, "route": "cuda", "source": source["stem"][0],
                     "replaces": source["stem"][1], "launches": launches[f"conv_bn_{tag}"],
                     "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": " + ".join(r["bound_by"]),
                     "library_ms": r["library_ms"]})
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']}), launches "
            f"{r['launches']}")
        if r["ms"] < r["bound_ms"]:
            fail(f"{r['name']}: {r['ms']:.4f} ms reads below its bound {r['bound_ms']:.4f} ms: "
                 "the count of its work is wrong")
    numbers["crf_vs_plain"] = crf_err
    numbers["launches"] = launches
    return numbers, rows


def main(out_dir=OUT_DIR):
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    from chiron_tpu_torch import cli
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.models import layers as L, model as M, rnn as R
    from chiron_tpu_torch.ops import (beam, bilstm, bnlstm, conv_bn, crf, cuda_build, gru, lstm,
                                      lstm_grad)
    from chiron_tpu_torch.ops import ctc_loss as ctc
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
                                        "bnlstm_cluster_kernel", "gru_kernel",
                                        "ctc_alpha_kernel", "ctc_beta_grad_kernel",
                                        "crf_beta_kernel", "crf_viterbi_kernel",
                                        "crf_traceback_kernel")):
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

    def lstm_route(b, hid):
        """The route and geometry lstm_layer takes on float32 xw, as printed text."""
        chosen = lstm.route(b, hid, 1, torch.float32, sms)
        if chosen == "cluster16":
            rows, clusters = lstm.c16_geometry(b, lstm.c16_clusters(dev))
            return f"cluster16: {clusters} clusters of 16 blocks, rows {rows}"
        return f"{chosen}: {geometry('infer', b, hid)}"

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
             f"({lstm_route(b_x, h_x)})", max_err(got_x[2:], want_x[2:]), 1e-4)
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
                                   f"{lstm_route(ln.shape[0], wh.shape[0])})",
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
                        lstm.launches_by_dtype, lstm.launches_by_route, beam.launches,
                        gru.launches,
                        gru.instance_launches, bnlstm.launches, bnlstm.instance_launches,
                        crf.launches):
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
                **{f"gru_{k}": n for k, n in gru.instance_launches.items()},
                **crf.launches}

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

    class FixedLogits:
        """decode_step's model, returning given logits: a step's decode of
        logits computed once (on their own device)."""

        def __init__(self, logits, config):
            self.logits, self.config = logits, config

        def __call__(self, x, seq_len, bf16=False):
            return self.logits

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
                         width=BEAM, rnn_kernel="bilstm", n_conv=12, f32_ref=None, lb=0.0,
                         n_rnn=3, cpu_logits_on_card=False):
        """One full batch, card against CPU. Float32 (``f32_ref`` None):
        logits within logit_tol of max |logit|, the card's decodes as the
        CPU's on at least min_same of the windows. bf16 (``f32_ref``: this
        function's result for the float32 step of the same batch): each side
        held to the CPU's float32 step (see BF16_RMS_RATIO), card vs CPU
        printed. Both: the beam kernel and beam_search_plain on ONE lp tensor
        (the card's log_softmax of the card's logits, both searches on the
        card) with identical traces on every window; the card's decode_step
        launches counted (n_conv conv_bn and n_rnn of rnn_kernel of the mode's
        instances, 1 search, 1 traceback). ``cpu_logits_on_card``: the CPU's
        logits are decoded by the card's beam kernels (exact against
        beam_search_plain on one lp tensor, checked here) rather than by
        beam_search_plain on the CPU (~8 s a batch at beam 30). Where a
        window decodes differently card vs CPU, the two searches' first
        divergence is printed: the two candidates' margin beside what the two
        sides' roundings moved the scores. Returns the logits and step outputs of both sides."""
        bf16_mode = f32_ref is not None
        xg, slg, xc, slc = batch
        bsz = xc.shape[0]
        t_cpu = time.time()
        logits_c = on_cpu(xc, slc, bf16=bf16_mode)
        t_cpu = time.time() - t_cpu
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
                      f"bilstm_{dt}" if rnn_kernel == "bilstm" else rnn_kernel: n_rnn,
                      "beam_search": 1, "beam_traceback": 1})
        # the CPU's step on the logits it computed above (its forward run once)
        t_dec = time.time()
        if cpu_logits_on_card:
            step_c = pipeline.unpack_step_outputs(pipeline.decode_step(
                FixedLogits(logits_c.to(dev), on_cpu.config), xg, slg, width, lb,
                bf16_mode).cpu().numpy())
        else:
            step_c = pipeline.unpack_step_outputs(pipeline.decode_step(
                FixedLogits(logits_c, on_cpu.config), xc, slc, width, lb, bf16_mode).numpy())
        t_dec = time.time() - t_dec
        same = same_decodes(step_g, step_c, bsz)
        differ = [i for i in range(bsz) if not (
            step_g[1][i] == step_c[1][i]
            and (step_g[0][i, :step_g[1][i]] == step_c[0][i, :step_c[1][i]]).all())]
        if differ:
            lp_card = lp_g.cpu()
            lp_cpu = torch.log_softmax(logits_c, -1)
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"beam_differs_{label.replace(' ', '_')}.npz")
            saved = differ[:SAVED_WINDOWS]
            np.savez(path, logits=logits_g.cpu().numpy()[saved],
                     logits_cpu=logits_c.numpy()[saved], lp_card=lp_card.numpy()[saved],
                     lp_cpu=lp_cpu.numpy()[saved], seq_len=slc.numpy()[saved],
                     windows=np.array(saved), beam_width=width, length_bonus=lb)
            for i in differ[:3]:
                div = beam.first_divergence(lp_card[i], lp_cpu[i], slc[i].to(torch.int32),
                                            width, lb)
                log(f"  {label}: window {i} decodes differently end to end; first divergence "
                    f"{json.dumps(div)} (a near-tie when the margin is within the rounding)")
            log(f"  {label}: {len(differ)} windows differ; saved the first {len(saved)} to "
                f"{path}")
        log(f"  {label} step decodes (beam {width}): {on_same}/{bsz} windows with identical "
            f"traces, kernel vs plain on one lp tensor on the card (must be all); {same}/{bsz} "
            f"identical card vs CPU end to end"
            + (f" (must be >= {min_same:.0%}: rounding of the logits and of log_softmax may "
               f"flip a near-tie beam)" if not bf16_mode else
               f" ({'at or above' if same >= BF16_MIN_SAME * bsz else 'below'} "
               f"{BF16_MIN_SAME:.0%})") + f"; CPU forward {t_cpu:.1f} s, CPU decode {t_dec:.1f} s")
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
    # a beam wider than a warp on the main path (the block kernel), the CPU's
    # logits decoded by the card's kernels (beam_search_plain at W = 80 on the
    # CPU took 36 s; the kernel is held exact against it on one lp tensor here)
    step_card_vs_cpu("DNA_default beam 80", gpu_model, cpu_model, dna_batch["float32"],
                     width=80, lb=lb, cpu_logits_on_card=True)
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
    for counter in (lstm_grad.launches, ctc.launches):
        for k in counter:
            counter[k] = 0
    t = time.time()
    result = cli.main(train_args)
    torch.cuda.synchronize()
    train_wall = time.time() - t
    train_counts = dict(lstm_grad.launches)
    ctc_counts = dict(ctc.launches)
    log(f"train -s {SEG} -b {TRAIN_BATCH} -x {TRAIN_STEPS} -t {TRAIN_RATE}: {train_wall:.3f} s, losses "
        f"{result['losses']}; launches {train_counts}, CTC loss {ctc_counts}")
    for k, n in train_counts.items():
        if n != 6 * TRAIN_STEPS:
            fail(f"train launched {k} {n} times, expected {6 * TRAIN_STEPS}")
    if ctc_counts != {"ctc_alpha": TRAIN_STEPS, "ctc_beta_grad": TRAIN_STEPS}:
        fail(f"train launched the CTC kernels {ctc_counts}, expected {TRAIN_STEPS} each")
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
            fea = L.materialize(front(model.params["cnn"], xg_m[..., None], model.config["cnn"],
                                      bf16=bf16_mode), bf16_mode)
            ev[1].record()
            if rnn_cfg["layer_num"] == 0:  # the CNN-only logit head
                logits = M.cnn_logit(model.params["cnn_logit"], fea)
            else:
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
    ctc_rest = (batch_t["seq_len"], batch_t["label"], batch_t["label_len"])
    ctc_checked = ctc._cuda_inputs(lg.detach(), *ctc_rest)
    ctc_res = ctc.ctc_alpha(*ctc_checked)
    ctc_g = torch.full((TRAIN_BATCH,), 1.0 / TRAIN_BATCH, device=dev)
    n_class = lg.shape[2]

    def focal_mean(per_row):
        return (torch.pow(1.0 - torch.exp(-per_row), 2.0) * per_row).mean()

    def ctc_library():
        # the yardstick only: blank last, but -inf, not the -1e30 sentinel
        return torch.nn.functional.ctc_loss(
            torch.log_softmax(lg, -1).transpose(0, 1), batch_t["label"].clamp(min=0).long(),
            batch_t["seq_len"].long(), batch_t["label_len"].long(), blank=n_class - 1,
            reduction="none", zero_infinity=True)

    ctc_plain_row = ctc.ctc_loss_plain(lg, *ctc_rest)
    ctc_lib_row = ctc_library()
    ctc_bound = dict(zip(("ctc_alpha", "ctc_beta_grad"), ctc_bounds(
        float(batch_t["seq_len"].clamp(max=lg.shape[1]).sum()), lg.shape[1], TRAIN_BATCH,
        int(batch_t["label"].shape[1]), n_class)))

    ctc_ms = {
        "forward": time_ms(torch, lambda: ctc_focal_loss(lg, *ctc_rest, 2.0), 10),
        "forward_backward": time_ms(
            torch, lambda: ctc_focal_loss(lg, *ctc_rest, 2.0).backward(), 10),
        "plain_forward_backward": time_ms(
            torch, lambda: focal_mean(ctc.ctc_loss_plain(lg, *ctc_rest)).backward(), 3, 1),
        "library_forward_backward": time_ms(
            torch, lambda: focal_mean(ctc_library()).backward(), 10)}
    # each half alone, for the kernels line
    ctc_timing = {
        "ctc_alpha": (time_ms(torch, lambda: ctc.ctc_alpha(*ctc_checked), 10),
                      time_ms(torch, lambda: ctc.ctc_loss_plain(lg.detach(), *ctc_rest), 3, 1),
                      time_ms(torch, ctc_library, 10)),
        "ctc_beta_grad": (
            time_ms(torch, lambda: ctc.ctc_beta_grad(ctc_res[2], ctc_res[3], ctc_res[1], ctc_g,
                                                     *ctc_checked[1:]), 10),
            time_ms(torch, lambda: torch.autograd.grad(ctc_plain_row, lg, ctc_g,
                                                       retain_graph=True), 3, 1),
            time_ms(torch, lambda: torch.autograd.grad(ctc_lib_row, lg, ctc_g,
                                                       retain_graph=True), 10))}
    # the kernels against the plain version on the same tensors: per-row
    # values, and the gradient of a weighted focal sum (a cotangent a row)
    w_rows = torch.linspace(0.5, 1.5, TRAIN_BATCH, device=dev)
    ctc_got, ctc_want = [], []
    for fn, dst in ((ctc.ctc_loss, ctc_got), (ctc.ctc_loss_plain, ctc_want)):
        per_row = fn(lg, *ctc_rest)
        dst += [per_row.detach(), torch.autograd.grad(
            (torch.pow(1.0 - torch.exp(-per_row), 2.0) * per_row * w_rows).sum(), lg)[0]]
    torch.cuda.synchronize()
    ctc_err = {"loss_abs": float((ctc_got[0] - ctc_want[0]).abs().max()),
               "grad_abs": float((ctc_got[1] - ctc_want[1]).abs().max())}
    log(f"CTC loss at B={TRAIN_BATCH} T={lg.shape[1]} U={int(batch_t['label'].shape[1])} "
        f"(focal, gamma 2): ms " + json.dumps(ctc_ms) + "; kernels vs plain "
        + json.dumps(ctc_err) + f"; launches in the train run {ctc_counts}")
    if not (torch.allclose(ctc_got[0], ctc_want[0], rtol=1e-5, atol=1e-4)
            and torch.allclose(ctc_got[1], ctc_want[1], rtol=0, atol=1e-5)):
        fail(f"the CTC kernels disagree with their plain version: {ctc_err}")
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
        b_ms, b_by, b_unit = conv_bound(terms, w, stride)
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
        b_ms, b_by, b_unit = conv_bound(terms, w, stride)
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
    timing.update(ctc_timing)
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
                "lstm_layer_route": lstm_route(BATCH, h_x),
                "lstm_layer_streamed": time_ms(torch, lambda: lstm._launch(
                    xw_x, wh_x, ln_x, st_x, "streamed"), 2, 1),
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
        # the library calls of rows 2w, 5w, 6w and 7w, as rows 2, 5, 6 and 7's:
        # nn.LSTM (cuDNN) bidirectional and one direction on [T, B, 256], and a
        # training layer's forward and backward on [T, 300, 2H]
        lib_bi = torch.nn.LSTM(256, h_x, bidirectional=True).to(dev)
        lib_one = torch.nn.LSTM(256, h_x).to(dev)
        lib_tr = torch.nn.LSTM(2 * h_x, h_x).to(dev)
        x_w = rnd(t_len, BATCH, 256)
        x_tr = rnd(t_len, tb, 2 * h_x).requires_grad_(True)
        out_tr, _ = lib_tr(x_tr)
        with torch.no_grad():
            wide_ms[f"H={h_x}"].update(
                bilstm_library=time_ms(torch, lambda: lib_bi(x_w), 2, 1),
                lstm_layer_library=time_ms(torch, lambda: lib_one(x_w), 2, 1))
        wide_ms[f"H={h_x}"].update(
            lstm_fwd_residuals_library=time_ms(torch, lambda: lib_tr(x_tr), 2, 1),
            lstm_bwd_library=time_ms(torch, lambda: torch.autograd.grad(
                out_tr, [x_tr] + list(lib_tr.parameters()), dh_x, retain_graph=True), 2, 1))
        del c_x, xw_x, gx_x, cx_x, xt_x, res_x, lib_bi, lib_one, lib_tr, x_w, x_tr, out_tr
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
            "lstm_layer": recurrent_bound(
                "lstm_c16" if lstm.route(BATCH, h_x, 1, torch.float32, sms) == "cluster16"
                else "lstm", act_x, t_len, BATCH, h_x),
            "lstm_layer_streamed": recurrent_bound("lstm", act_x, t_len, BATCH, h_x),
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
              "beam_traceback": bound_ms(BATCH * t_len, 4.0 * (BATCH + 2 * BATCH * t_len)),
              **ctc_bound}
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
        # no Pallas kernel: the JAX package's lax.scan recursions
        "ctc_alpha": ("chiron_tpu_torch/csrc/ctc_loss.cu", "chiron_tpu/ops/ctc_loss.py:79",
                      ctc_err["loss_abs"]),
        "ctc_beta_grad": ("chiron_tpu_torch/csrc/ctc_loss.cu", "chiron_tpu/ops/ctc_loss.py:151",
                          ctc_err["grad_abs"]),
    }
    # each count is from the run that drives its kernel: the DNA_default beam-30
    # call (float32; --bf16 for the bf16 instances), the train run, the GRU and
    # BNLSTM calls, the forward-only stacks
    path_launches = {**beam_counts, **train_counts, **ctc_counts, **uni_counts,
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
    # against the 400-window step's in float32 ulps.
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

    def step(model, x, sl, b16):
        return pipeline.unpack_step_outputs(
            pipeline.decode_step(model, x, sl, BEAM, lb, b16).cpu().numpy())

    L.bn_affine, L.conv_bn, R.bilstm_layer = traced_bn_affine, traced_conv_bn, traced_bilstm
    try:
        for dt, b16 in (("float32", False), ("bfloat16", True)):
            xg_b, slg_b = big_batch[dt][:2]
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
                   "pinned_max_logit_diff": diff_pinned}
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

    # ---- 7. the CNN zoo ----------------------------------------------------
    phase("7. the CNN zoo")
    t7 = time.time()
    # one full dna-pre batch: 10 reads of 40 windows. Each model: DNA_default's
    # model.json with the front (and for cnn_logit the RNN's layer_num) changed,
    # fresh seeded weights with the head scaled as for the GRU / BNLSTM models,
    # `call` at beam 30 in both modes with every count checked, then its step
    # on the card against the CPU (random weights: >= 95% identical decodes in
    # float32, as the GRU / BNLSTM models; bf16 by BF16_RMS_RATIO), the CPU's
    # logits decoded by the card's beam kernels (26 CPU beam searches would
    # take ~200 s). Every conv the calls send to conv_bn is recorded by shape.
    zoo_dir = os.path.join(work, "signal_zoo")
    z_reads, z_samples = 10, 39 * JUMP + 10
    write_reads(zoo_dir, z_reads, z_samples, rng)
    z_windows = z_reads * (-(-z_samples // JUMP))
    if z_windows != BATCH:
        fail(f"the zoo's reads give {z_windows} windows, not one batch of {BATCH}")
    zoo_shapes = {}  # (B, T, C_in, C_out, k, stride, terms, relu_in) -> {"model dtype": launches}
    recorder = {"model": None}

    def recording_conv_bn(terms, w, relu_in, stride=1, out_dtype=torch.float32):
        if recorder["model"] is not None:
            bsz_r, t_r, cin_r = terms[0][0].shape
            key = (bsz_r, t_r, cin_r, w.shape[2], w.shape[0], stride, len(terms), bool(relu_in))
            per = zoo_shapes.setdefault(key, {})
            per[recorder["model"]] = per.get(recorder["model"], 0) + 1
        return conv_bn_fn(terms, w, relu_in, stride=stride, out_dtype=out_dtype)

    zoo_rows, zoo_models = {}, {}
    L.conv_bn = recording_conv_bn
    try:
        for name, cnn in ZOO.items():
            t_m = time.time()
            layer_num = 0 if name == "cnn_logit" else base_json["rnn"]["layer_num"]
            mdir = os.path.join(work, f"model_zoo_{name}")
            os.makedirs(mdir)
            with open(os.path.join(mdir, "model.json"), "w") as f:
                json.dump({**base_json, "cnn": cnn,
                           "rnn": {**base_json["rnn"], "layer_num": layer_num}}, f)
            cfg = C.read_config(os.path.join(mdir, "model.json"))
            fresh = from_jax_params(M.init_model(torch.Generator().manual_seed(SEED), cfg), cfg,
                                    "cuda")
            z_batch = load_batch(fresh, zoo_dir, "dna-pre")
            fresh_tree = to_numpy_tree(fresh)
            gain = 2.0 ** round(np.log2(10.0 / float(fresh(*z_batch["float32"][:2]).abs().max())))
            head = fresh_tree["cnn_logit"] if layer_num == 0 else fresh_tree["rnn"]["head"]
            for k in (("w", "b") if layer_num == 0 else ("w_class",)):
                head[k] = head[k] * gain
            save_checkpoint(mdir, fresh_tree, 0)
            z_gpu = from_jax_params(fresh_tree, cfg, "cuda")
            z_cpu = from_jax_params(fresh_tree, cfg, "cpu")
            n_conv, n_rnn = fused_convs(cnn), 3 if layer_num else 0
            row = {"conv_bn_per_batch": n_conv, "head_gain": gain,
                   "frames": M.output_len(cfg, SEG), "calls": {}}
            z_steps = {}
            for tag, b16 in (("float32", False), ("bfloat16", True)):
                recorder["model"] = f"{name} {tag}"
                cnt = counted_call(f"zoo_{name}_{tag}", BEAM, mdir, "dna-pre", "dna", b16, zoo_dir,
                                   z_reads, z_windows)
                recorder["model"] = None
                check_counts(f"zoo {name} {tag}", cnt,
                             {f"conv_bn_{tag}": n_conv, f"bilstm_{tag}": n_rnn,
                              "beam_search": 1, "beam_traceback": 1})
                row["calls"][tag] = {k: n for k, n in cnt.items() if n}
                z_steps[tag] = step_card_vs_cpu(
                    f"zoo {name} {tag}", z_gpu, z_cpu, z_batch[tag], min_same=0.95,
                    n_conv=n_conv, n_rnn=n_rnn, f32_ref=z_steps["float32"] if b16 else None,
                    lb=lb, cpu_logits_on_card=True)
            row["bf16_vs_float32"] = bf16_vs_f32(f"zoo {name}", z_steps["float32"],
                                                 z_steps["bfloat16"], BATCH)
            row["seconds"] = time.time() - t_m
            zoo_rows[name] = row
            zoo_models[name] = (z_gpu, z_batch)
            del z_cpu
            log(f"zoo {name}: {json.dumps(row)}")
    finally:
        L.conv_bn = conv_bn_fn
    # where each model's step goes on the device, both modes
    for name, (z_gpu, z_batch) in zoo_models.items():
        for tag, b16 in (("float32", False), ("bfloat16", True)):
            log_step_parts(f"dna-pre zoo {name} {tag}", z_gpu, z_batch[tag], lb, b16)

    # conv_bn at every shape the zoo's calls gave it that phase 2 does not
    # hold: the route each instance takes, the kernel against its plain
    # version (float32 1e-4, bf16 in the working type), bit-identical across
    # two runs and (bf16, where both instances take one route) to the float32
    # instance rounded; the moments within 1e-4 (relative) of the plain
    # version's in float64: a sum of up to 160,000 rows with cancellation,
    # where the float32 plain version's own sum order is off by ~1e-4 (its
    # distance printed beside); timed beside its plain version, its bound and
    # F.conv1d + F.batch_norm (cuDNN, TF32 off) on the normalised input, in
    # turns f32, bf16, bf16, f32
    held = {(terms[0][0].shape[0], terms[0][0].shape[1], w.shape[1], w.shape[2], w.shape[0],
             stride, len(terms), relu) for terms, w, relu, stride in conv_cases.values()}
    zoo_conv = {}
    for key in sorted(zoo_shapes):
        if key in held:
            continue
        bsz_k, t_k, cin_k, cout_k, k_k, st_k, nt_k, relu_k = key
        terms = [(rnd(bsz_k, t_k, cin_k), rnd(cin_k).abs() + 0.5, rnd(cin_k, scale=0.2))
                 for _ in range(nt_k)]
        w = rnd(k_k, cin_k, cout_k, scale=(2 / (k_k * cin_k + cout_k)) ** 0.5)
        terms16 = [(r.to(bf16), a, b) for r, a, b in terms]
        label = (f"B={bsz_k} T={t_k} {cin_k}->{cout_k} k={k_k} stride={st_k} terms={nt_k}"
                 f"{' relu' if relu_k else ''}")
        routes = [conv_lib.conv_bn_route(cin_k, cout_k, k_k, st_k, int(nt_k == 2), e)
                  for e in (0, 1)]
        y, s_, q = conv_bn.conv_bn(terms, w, relu_k, st_k)
        again = conv_bn.conv_bn(terms, w, relu_k, st_k)
        py, ps, pq = conv_bn.conv_bn_plain(terms, w, relu_k, st_k)
        y16, s16, q16 = conv_bn.conv_bn(terms16, w, relu_k, st_k, out_dtype=bf16)
        again16 = conv_bn.conv_bn(terms16, w, relu_k, st_k, out_dtype=bf16)
        up = conv_bn.conv_bn([(r.float(), a, b) for r, a, b in terms16], w, relu_k, st_k)
        py16, ps16, pq16 = conv_bn.conv_bn_plain(terms16, w, relu_k, st_k, out_dtype=bf16)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, g) for a, g in zip(again, (y, s_, q)))
                and all(torch.equal(a, g) for a, g in zip(again16, (y16, s16, q16)))):
            failures.append(f"conv_bn {label} differs between two runs")
        if routes[0] == routes[1] and not (torch.equal(y16, up[0].to(bf16))
                                           and torch.equal(s16, up[1]) and torch.equal(q16, up[2])):
            failures.append(f"conv_bn bf16 {label} is not the float32 instance's function")

        def moments64(tms):
            x64 = sum(r.double() * a.double() + b.double() for r, a, b in tms)
            y64 = conv_bn.conv1d(torch.relu(x64) if relu_k else x64, w.double(), st_k)
            return y64.sum(dim=(0, 1)), (y64 * y64).sum(dim=(0, 1))

        def rel(got, want):
            return max(float(((g.double() - w_).abs() / w_.abs().clamp(min=1.0)).max())
                       for g, w_ in zip(got, want))

        err = hold(f"conv_bn {label} (routes {routes[0]} / bf16 {routes[1]}) y",
                   float((y - py).abs().max()), 1e-4)
        m64, m64_16 = moments64(terms), moments64(terms16)
        hold(f"conv_bn {label} moments vs float64 (relative)", rel((s_, q), m64), 1e-4,
             f"(the float32 plain version's: {rel((ps, pq), m64):.3e}) ")
        err16 = bf16_hold(f"conv_bn bf16 {label} y", y16, py16, 1e-4)
        hold(f"conv_bn bf16 {label} moments vs float64 (relative)", rel((s16, q16), m64_16), 1e-4,
             f"(the float32 plain version's: {rel((ps16, pq16), m64_16):.3e}) ")
        z = sum(r * a + b for r, a, b in terms)
        z = (torch.relu(z) if relu_k else z).transpose(1, 2)
        _, lpad, rpad = conv_bn.conv_window(t_k, k_k, st_k)
        z_ncw = F.pad(z, (lpad, rpad)).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()

        def library():
            return F.batch_norm(F.conv1d(z_ncw, w_oik, stride=st_k), None, None, training=True)

        turns = [time_ms(torch, fn, 5) for fn in (
            lambda: conv_bn.conv_bn(terms, w, relu_k, st_k),
            lambda: conv_bn.conv_bn(terms16, w, relu_k, st_k, out_dtype=bf16),
            lambda: conv_bn.conv_bn(terms16, w, relu_k, st_k, out_dtype=bf16),
            lambda: conv_bn.conv_bn(terms, w, relu_k, st_k))]
        b_ms, b_by, _ = conv_bound(terms, w, st_k)
        b16_ms, b16_by, _ = conv_bound(terms16, w, st_k)
        entry = {"models": zoo_shapes[key], "routes_f32_bf16": routes,
                 "ms": (turns[0] + turns[3]) / 2, "bf16_ms": (turns[1] + turns[2]) / 2,
                 "plain_ms": time_ms(torch, lambda: conv_bn.conv_bn_plain(terms, w, relu_k, st_k),
                                     2, 1),
                 "bound_ms": b_ms, "bound_by": b_by, "bf16_bound_ms": b16_ms,
                 "bf16_bound_by": b16_by, "library_ms": time_ms(torch, library, 5),
                 "max_abs_err": err, "bf16_max_abs_err": err16}
        zoo_conv[label] = entry
        if entry["ms"] < b_ms or entry["bf16_ms"] < b16_ms:
            fail(f"conv_bn {label}: {entry['ms']:.4f} / {entry['bf16_ms']:.4f} ms reads below "
                 f"its bound {b_ms:.4f} / {b16_ms:.4f} ms")
        log(f"  conv_bn {label}: {json.dumps(entry)}")
        del terms, terms16, y, py, y16, py16, again, again16, up, z, z_ncw, m64, m64_16
    if failures:
        fail(f"conv_bn disagrees with its plain version at a zoo shape: {failures}")
    log(f"conv_bn at the zoo's {len(zoo_conv)} new shapes held and timed; routes "
        f"(f32, bf16) by shape: " + json.dumps({k: v["routes_f32_bf16"] for k, v in
                                                  zoo_conv.items()}))

    # `train` on gate_conv_net (every gated conv unfused) and on the CNN-only
    # head: -s 400 -b 300, ZOO_TRAIN_STEPS steps on phase 4's reads, the training
    # LSTM's launches counted (none for the head), the loss falling; then one
    # step at CPU_STEP_BATCH windows on the card against the CPU, as phase 4
    zoo_train = {}
    for name in ZOO_TRAIN:
        cfg_path = os.path.join(work, f"model_zoo_{name}", "model.json")
        cfg = C.read_config(cfg_path)
        t = time.time()
        for k in lstm_grad.launches:
            lstm_grad.launches[k] = 0
        result = cli.main(["train", "-i", train_dir, "-o", os.path.join(work, "log_zoo"), "-m",
                           name, "--configure", cfg_path, "-s", str(SEG), "-b", str(TRAIN_BATCH),
                           "-x", str(ZOO_TRAIN_STEPS), "-t", str(TRAIN_RATE), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t
        launches_t = dict(lstm_grad.launches)
        per_step = 6 if cfg["rnn"]["layer_num"] else 0
        with open(os.path.join(result["model_dir"], "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        log(f"train zoo {name} -s {SEG} -b {TRAIN_BATCH} -x {ZOO_TRAIN_STEPS}: {wall:.3f} s, "
            f"losses {losses}; launches {launches_t}")
        if any(n != per_step * ZOO_TRAIN_STEPS for n in launches_t.values()):
            fail(f"train zoo {name}: launches {launches_t}, expected "
                 f"{per_step * ZOO_TRAIN_STEPS} each")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"train zoo {name}: losses {losses} do not fall")
        z_tree, _ = restore_latest(os.path.join(work, f"model_zoo_{name}"))
        z_batch = loop.batch_to_device(dataset.next_batch(CPU_STEP_BATCH),
                                       M.model_ratio(cfg, SEG), torch.device("cpu"))

        def zoo_value_and_grad(device):
            m = from_jax_params(z_tree, cfg, device).requires_grad_(True)
            b = {k: v.to(device) for k, v in z_batch.items()}
            loss = ctc_focal_loss(m(b["signal"], b["seq_len"], training=True), b["seq_len"],
                                  b["label"], b["label_len"], float(cfg["fl_gamma"]))
            loss.backward()
            return float(loss.detach()), {k: p.grad.cpu() for k, p in m.flat.items()}

        loss_g, grads_g = zoo_value_and_grad("cuda")
        loss_c, grads_c = zoo_value_and_grad("cpu")
        top = max(float(g.abs().max()) for g in grads_c.values())
        ratio = max(float((grads_g[k] - g).abs().max())
                    / (1e-2 * float(g.abs().max()) + 1e-4 * top) for k, g in grads_c.items())
        hold(f"train zoo {name} step loss card vs CPU ({CPU_STEP_BATCH} windows, relative)",
             abs(loss_g - loss_c) / abs(loss_c), 1e-4, f"(loss {loss_c:.4f}) ")
        hold(f"train zoo {name} step gradients card vs CPU (worst leaf: err / (1e-2 own max + "
             f"1e-4 top))", ratio, 1.0, f"(largest |grad| {top:.3e}) ")
        zoo_train[name] = {"seconds": wall, "losses": losses, "launches": launches_t,
                           "loss_card": loss_g, "loss_cpu": loss_c, "grad_ratio": ratio}
    if failures:
        fail(f"a zoo train step on the card disagrees with the CPU: {failures}")
    log(json.dumps({"cnn_zoo": {"models": zoo_rows, "train": zoo_train,
                                "conv_bn_shapes": len(zoo_conv)}}))
    log(f"phase 7 took {time.time() - t7:.1f} s")

    # ---- 8. serving and the training sources --------------------------------
    phase("8. serving and the training sources")
    t8 = time.time()
    serving = serve_and_train_sources(torch, work, out_dir, sig_dir, train_dir, gpu_model,
                                      steps["float32"]["logits_g"], reset, counts,
                                      check_counts, smi)
    log(json.dumps({"serving": serving}))
    log(f"phase 8 took {time.time() - t8:.1f} s")

    # ---- 9. multi-GPU: the data-parallel paths on the one card ------------------
    phase("9. multi-GPU")
    t9 = time.time()
    multi = multi_gpu(torch, work, gpu_model, tree, config, (xg, slg), lb,
                      steps["float32"]["step_g"], train_dir, reset, counts, check_counts, smi)
    log(json.dumps({"multi_gpu": multi}))
    log(f"phase 9 took {time.time() - t9:.1f} s")

    # ---- 10. the model tools: net2wide, the recipe, grid_search, mfu ------------
    phase("10. model tools")
    t10 = time.time()
    rna_gpu, rna_batch, rna_lb = model_steps["RNA_default"]
    tools, tool_launches = model_tools(
        torch, work, out_dir, sig_dir, train_dir, (gpu_model, (xg, slg), lb),
        (rna_gpu, rna_batch["float32"][:2], rna_lb), reset, counts, check_counts, smi,
        bench_line, timing["bilstm"][0])
    for k in kernels:  # the kernel line's counts take in the tools' runs
        k["launches"] += tool_launches.get(k["name"], 0)
    log(json.dumps({"model_tools": tools, "model_tools_launches": tool_launches}))
    log(f"phase 10 took {time.time() - t10:.1f} s")

    # ---- 11. the last modules: mc / section / attention decoders, native host code --
    phase("11. the last modules")
    t11 = time.time()
    last, last_launches = last_modules(torch, work, sig_dir, gpu_model, (xg, slg),
                                       steps["float32"]["step_g"], reset, counts,
                                       check_counts, smi)
    for k in kernels:  # the kernel line's counts take in phase 11's runs
        k["launches"] += last_launches.get(k["name"], 0)
    log(json.dumps({"last_modules": last, "last_modules_launches": last_launches}))
    log(f"phase 11 took {time.time() - t11:.1f} s")

    # ---- 12. Bonito's HAC CRF model: the stem's swish convs, the CRF kernels ----
    phase("12. Bonito's HAC CRF model")
    t12 = time.time()
    hac, hac_kernels = crf_model(torch, work, reset, counts, check_counts, smi)
    kernels += hac_kernels
    log(json.dumps({"bonito_hac": hac}))
    log(f"phase 12 took {time.time() - t12:.1f} s")
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
