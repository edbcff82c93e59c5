#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (chiron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build every CUDA kernel from
     chiron_tpu_torch/csrc (one nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version ON THE CARD at the
     main path's shapes (dna-pre: batch 400, window 400, DNA_default), with
     TF32 off for every float32 matmul and convolution;
  3. drive the port's `call` entry point with -p dna-pre and the bundled
     DNA_default weights on seeded .signal reads (2-3 full batches), at beam
     30 and at beam 0, with every launch count set to 0 just before each run
     and read just after; check the fastq output, and check one full batch's
     step outputs on the card against the same step on the CPU;
  4. time each kernel, its plain version and a PyTorch library yardstick
     with CUDA events after a warm-up, and the whole call in bases/s;
  5. print the per-kernel JSON line, then {"ok": true, "device": ...}.
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
# H100 SXM published peaks: float32 outside the tensor cores, HBM3 rate
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
BATCH, SEG, JUMP, BEAM = 400, 400, 390, 30


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    from chiron_tpu_torch import cli
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.ops import beam, bilstm, conv_bn, cuda_build
    from chiron_tpu_torch.params import from_jax_params
    from chiron_tpu_torch.train.checkpoint import restore_latest

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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 2. each kernel against its plain version on the card -------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    failures = []

    def hold(name, err, tol, extra=""):
        ok = err <= tol
        log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e}) {extra}"
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        return err

    # conv_bn at dna_model1's shapes: residual conv2b (k=3, two deferred terms,
    # relu) and res1's first-layer convs (k=1, C_in=1); and rna_model2's front
    # (k=9 stride 5, C_in=1) at the rna-pre batch [300, 2000]
    c = 256
    conv_cases = {
        "k3_two_terms_relu": ([(rnd(BATCH, SEG, c), rnd(c).abs() + 0.5, rnd(c, scale=0.2))
                               for _ in range(2)], rnd(3, c, c, scale=(2 / (4 * c)) ** 0.5), True, 1),
        "k1_cin1": ([(rnd(BATCH, SEG, 1), torch.ones(1, device=dev), torch.zeros(1, device=dev))],
                    rnd(1, 1, c, scale=(2 / (1 + c)) ** 0.5), False, 1),
        "k9_stride5_cin1": ([(rnd(300, 2000, 1), torch.ones(1, device=dev),
                              torch.zeros(1, device=dev))],
                            rnd(9, 1, c, scale=(2 / (9 + c)) ** 0.5), False, 5),
    }
    conv_err = 0.0
    for case, (terms, w, relu, stride) in conv_cases.items():
        y, s, q = conv_bn.conv_bn(terms, w, relu, stride)
        py, ps, pq = conv_bn.conv_bn_plain(terms, w, relu, stride)
        torch.cuda.synchronize()
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
        conv_bn.launches = 0
        bilstm.launches = 0
        for k in beam.launches:
            beam.launches[k] = 0

    def counts():
        return {"conv_bn": conv_bn.launches, "bilstm": bilstm.launches, **beam.launches}

    def call(out, beam_width):
        args = ["call", "-i", sig_dir, "-o", out, "-p", "dna-pre", "--sig_norm", "1",
                "--beam", str(beam_width), "--device", "cuda"]
        t = time.time()
        res = cli.main(args)
        torch.cuda.synchronize()
        return res, time.time() - t

    runs = {}
    for label, width in (("beam30", BEAM), ("beam0", 0)):
        reset()
        res, wall = call(os.path.join(work, f"out_{label}"), width)
        cnt = counts()
        runs[label] = (res, wall, cnt)
        log(f"call -p dna-pre --beam {width}: {res['total_windows']} windows, "
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
    beam_counts = runs["beam30"][2]
    for k, n in expect.items():
        if beam_counts[k] != n:
            fail(f"beam-30 run launched {k} {beam_counts[k]} times, expected {n}")
    greedy_counts = runs["beam0"][2]
    if greedy_counts["conv_bn"] != expect["conv_bn"] or greedy_counts["bilstm"] != expect["bilstm"] \
            or greedy_counts["beam_search"] or greedy_counts["beam_traceback"]:
        fail(f"beam-0 run launches {greedy_counts}, expected conv/bilstm only")

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
    logits_c = cpu_model(xc, slc)
    logit_err = float((gpu_model(xg, slg).cpu() - logits_c).abs().max())
    # relative to the logits' scale: 12 batch-stat convs and 3 BiLSTM layers
    # whose float32 sums run in another order on the card than on the CPU.
    # Two correct CPU implementations (the JAX package and the port) differ
    # by 2.6e-4 of max |logit| on this batch, so 5e-4 is the float32 floor.
    scale = float(logits_c.abs().max())
    hold("step logits card vs CPU (relative to max |logit|)", logit_err / scale, 5e-4,
         f"(max |logit| {scale:.2f}) ")
    step_g = pipeline.unpack_step_outputs(
        pipeline.decode_step(gpu_model, xg, slg, BEAM, lb).cpu().numpy())
    step_c = pipeline.unpack_step_outputs(
        pipeline.decode_step(cpu_model, xc, slc, BEAM, lb).numpy())
    same = [bool(step_g[1][i] == step_c[1][i]
                 and (step_g[0][i, :step_g[1][i]] == step_c[0][i, :step_c[1][i]]).all())
            for i in range(BATCH)]
    frac = sum(same) / BATCH
    log(f"  step decodes card vs CPU: {sum(same)}/{BATCH} windows identical "
        f"(must be >= 99%: float32 rounding may flip a near-tie beam)")
    if failures or frac < 0.99:
        fail(f"card step disagrees with the CPU step: {failures}, identical {frac:.4f}")

    # ---- 4. timing ----------------------------------------------------------
    # where one warm full-batch step's device time goes (CUDA events)
    from chiron_tpu_torch.models import layers as L, model as M, rnn as R

    front = M.CNN_ZOO[config["cnn"]["model"]][1]

    def step_parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.no_grad():
            ev[0].record()
            fea = L.materialize(front(gpu_model.params["cnn"], xg[..., None]))
            ev[1].record()
            logits = R.rnn_layers(gpu_model.params["rnn"], fea, slg)
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

    F = torch.nn.functional
    terms, w, relu, stride = conv_cases["k3_two_terms_relu"]
    z_ncw = torch.relu(sum(r * a + b for r, a, b in terms)).transpose(1, 2).contiguous()
    w_oik = w.permute(2, 1, 0).contiguous()
    timing = {
        "conv_bn": (time_ms(torch, lambda: conv_bn.conv_bn(terms, w, relu, stride), 10),
                    time_ms(torch, lambda: conv_bn.conv_bn_plain(terms, w, relu, stride), 10),
                    time_ms(torch, lambda: F.batch_norm(F.conv1d(z_ncw, w_oik, padding=1),
                                                        None, None, training=True), 10)),
    }
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

    # bounds from this run's inputs (bytes: each input read once, each output
    # written once; operations: what these inputs need)
    cin = cout = c
    rows = BATCH * SEG
    conv_flops = 2.0 * rows * 3 * cin * cout
    conv_bytes = 4.0 * (2 * rows * cin + 4 * cin + 3 * cin * cout + rows * cout + 2 * cout)
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
    bounds = {"conv_bn": bound_ms(conv_flops, conv_bytes),
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
    }
    kernels = []
    for name, (source, replaces, err) in meta.items():
        ms, plain_ms, lib_ms = timing[name]
        b_ms, b_by = bounds[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": beam_counts[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms})
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound "
            f"{k['bound_ms']:.4f} by {k['bound_by']}, library {k['library_ms']})")
    shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"call_dna_pre_beam30": call_rate}))
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
