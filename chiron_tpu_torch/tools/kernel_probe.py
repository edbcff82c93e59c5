"""Where the two Hopper-specific kernels spend their time, on one NVIDIA GPU.

    python -m chiron_tpu_torch.tools.kernel_probe

Builds ``csrc/conv_bn.cu`` and ``csrc/lstm_grad.cu`` again with probe macros
(the libraries the package uses are left alone) and prints, as JSON lines:

- the start rate of ``mma.sync.m16n8k8`` TF32 (``tools/mma_rate.cu``: 20
  independent accumulator tiles a warp, nothing else in the loop), with 1 to 3
  blocks of 4 warps on every SM, and with 1 or 2 integer adds per MMA mixed
  in: clocks per MMA per SM quarter at the card's current SM clock, and the
  TFLOP/s that makes;
- conv_bn at dna_model1's shapes ([400, 400, 256] -> 256, k=3 and k=1): the
  kernel's time; the MMA loop alone (``-DCONV_PROBE_NO_STAGING``: no copies, no
  prologue, it multiplies what lies in shared memory) and the staging alone
  (``-DCONV_PROBE_NO_MMA``); and for the shipped kernel and for one MMA chain
  over all of K (``-DCONV_PROBE_LONG_CHAINS``) the error of y against a float64
  convolution: its maximum, and its mean along the sign of y (the drift
  towards zero that the tensor cores' truncating adds leave), beside the plain
  version's;
- lstm_fwd_residuals at T = 400, B = 300, H = 128 / 100 / 256
  (``-DLSTM_PROBE``): the clocks per step that thread 0 of block 0 spends in
  the product, the block barrier, the gate stage, the residual stores and the
  cluster barrier.

Times are CUDA events over 10 launches after 2 warm-ups. The numbers on the
design choices in the two sources' notes and in PERF.md come from this script.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from chiron_tpu_torch.ops import conv_bn, cuda_build, lstm_grad

SEED = 0
CONV_VARIANTS = {"shipped": [], "mma_loop_alone": ["-DCONV_PROBE_NO_STAGING"],
                 "staging_alone": ["-DCONV_PROBE_NO_MMA"],
                 "one_chain_over_k": ["-DCONV_PROBE_LONG_CHAINS"]}
LSTM_PHASES = ("product", "prefetch_start_and_block_barrier", "gate_stage_and_h_exchange",
               "xw_wait_arrive_and_residual_stores", "cluster_wait")


def _start_build(name, tag, flags, src_dir=cuda_build.CSRC):
    os.makedirs(cuda_build.BUILD, exist_ok=True)
    out = os.path.join(cuda_build.BUILD, f"lib{name}_probe_{tag}.so")
    cmd = [cuda_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", *flags, "-o", out,
           os.path.join(src_dir, f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _time_ms(fn, reps=10, warm=2):
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


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_probe needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    builds = {("conv_bn", tag): _start_build("conv_bn", tag, flags)
              for tag, flags in CONV_VARIANTS.items()}
    builds[("lstm_grad", "phases")] = _start_build("lstm_grad", "phases", ["-DLSTM_PROBE"])
    builds[("mma_rate", "")] = _start_build("mma_rate", "", [],
                                            os.path.dirname(os.path.abspath(__file__)))
    libs = {}
    for key, (out, proc) in builds.items():
        text = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {key}:\n{text}")
        libs[key] = ctypes.CDLL(out)

    rate = libs[("mma_rate", "")]
    rate.mma_rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rate.mma_rate_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((3 * sms * 128,), dtype=torch.float32, device=dev)
    iters = 5000
    for blocks_per_sm, extra in ((1, 0), (2, 0), (3, 0), (3, 4), (3, 8)):
        def launch():
            cuda_build.check(rate.mma_rate_launch(
                out.data_ptr(), iters, blocks_per_sm * sms, extra,
                torch.cuda.current_stream(dev).cuda_stream), "mma_rate")
        ms = _time_ms(launch, reps=3, warm=1)
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader,nounits"], capture_output=True,
                                   text=True).stdout.split()[0])
        mmas_per_quarter = blocks_per_sm * iters * 20  # one warp of each block per SM quarter
        print(json.dumps({
            "kernel": "mma_rate", "blocks_per_sm": blocks_per_sm,
            "integer_adds_per_mma": extra / 4, "ms": ms, "sm_clock_mhz_after": mhz,
            "clocks_per_mma_per_sm_quarter": ms * 1e-3 * mhz * 1e6 / mmas_per_quarter,
            "tflops_tf32": blocks_per_sm * sms * 4 * iters * 20 * 2048 / ms / 1e9}), flush=True)

    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    c = 256
    for k, n_terms in ((3, 2), (3, 1), (1, 2)):
        terms = [(rnd(400, 400, c), rnd(c).abs() + 0.5, rnd(c, scale=0.2)) for _ in range(n_terms)]
        w = rnd(k, c, c, scale=(2 / ((k + 1) * c)) ** 0.5)
        py, ps, _ = conv_bn.conv_bn_plain(terms, w, True, 1)
        x64 = torch.relu(sum(r.double() * a.double() + b.double() for r, a, b in terms))
        y64 = conv_bn.conv_same(x64, w.double(), 1)
        del x64
        s64 = y64.sum(dim=(0, 1))

        def errors(y, s):
            d = y.double() - y64
            return {"max_abs_err_vs_float64": float(d.abs().max()),
                    "mean_err_along_sign_of_y": float((d * torch.sign(y64)).mean()),
                    "sums_rel_err_vs_float64": float(((s.double() - s64).abs()
                                                      / s64.abs().clamp(min=1.0)).max())}

        row = {"kernel": "conv_bn", "shape": f"[400,400,{c}]->{c} k={k} terms={n_terms}",
               "plain": errors(py, ps)}
        for tag in CONV_VARIANTS:
            lib = libs[("conv_bn", tag)]
            conv_bn._declare(lib)
            cuda_build._LIBS["conv_bn"] = lib
            y, s, _ = conv_bn.conv_bn(terms, w, True, 1)
            torch.cuda.synchronize()
            row[tag] = {"ms": _time_ms(lambda: conv_bn.conv_bn(terms, w, True, 1))}
            if tag in ("shipped", "one_chain_over_k"):
                row[tag].update(errors(y, s))
        print(json.dumps(row), flush=True)
        del y64

    lib = libs[("lstm_grad", "phases")]
    lstm_grad._declare(lib)
    lib.lstm_probe_read.argtypes = [ctypes.c_void_p]
    lib.lstm_probe_read.restype = ctypes.c_int
    cuda_build._LIBS["lstm_grad"] = lib
    t_max, bsz = 400, 300
    for h in (128, 100, 256):
        xw = rnd(t_max, bsz, 4 * h)
        wh = rnd(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2)
        lens = torch.full((bsz,), t_max, dtype=torch.int32, device=dev)
        clocks = (ctypes.c_longlong * 8)()
        lstm_grad.lstm_fwd_residuals(xw, wh, lens)  # warm-up
        torch.cuda.synchronize()
        cuda_build.check(lib.lstm_probe_read(clocks), "lstm_probe_read")
        lstm_grad.lstm_fwd_residuals(xw, wh, lens)
        torch.cuda.synchronize()
        cuda_build.check(lib.lstm_probe_read(clocks), "lstm_probe_read")
        print(json.dumps({
            "kernel": "lstm_fwd_residuals", "shape": f"T={t_max} B={bsz} H={h}",
            "cluster_rows_shared_bytes": lstm_grad.fwd_geometry(bsz, h),
            "ms_with_probe": _time_ms(lambda: lstm_grad.lstm_fwd_residuals(xw, wh, lens), 5),
            "clocks_per_step": {name: round(clocks[i] / t_max)
                                for i, name in enumerate(LSTM_PHASES)}}), flush=True)


if __name__ == "__main__":
    main()
