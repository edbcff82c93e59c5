"""Where the kernels redesigned for Hopper spend their time, on one NVIDIA GPU.

    python -m chiron_tpu_torch.tools.kernel_probe [mma] [conv] [lstm] [beam] [bnlstm] [gru]
        [gru_baseline]

Builds ``csrc/conv_bn.cu``, ``csrc/lstm_grad.cu``, ``csrc/bilstm.cu``,
``csrc/beam.cu``, ``csrc/bnlstm.cu``, ``csrc/gru.cu`` and ``tools/gru_baseline.cu``
again with probe macros (the libraries the package uses are left alone) and
prints, as JSON lines, for the parts named on the command line
(all of them when none is named):

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
  cluster barrier;
- the same for the inference kernel (bilstm at B = 400, both directions, and
  lstm_layer at B = 400, H = 128): product, block barrier, gate stage and h
  exchange, out stores, cluster barrier; the one-direction layer at Bonito
  HAC's shape (T = 800, B = 400, H = 384) through the streamed instance (wh
  from L2) and through csrc/lstm_c16.cu (``-DLSTM_C16_PROBE``: the product
  with the issue of the next step's xw loads, the gate stage and h stores,
  the barrier's arrive and the out stores, its wait); and for lstm_bwd's
  recurrence at
  T = 400, B = 300, H = 128 / 100 / 256: the gate gradients, the prefetch,
  the da exchange, the dxw stores, the cluster barrier, the product, the
  block barrier;
- the beam search (``-DBEAM_PROBE``) at B = T = 400, C = 5, ``length_bonus``
  0.6 on seeded random log-probabilities, at W = 30 (the warp kernel) and
  100 (the block kernel): the clocks per step that thread 0 of block 0 spends
  fetching lp (and, in the warp kernel, publishing the beams' hashes),
  computing the stay and extend values, matching the extends' hashes against
  the stays', merging and keying the candidates, selecting the top W, and
  updating the state and storing the trace;
- the BNLSTM recurrence (``-DBNLSTM_PROBE``) at T = B = 400, H = 128, both
  directions (bibnlstm_layer) and one (bnlstm_layer), on seeded inputs with
  chip_smoke's lengths: the clocks per step that thread 0 of block 0 spends
  in each phase, for the cooperative instance (the product,
  the BN_h tile moments, grid barrier 1, the BN_h combine and the gates, c'
  and its tile moments, grid barrier 2, the BN_c combine, h' and the
  stores) and for the cluster instance at the geometry ``ops/bnlstm.py``
  chooses (the start of the copies of xw[t], the wait for the peers' h, the
  product, the BN_h block moments, cluster barrier 1, the BN_h combine, the
  gates, c' and the BN_c block moments, cluster barrier 2, the BN_c combine,
  h' and the h copies; with two clusters a direction, the two combines'
  exchanges through device memory apart), with the device time of the
  xw-moments pre-pass and of the recurrence (torch.profiler); then every
  cluster geometry that fits the shape, fused, beside the cost model's
  clocks and the card's count of co-resident clusters;
- the GRU recurrence (``-DGRU_PROBE``) at T = B = 400 on seeded inputs with
  chip_smoke's lengths, fused (bigru_layer) and one direction (gru_layer):
  for ``gru_baseline``, the first port of the GRU kernel
  (``tools/gru_baseline.cu``, the yardstick the package no longer launches)
  at H = 128, the clocks per step that thread 0 of block 0 spends loading gx,
  in the gate product, storing r * h and u, in barrier 1, loading cx, in the
  candidate product, in the update and stores, and in barrier 2; then, built
  without the probe slots, its time beside the package's kernel (each
  instance) in turns; for ``gru``, ``csrc/gru.cu`` at H = 128 / 100 / 16 /
  200 / 256 / 384 / 512 with each instance that fits (the one
  ``ops/gru.py:geometry`` chooses marked): the gate product, the gates and
  r * h stores, barrier 1, the issue of the next step's loads, the candidate
  product, the update and stores, barrier 2.

Times are CUDA events over 10 launches after 2 warm-ups. The numbers on the
design choices in the sources' notes and in PERF.md come from this script.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from chiron_tpu_torch.ops import beam, bilstm, bnlstm, conv_bn, cuda_build, gru, lstm, lstm_grad

SEED = 0
TOOLS = os.path.dirname(os.path.abspath(__file__))
CONV_VARIANTS = {"shipped": [], "mma_loop_alone": ["-DCONV_PROBE_NO_STAGING"],
                 "staging_alone": ["-DCONV_PROBE_NO_MMA"],
                 "one_chain_over_k": ["-DCONV_PROBE_LONG_CHAINS"]}
LSTM_PHASES = ("product", "prefetch_start_and_block_barrier", "gate_stage_and_h_exchange",
               "xw_wait_arrive_and_residual_stores", "cluster_wait")
INFER_PHASES = ("product", "prefetch_start_and_block_barrier", "gate_stage_and_h_exchange",
                "xw_wait_arrive_and_out_stores", "cluster_wait")
C16_PHASES = ("product_and_xw_issue", "gate_stage_and_h_store", "arrive_and_out_stores",
              "cluster_wait")
# slots 8-14 of lstm_grad.cu's clocks
BEAM_PHASES = ("lp_fetch", "stay_and_extend", "hash_match", "merge_and_keys", "top_w",
               "state_update_and_trace_store")
PARTS = ("mma", "conv", "lstm", "beam", "bnlstm", "gru", "gru_baseline")
COOP_PHASES = ("product", "bn_h_tile_moments", "barrier_1", "bn_h_combine_and_gates",
               "c_and_tile_moments", "barrier_2", "bn_c_combine_h_and_stores")
# slots 8-15 of bnlstm.cu's clocks
CLUSTER_PHASES = ("product", "bn_h_block_moments", "cluster_barrier_1",
                  "bn_h_combine_gates_c_and_bn_c_block_moments", "cluster_barrier_2",
                  "bn_c_combine_h_and_h_copies", "wait_for_peers_h", "xw_copy_start")
# slots 16-19: with a direction over several clusters, the parts of the two
# combines above spent on the cluster's row groups and on the exchange
SPLIT_PHASES = ("bn_h_cluster_combine", "bn_h_exchange_between_clusters",
                "bn_c_cluster_combine", "bn_c_exchange_between_clusters")
BWD_PHASES = ("gate_gradients", "prefetch_start", "da_exchange", "arrive_and_dxw_stores",
              "cluster_wait", "product", "residual_wait_and_block_barrier")


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


def main(argv=None):
    parts = set(sys.argv[1:] if argv is None else argv) or set(PARTS)
    if parts - set(PARTS):
        sys.exit(f"kernel_probe: unknown parts {sorted(parts - set(PARTS))}; choose from {PARTS}")
    if not torch.cuda.is_available():
        sys.exit("kernel_probe needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    builds = {}
    if "conv" in parts:
        builds.update({("conv_bn", tag): _start_build("conv_bn", tag, flags)
                       for tag, flags in CONV_VARIANTS.items()})
    if "lstm" in parts:
        builds[("lstm_grad", "phases")] = _start_build("lstm_grad", "phases", ["-DLSTM_PROBE"])
        builds[("bilstm", "phases")] = _start_build("bilstm", "phases", ["-DLSTM_PROBE"])
        builds[("lstm_c16", "phases")] = _start_build("lstm_c16", "phases", ["-DLSTM_C16_PROBE"])
    if "beam" in parts:
        builds[("beam", "phases")] = _start_build("beam", "phases", ["-DBEAM_PROBE"])
    if "bnlstm" in parts:
        builds[("bnlstm", "phases")] = _start_build("bnlstm", "phases", ["-DBNLSTM_PROBE"])
    if "gru" in parts:
        builds[("gru", "phases")] = _start_build("gru", "phases", ["-DGRU_PROBE"])

    if "gru_baseline" in parts:
        builds[("gru_baseline", "phases")] = _start_build("gru_baseline", "phases",
                                                          ["-DGRU_PROBE"], TOOLS)
        builds[("gru_baseline", "timing")] = _start_build("gru_baseline", "timing", [], TOOLS)
    if "mma" in parts:
        builds[("mma_rate", "")] = _start_build("mma_rate", "", [], TOOLS)
    libs = {}
    for key, (out, proc) in builds.items():
        text = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {key}:\n{text}")
        libs[key] = ctypes.CDLL(out)

    if "mma" in parts:
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

    if "conv" in parts:
        c = 256
        for k, n_terms in ((3, 2), (3, 1), (1, 2)):
            terms = [(rnd(400, 400, c), rnd(c).abs() + 0.5, rnd(c, scale=0.2)) for _ in range(n_terms)]
            w = rnd(k, c, c, scale=(2 / ((k + 1) * c)) ** 0.5)
            py, ps, _ = conv_bn.conv_bn_plain(terms, w, True, 1)
            x64 = torch.relu(sum(r.double() * a.double() + b.double() for r, a, b in terms))
            y64 = conv_bn.conv1d(x64, w.double(), 1)
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

    if "lstm" in parts:
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
            clocks = (ctypes.c_longlong * 16)()
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
            res = lstm_grad.lstm_fwd_residuals(xw, wh, lens)
            dhs = rnd(t_max, bsz, h)
            lstm_grad.lstm_bwd(*res[1:], dhs, wh, lens)  # warm-up
            torch.cuda.synchronize()
            cuda_build.check(lib.lstm_probe_read(clocks), "lstm_probe_read")
            lstm_grad.lstm_bwd(*res[1:], dhs, wh, lens)
            torch.cuda.synchronize()
            cuda_build.check(lib.lstm_probe_read(clocks), "lstm_probe_read")
            print(json.dumps({
                "kernel": "lstm_bwd", "shape": f"T={t_max} B={bsz} H={h}",
                "cluster_rows_shared_bytes": lstm_grad.cluster_geometry("bwd", bsz, h),
                "ms_with_probe": _time_ms(lambda: lstm_grad.lstm_bwd(*res[1:], dhs, wh, lens), 5),
                "clocks_per_step": {name: round(clocks[8 + i] / t_max)
                                    for i, name in enumerate(BWD_PHASES)}}), flush=True)

        lib = libs[("bilstm", "phases")]
        bilstm._declare(lib)
        lib.infer_probe_read.argtypes = [ctypes.c_void_p]
        lib.infer_probe_read.restype = ctypes.c_int
        cuda_build._LIBS["bilstm"] = lib
        t_max, bsz, h = 400, 400, 128
        clocks = (ctypes.c_longlong * 8)()
        xw_f, xw_b = rnd(t_max, bsz, 4 * h), rnd(t_max, bsz, 4 * h)
        wh_f, wh_b = (rnd(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2) for _ in range(2))
        lens = torch.full((bsz,), t_max, dtype=torch.int32, device=dev)
        starts = torch.zeros_like(lens)
        cases = {"bilstm": (2, lambda: bilstm.bilstm_layer(xw_f, xw_b, wh_f, wh_b, lens, starts)),
                 "lstm_layer": (1, lambda: lstm.lstm_layer(xw_f, wh_f, lens))}
        for name, (dirs, fn) in cases.items():
            fn()  # warm-up
            torch.cuda.synchronize()
            cuda_build.check(lib.infer_probe_read(clocks), "infer_probe_read")
            fn()
            torch.cuda.synchronize()
            cuda_build.check(lib.infer_probe_read(clocks), "infer_probe_read")
            print(json.dumps({
                "kernel": name, "shape": f"T={t_max} B={bsz} H={h}",
                "cluster_rows_shared_bytes": lstm_grad.cluster_geometry("infer", bsz, h, dirs),
                "ms_with_probe": _time_ms(fn, 5),
                "clocks_per_step": {n: round(clocks[i] / t_max)
                                    for i, n in enumerate(INFER_PHASES)}}), flush=True)
        probe_hac_lstm(lib, libs[("lstm_c16", "phases")], rnd, dev)

    if "beam" in parts:
        lib = libs[("beam", "phases")]
        beam._declare(lib)
        lib.beam_probe_read.argtypes = [ctypes.c_void_p]
        lib.beam_probe_read.restype = ctypes.c_int
        cuda_build._LIBS["beam"] = lib
        t_max, bsz, ncls = 400, 400, 5
        clocks = (ctypes.c_longlong * 8)()
        lp = torch.log_softmax(rnd(bsz, t_max, ncls, scale=2.0), -1)
        lens = torch.full((bsz,), t_max, dtype=torch.int32, device=dev)
        for width in (30, 100):
            def fn():
                return beam.beam_search(lp, lens, width, 0.6)
            fn()  # warm-up
            torch.cuda.synchronize()
            cuda_build.check(lib.beam_probe_read(clocks), "beam_probe_read")
            fn()
            torch.cuda.synchronize()
            cuda_build.check(lib.beam_probe_read(clocks), "beam_probe_read")
            print(json.dumps({
                "kernel": "beam_search", "shape": f"T={t_max} B={bsz} C={ncls} W={width}",
                "ms_with_probe": _time_ms(fn, 5),
                "clocks_per_step": {n: round(clocks[i] / t_max)
                                    for i, n in enumerate(BEAM_PHASES)}}), flush=True)

    if "bnlstm" in parts:
        _probe_bnlstm(libs[("bnlstm", "phases")], rnd, dev)
    if "gru_baseline" in parts:
        _probe_gru_baseline(libs[("gru_baseline", "phases")], libs[("gru_baseline", "timing")],
                            rnd, dev)
    if "gru" in parts:
        _probe_gru(libs[("gru", "phases")], rnd, dev)


def probe_hac_lstm(streamed_lib, c16_lib, rnd, dev, t_max=800, bsz=400, h=384):
    """The one-direction LSTM at Bonito HAC's shape (T = 800, B = 400, H = 384,
    float32, full rows) through both routes that hold it: the streamed
    instance of csrc/bilstm.cu (wh from L2; ``streamed_lib`` built with
    -DLSTM_PROBE) and csrc/lstm_c16.cu (``c16_lib`` built with
    -DLSTM_C16_PROBE). Prints each one's clocks a step by phase and its
    time."""
    streamed_lib.infer_probe_read.argtypes = [ctypes.c_void_p]
    streamed_lib.infer_probe_read.restype = ctypes.c_int
    xw = rnd(t_max, bsz, 4 * h)
    wh = rnd(h, 4 * h, scale=(6 / (5 * h)) ** 0.5 / 2)
    lens = torch.full((bsz,), t_max, dtype=torch.int32, device=dev)
    clocks = (ctypes.c_longlong * 8)()
    saved = dict(cuda_build._LIBS)
    cases = [("streamed", "bilstm", streamed_lib, streamed_lib.infer_probe_read, INFER_PHASES),
             ("cluster16", "lstm_c16", c16_lib, None, C16_PHASES)]
    try:
        for name, lib_name, lib, read, phases in cases:
            if read is None:
                lstm._declare(lib)
                lib.c16_probe_read.argtypes = [ctypes.c_void_p]
                lib.c16_probe_read.restype = ctypes.c_int
                read = lib.c16_probe_read
            else:
                bilstm._declare(lib)
            cuda_build._LIBS[lib_name] = lib

            def fn():
                return lstm._launch(xw, wh, lens, None, name)
            fn()  # warm-up
            torch.cuda.synchronize()
            cuda_build.check(read(clocks), "probe_read")
            fn()
            torch.cuda.synchronize()
            cuda_build.check(read(clocks), "probe_read")
            geometry = (lstm.c16_geometry(bsz, lstm.c16_clusters(dev)) if name == "cluster16"
                        else lstm_grad.cluster_geometry("infer", bsz, h, 1))
            print(json.dumps({
                "kernel": f"lstm_layer ({name})", "shape": f"T={t_max} B={bsz} H={h}",
                "geometry": geometry, "c16_clusters": lstm.c16_clusters(dev),
                "ms_with_probe": _time_ms(fn, 3, 1),
                "clocks_per_step": {n: round(clocks[i] / t_max)
                                    for i, n in enumerate(phases)}}), flush=True)
    finally:
        cuda_build._LIBS.clear()
        cuda_build._LIBS.update(saved)


def _device_ms(fn, names, reps=3):
    """Device ms per call of the kernels whose names contain each of ``names``
    (torch.profiler; mean over the events it recorded)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                out[n] = out.get(n, 0.0) + ev.self_device_time_total / ev.count / 1e3
    return out


def _probe_bnlstm(lib, rnd, dev):
    bnlstm._declare(lib)
    lib.bnlstm_probe_read.argtypes = [ctypes.c_void_p]
    lib.bnlstm_probe_read.restype = ctypes.c_int
    cuda_build._LIBS["bnlstm"] = lib
    t_max, bsz, h = 400, 400, 128
    clocks = (ctypes.c_longlong * 24)()
    gen = torch.Generator().manual_seed(SEED + 1)
    lens = torch.randint(0, t_max + 1, (bsz,), generator=gen).to(torch.int32)
    lens[0], lens[1:9] = 0, t_max
    lens = lens.to(dev)
    ws = (6 / (5 * h)) ** 0.5

    def weights():
        return (rnd(h, 4 * h, scale=ws), rnd(4 * h, scale=0.1),
                0.1 + 0.2 * torch.rand(4 * h, generator=gen).to(dev),
                0.1 + 0.2 * torch.rand(4 * h, generator=gen).to(dev),
                0.1 + 0.2 * torch.rand(h, generator=gen).to(dev), rnd(h, scale=0.1))

    xws, ws_ = (rnd(t_max, bsz, 4 * h), rnd(t_max, bsz, 4 * h)), (weights(), weights())
    max_cluster, max_split = bnlstm.card_limits(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    coop = bnlstm.Geometry("cooperative", 1, -(-bsz // 8), 1, 8, 1, 512,
                           bnlstm.coop_smem_bytes(h, 8))
    phases_of = {"cooperative": (0, COOP_PHASES), "cluster": (8, CLUSTER_PHASES + SPLIT_PHASES)}
    for instance, geom in (("cooperative", coop),
                           ("cluster", bnlstm.geometry(bsz, h, 2, sms, max_cluster, max_split))):
        slots, phases = phases_of[instance]
        for name, dirs in (("bibnlstm_layer", 2), ("bnlstm_layer", 1)):
            entry = name.split("_")[0]

            def fn():
                return bnlstm._launch(entry, xws[:dirs], ws_[:dirs], lens, geom)
            fn()  # warm-up
            torch.cuda.synchronize()
            cuda_build.check(lib.bnlstm_probe_read(clocks), "bnlstm_probe_read")
            fn()
            torch.cuda.synchronize()
            cuda_build.check(lib.bnlstm_probe_read(clocks), "bnlstm_probe_read")
            print(json.dumps({
                "kernel": name, "instance": instance, "shape": f"T={t_max} B={bsz} H={h}",
                "geometry": geom._asdict(), "ms_with_probe": _time_ms(fn, 5),
                "device_ms": _device_ms(fn, ("bnlstm_xmoments_kernel", "bnlstm_kernel",
                                             "bnlstm_cluster_kernel")),
                "clocks_per_step": {n: round(clocks[slots + i] / t_max)
                                    for i, n in enumerate(phases)}}), flush=True)
    # every cluster geometry that fits this shape, fused, with the modelled cost
    # that chose among them and the card's count of co-resident clusters
    for cost, *shape in bnlstm.cluster_candidates(bsz, h, max_cluster, max_split):
        geom = bnlstm.Geometry("cluster", *shape)
        active = ctypes.c_int(0)
        cuda_build.check(lib.bnlstm_active_clusters(geom.cluster, geom.rows, geom.units,
                                                    geom.threads, geom.smem_bytes,
                                                    ctypes.byref(active)), "active_clusters")
        cuda_build.check(lib.bnlstm_probe_read(clocks), "bnlstm_probe_read")
        bnlstm._launch("bibnlstm", xws, ws_, lens, geom)
        torch.cuda.synchronize()
        cuda_build.check(lib.bnlstm_probe_read(clocks), "bnlstm_probe_read")
        print(json.dumps({
            "kernel": "bibnlstm_layer", "instance": "cluster", "shape": f"T={t_max} B={bsz} H={h}",
            "geometry": geom._asdict(), "modelled_clocks_per_step": cost,
            "co_resident_clusters": active.value,
            "clocks_per_step": {n: round(clocks[8 + i] / t_max)
                                for i, n in enumerate(CLUSTER_PHASES + SPLIT_PHASES)},
            "ms_with_probe": _time_ms(lambda: bnlstm._launch("bibnlstm", xws, ws_, lens, geom),
                                      3)}), flush=True)


GRU_BASELINE_PHASES = ("gx_load", "gate_product", "rh_and_u_stores", "barrier_1", "cx_load",
                  "candidate_product", "update_and_stores", "barrier_2")
# slots 8-14 of csrc/gru.cu's clocks
GRU_PHASES = ("gate_product", "gates_and_rh_stores", "barrier_1", "next_loads_issue",
              "candidate_product", "update_and_stores", "barrier_2")


class GruBaseline:
    """The first port of the GRU kernel (``tools/gru_baseline.cu``), the
    yardstick of ``csrc/gru.cu``: ``bigru`` and ``gru`` take the arguments of
    ``ops/gru.py:bigru_layer`` and ``gru_layer``; ``lib`` is its built
    library."""

    def __init__(self, lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.baseline_bigru_launch.argtypes = [vp] * 12 + [ci] * 3 + [vp]
        lib.baseline_bigru_launch.restype = ci
        lib.baseline_gru_launch.argtypes = [vp] * 7 + [ci] * 3 + [vp]
        lib.baseline_gru_launch.restype = ci
        self.lib = lib

    def bigru(self, gx_f, cx_f, gx_b, cx_b, wh_f, wh_b, lengths, starts_bw):
        t_max, bsz, h = cx_f.shape
        outs = [torch.empty_like(cx_f) for _ in range(2)]
        args = [gx_f, cx_f, gx_b, cx_b, *wh_f, *wh_b, lengths, starts_bw, *outs]
        cuda_build.check(self.lib.baseline_bigru_launch(
            *[a.contiguous().data_ptr() for a in args], t_max, bsz, h,
            torch.cuda.current_stream().cuda_stream), "baseline_bigru_launch")
        return outs

    def gru(self, gx, cx, whg, whc, lengths, starts=None):
        t_max, bsz, h = cx.shape
        out = torch.empty_like(cx)
        args = [gx, cx, whg, whc, lengths]
        cuda_build.check(self.lib.baseline_gru_launch(
            *[a.contiguous().data_ptr() for a in args],
            None if starts is None else starts.data_ptr(), out.data_ptr(), t_max, bsz, h,
            torch.cuda.current_stream().cuda_stream), "baseline_gru_launch")
        return out


def _gru_case(rnd, dev, bsz, h, t_max=400):
    """chip_smoke's GRU inputs at one shape: seeded lengths with an empty row
    and eight full ones, starts = T - lengths."""
    gen = torch.Generator().manual_seed(SEED + 2)
    lens = torch.randint(0, t_max + 1, (bsz,), generator=gen).to(torch.int32)
    lens[0], lens[1:9] = 0, t_max
    lens = lens.to(dev)
    ws = (6 / (5 * h)) ** 0.5 / 2
    gx_f, cx_f, gx_b, cx_b = (rnd(t_max, bsz, n) for n in (2 * h, h, 2 * h, h))
    wh_f, wh_b = ((rnd(h, 2 * h, scale=ws), rnd(h, h, scale=ws)) for _ in range(2))
    return (gx_f, cx_f, gx_b, cx_b, wh_f, wh_b), lens, (t_max - lens).to(torch.int32)


def _clock_row(lib, fn, clocks, t_max, slots, phases):
    fn()  # warm-up
    torch.cuda.synchronize()
    cuda_build.check(lib.gru_probe_read(clocks), "gru_probe_read")
    fn()
    torch.cuda.synchronize()
    cuda_build.check(lib.gru_probe_read(clocks), "gru_probe_read")
    per = {n: round(clocks[slots + i] / t_max) for i, n in enumerate(phases)}
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True).stdout.split()[0])
    return {"ms_with_probe": _time_ms(fn, 5), "sm_clock_mhz_after": mhz, "clocks_per_step": per,
            "clocks_per_step_total": sum(per.values())}


def _probe_gru_baseline(lib, timing_lib, rnd, dev):
    """The baseline kernel at T = B = 400, H = 128: clocks per phase of a
    step; then its time (built without the probe slots) beside the package's
    kernel, each instance, in turns (baseline, resident, streamed, streamed,
    resident, baseline), with the largest difference of each from the plain
    version."""
    lib.gru_probe_read.argtypes = [ctypes.c_void_p]
    lib.gru_probe_read.restype = ctypes.c_int
    base = GruBaseline(lib)
    args, lens, starts = _gru_case(rnd, dev, 400, 128)
    clocks = (ctypes.c_longlong * 16)()
    cases = {"bigru_layer": lambda: base.bigru(*args, lens, starts),
             "gru_layer": lambda: base.gru(args[2], args[3], *args[5], lens, starts)}
    for name, fn in cases.items():
        print(json.dumps({"kernel": f"{name} (the baseline kernel)", "shape": "T=400 B=400 H=128",
                          **_clock_row(lib, fn, clocks, 400, 0, GRU_BASELINE_PHASES)}), flush=True)
    timed = GruBaseline(timing_lib)
    layers = {"bigru_layer": ("bigru", args[0:4:2], args[1:4:2], args[4:]),
              "gru_layer": ("gru", (args[2],), (args[3],), (args[5],))}
    for name, (entry, gxs, cxs, whs) in layers.items():
        runs = {i: (lambda g: lambda: gru._launch(entry, gxs, cxs, whs, lens, starts, g))(
            gru.geometry(400, 128, len(cxs), i)) for i in gru.INSTANCES}
        if entry == "bigru":
            runs["baseline"] = lambda: timed.bigru(*args, lens, starts)
            want = gru.bigru_layer_plain(*args, lens, starts)
        else:
            runs["baseline"] = lambda: [timed.gru(args[2], args[3], *args[5], lens, starts)]
            want = [gru.gru_layer_plain(args[2], args[3], *args[5], lens, starts)]
        err = {k: max(float((a - b).abs().max()) for a, b in zip(fn(), want))
               for k, fn in runs.items()}
        ms = {}
        for which in ("baseline", "resident", "streamed", "streamed", "resident", "baseline"):
            ms.setdefault(which, []).append(_time_ms(runs[which], 5))
        print(json.dumps({"kernel": name, "shape": "T=400 B=400 H=128",
                          "ms_in_turns": ms, "max_abs_err_vs_plain": err}), flush=True)


def _probe_gru(lib, rnd, dev):
    """csrc/gru.cu at T = B = 400 and H = 128 / 100 / 16 / 200 / 256 / 384 /
    512, fused and one direction: clocks per phase of a step with each
    instance that fits (the chosen one marked)."""
    gru._declare(lib)
    lib.gru_probe_read.argtypes = [ctypes.c_void_p]
    lib.gru_probe_read.restype = ctypes.c_int
    cuda_build._LIBS["gru"] = lib
    clocks = (ctypes.c_longlong * 16)()
    for h in (128, 100, 16, 200, 256, 384, 512):
        args, lens, starts = _gru_case(rnd, dev, 400, h)
        for name, dirs in (("bigru_layer", 2), ("gru_layer", 1)):
            chosen = gru.geometry(400, h, dirs)
            for geom in (gru.geometry(400, h, dirs, i) for i in gru.instances(h)):
                def fn():
                    if dirs == 2:
                        return gru._launch("bigru", args[0:4:2], args[1:4:2], args[4:], lens,
                                           starts, geom)
                    return gru._launch("gru", (args[2],), (args[3],), (args[5],), lens, starts,
                                       geom)
                print(json.dumps({"kernel": name, "shape": f"T=400 B=400 H={h}",
                                  "geometry": geom._asdict(), "chosen": geom == chosen,
                                  **_clock_row(lib, fn, clocks, 400, 8, GRU_PHASES)}), flush=True)
        del args


if __name__ == "__main__":
    main()
