"""Run one cell of the benchmark of chiron_tpu_torch and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One run is one process: it makes its inputs
from the seed, sets up the program (building its kernels in
``chiron_tpu_torch/_build`` the first time), warms the cell's shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line last on standard output. With
``--trace 1`` the window is profiled and the line holds the cell's
per-layer metrics instead of its end-to-end ones. The run needs the cards
the cell asks for: without them it prints no result and exits with 2. It
exits with 3, printing no result, if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    from benchmark.harness import ROOT

    base = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def bytes_written() -> str:
    """What this process wrote: to storage (``write_bytes``) and through every
    write call, sockets included (``wchar``), from /proc/self/io."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        return f"{int(io['write_bytes'])} to storage, {int(io['wchar'])} in all"
    except (OSError, KeyError, ValueError):
        return "not readable here"


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from benchmark import harness as H

    bench = H.manifest()
    cell = H.cell(args.workload, bench)
    cfg = H.config(cell["config"], bench)
    mix = H.traffic(cell["traffic"])
    lims = H.limits(cell["name"])
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = H.Context(cell=cell, config=cfg, traffic=mix, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace), workdir=workdir, t0=T0,
                        device=torch.device("cuda", 0))
        with contextlib.redirect_stdout(sys.stderr):  # the program's prints
            outcome = H.runner(mix["runner"]).run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct = outcome.failed == 0 and H.judge(outcome.numbers, lims)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    per_layer = breakdown = None
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if args.trace:
        data = outcome.trace
        device["busy_s"] = data.busy_s
        device["window_s"] = data.window_s
        rctx = H.ReaderContext(cell=cell, config=cfg, traffic=mix, trace=data,
                               work=outcome.work)
        per_layer = {}
        for m in H.per_layer_of(bench, cell["name"]):
            value = H.reader(m["name"]).read(rctx)
            if value is not None:
                per_layer[m["name"]] = value
        breakdown = {"device_ops": [[n, s] for n, s in data.device_ops],
                     "idle_gaps": [[n, s] for n, s in data.idle_gaps]}
    bad = H.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"bytes written by the run: {bytes_written()}", file=sys.stderr)
    for k, v in outcome.numbers.items():
        print(f"{k} {v!r} limit {lims.get(k)!r}", file=sys.stderr)
    print(H.result_line(correct, outcome, per_layer, units, device, lims, breakdown))
    return 0


if __name__ == "__main__":
    sys.exit(main())
