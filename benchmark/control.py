"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ... [--seconds 1]
        [--no-program] [--no-control] [--fault <name>]

For each seed, in one process: the program's run of the cell, with a short
window (its compared numbers are the lower readings), and the control, the
plain reference computed in the traffic mix's ``control_precision`` (the
nearest precision below the one the cell states) put in the program's
place, judged as a run is (the upper readings). ``--fault`` plants one of
``benchmark/faults.py``'s faults under the program's run (a training cell's
numbers are held against its faults too). One JSON line a seed and side.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--no-program", dest="program", action="store_false")
    p.add_argument("--no-control", dest="control", action="store_false")
    p.add_argument("--fault", default=None, help="a fault of benchmark/faults.py to plant")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    from benchmark import faults
    from benchmark import harness as H

    bench = H.manifest()
    cell = H.cell(args.workload, bench)
    cfg = H.config(cell["config"], bench)
    mix = H.traffic(cell["traffic"])
    import torch

    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    drv = H.runner(mix["runner"])
    sides = [s for s, on in (("program", args.program), ("control", args.control)) if on]
    for seed in args.seeds:
        for side in sides:
            work = tempfile.mkdtemp(prefix="bench_control_")
            patch = faults.Patch()
            try:
                ctx = H.Context(cell=cell, config=cfg, traffic=mix, seed=seed,
                                seconds=args.seconds, trace=False, workdir=work,
                                t0=time.time(), device=torch.device("cuda", 0))
                t = time.time()
                with contextlib.redirect_stdout(sys.stderr):
                    if side == "program":
                        if args.fault:
                            faults.plant(mix["runner"], args.fault, patch)
                        numbers = drv.run(ctx).numbers
                    else:
                        numbers = drv.control(ctx, mix["control_precision"])
            finally:
                patch.undo()
                shutil.rmtree(work, ignore_errors=True)
            print(json.dumps({"workload": cell["name"], "seed": seed, "side": side,
                              "fault": args.fault if side == "program" else None,
                              "precision": mix["control_precision"] if side == "control"
                              else mix["precision"], "seconds": time.time() - t,
                              "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
