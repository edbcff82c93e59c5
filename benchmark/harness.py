"""What every cell's run shares: the manifest, the files a cell names, the
context a runner runs in, the per-layer readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds each by its name: the configuration's ``file`` in the
manifest, ``benchmark/configs/<name>.json`` (the model: its weights, front,
widths and the launches of its layers),
``benchmark/traffic/<traffic>.json`` (the mix: which runner runs it,
``benchmark/runners/<runner>.py``, and its parameters) and
``benchmark/limits/<cell>.json`` (the limit of each number that decides
``correct``). A per-layer metric is ``benchmark/metrics/<metric>.py``, whose
``read(ctx)`` returns the value or None where it finds nothing to read. A
later change adds a configuration, a mix, a cell or a metric by adding
files and manifest entries, without editing any of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# modules of JAX and of the JAX package: none may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "chiron_tpu")


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: Optional[Dict] = None) -> Dict:
    """The configuration the manifest names ``name``, from its ``file``."""
    bench = bench or manifest()
    entry = next((c for c in bench["configs"] if c["name"] == name), None)
    if entry is None:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
    return config_file(entry["file"])


def config_file(path: str) -> Dict:
    """A configuration file (a path from the checkout's root)."""
    return load_json(ROOT, path)


def traffic(name: str) -> Dict:
    return load_json(BENCH, "traffic", name + ".json")


def limits(cell_name: str) -> Dict[str, float]:
    return load_json(BENCH, "limits", cell_name + ".json")


def runner(name: str):
    return importlib.import_module(f"benchmark.runners.{name}")


def reader(metric: str):
    """The reader module of a per-layer metric (file name = metric name)."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_of(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics a cell reports: those that list it, and those
    that list no cells."""
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_of(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics read in a cell: those that list it."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


@dataclass
class Context:
    """What a runner is given: the cell, its configuration and mix, the run's
    arguments, a scratch directory and the process's start time."""
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    workdir: str
    t0: float
    device: Any = None


def model_dir(ctx: "Context") -> str:
    """The run's model directory (``<workdir>/model``), written on first use
    from the configuration's weights; the configuration's ``model_dir``."""
    from benchmark import weights

    path = os.path.join(ctx.workdir, "model")
    if not os.path.isfile(os.path.join(path, "checkpoint")):
        weights.write_model_dir(ctx.config, path)
    ctx.config["model_dir"] = path
    return path


@dataclass
class Outcome:
    """What a runner returns: end-to-end values (by metric name), the counts,
    the compared numbers, the device memory peak, the traced window and the
    work done in it (for the per-layer readers)."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int
    trace: Any = None
    work: Dict[str, float] = field(default_factory=dict)


def sync(device) -> None:
    import torch

    if getattr(device, "type", "") == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if getattr(device, "type", "") == "cuda" \
        else 0


@dataclass
class ReaderContext:
    """What a per-layer reader reads."""
    cell: Dict
    config: Dict
    traffic: Dict
    trace: Any
    work: Dict[str, float]


def judge(numbers: Dict[str, float], lims: Dict[str, float]) -> bool:
    """Every compared number within its limit (a missing limit fails)."""
    return bool(numbers) and all(k in lims and math.isfinite(v) and v <= lims[k]
                                 for k, v in numbers.items())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``chiron_tpu_torch`` is not ``chiron_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def result_line(correct: bool, outcome: Outcome, per_layer: Optional[Dict[str, float]],
                units: Dict[str, str], device: Dict, lims: Dict[str, float],
                breakdown: Optional[Dict] = None) -> str:
    metrics = per_layer if per_layer is not None else outcome.metrics
    out = {"correct": bool(correct), "attempted": int(outcome.attempted),
           "failed": int(outcome.failed),
           "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": float(v) if math.isfinite(v) else None,
                           "limit": lims.get(k)} for k, v in outcome.numbers.items()}
    return json.dumps(out)
