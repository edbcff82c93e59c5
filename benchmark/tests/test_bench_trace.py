"""The trace reduction and every per-layer reader on a synthetic trace, and
the result line's keys, names and units."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from benchmark import harness as H
from benchmark import trace as T

MS = 1_000_000  # ns


def _synthetic(cell_name):
    """A window of 1 s with one batch's kernels of each layer, 0.25 s idle."""
    dev = [("void conv_bn_mma_kernel<__nv_bfloat16>(...)", 100 * MS, 300 * MS),
           ("moments_reduce_kernel", 300 * MS, 310 * MS),
           ("void lstm_infer_kernel<__nv_bfloat16, 13>(...)", 310 * MS, 700 * MS),
           ("void beam_warp_kernel<5>(...)", 700 * MS, 800 * MS),
           ("beam_traceback_kernel", 800 * MS, 810 * MS),
           ("Memcpy HtoD (Pageable -> Device)", 810 * MS, 850 * MS),
           ("void lstm_fwd_kernel<256>(...)", 850 * MS, 900 * MS)]
    samples = [(t * MS, ("ThreadPoolExecutor/eval/pipeline.py:_finalize_file",))
               for t in range(0, 100, 5)]
    samples += [(t * MS, ()) for t in range(900, 1000, 5)]
    return T.reduce_trace(0, 1000 * MS, dev, samples)


def test_reduce_trace():
    data = _synthetic("dna_default.call")
    assert data.window_s == pytest.approx(1.0)
    assert data.busy_s == pytest.approx(0.8)
    assert dict(data.idle_gaps) == pytest.approx(
        {"ThreadPoolExecutor/eval/pipeline.py:_finalize_file": 0.1, "(host idle)": 0.1})
    assert data.device_ops[0][0].startswith("void lstm_infer_kernel")
    assert data.seconds_of(("beam_warp_kernel", "beam_traceback_kernel")) == pytest.approx(0.11)


def test_union_merges_overlaps():
    total, merged = T.union_seconds([(0, 2), (1, 3), (5, 6)])
    assert total == 4 and merged == [(0, 3), (5, 6)]


WORK = {"dna_default.call": {"windows": 400.0, "batches": 1.0, "frames": 150000.0,
                             "frames_padded": 160000.0, "calls": 1.0},
        "dna_default.train": {"steps": 1.0, "windows": 400.0, "batches": 1.0,
                              "frames": 140000.0, "frames_padded": 160000.0}}


@pytest.mark.parametrize("cell_name", sorted(WORK))
def test_readers_on_a_synthetic_trace(cell_name):
    bench = H.manifest()
    cell = H.cell(cell_name, bench)
    ctx = H.ReaderContext(cell=cell, config=H.config(cell["config"], bench),
                          traffic=H.traffic(cell["traffic"]), trace=_synthetic(cell_name),
                          work=WORK[cell_name])
    metrics = H.per_layer_of(bench, cell_name)
    assert metrics
    for m in metrics:
        value = H.reader(m["name"]).read(ctx)
        assert value is not None, m["name"]
        assert 0.0 < value <= 100.0, (m["name"], value)
    idle = [m for m in metrics if m["name"].endswith("idle_share")][0]
    assert H.reader(idle["name"]).read(ctx) == pytest.approx(20.0)
    empty = H.ReaderContext(cell=cell, config=ctx.config, traffic=ctx.traffic,
                            trace=T.reduce_trace(0, 1000 * MS, [], []), work=WORK[cell_name])
    for m in metrics:
        if "roofline" in m["name"]:
            assert H.reader(m["name"]).read(empty) is None  # no kernel ran: nothing, never 0


def test_result_line_keys_and_names():
    out = H.Outcome(metrics={"bases_per_s": 1.5, "setup_s": 2.0}, attempted=3, failed=0,
                    numbers={"window_edit": 0.01}, memory_peak_bytes=7)
    line = H.result_line(True, out, None, {"bases_per_s": "bases/s", "setup_s": "s"},
                         {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 7},
                         {"window_edit": 0.02})
    doc = json.loads(line)
    assert list(doc)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(doc)[-1] == "compared"
    assert doc["compared"]["window_edit"] == {"value": 0.01, "limit": 0.02}
    for name, m in doc["metrics"].items():
        assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$", name)
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])


def test_judge():
    assert H.judge({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0})
    assert not H.judge({"a": 0.3}, {"a": 0.2})
    assert not H.judge({"a": 0.1}, {})
    assert not H.judge({}, {"a": 1})


def test_forbidden_modules_compares_whole_top_level_names():
    probe = ("import sys, types\n"
             "from benchmark import harness as H\n"
             "import chiron_tpu_torch\n"
             "assert H.forbidden_modules() == [], H.forbidden_modules()\n"
             "sys.modules['chiron_tpu.models'] = types.ModuleType('chiron_tpu.models')\n"
             "sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
             "print(H.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=H.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['chiron_tpu', 'jaxlib']"


def test_the_harness_imports_no_jax():
    probe = ("import sys\n"
             "from benchmark import harness as H, run, control, trace, reads\n"
             "from benchmark.runners import call, train\n"
             "from benchmark.reference import model, beam, assembly, compare, signal\n"
             "import chiron_tpu_torch.cli, chiron_tpu_torch.train.loop\n"
             "print(H.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=H.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_no_result(tmp_path):
    """Run from a directory that holds only BENCHMARK.json and the benchmark:
    it exits with another code than 0 and prints no result line."""
    import shutil

    shutil.copytree(H.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(H.ROOT + "/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "dna_default.call", "--seed", str(2**31 + 3), "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
