"""BENCHMARK.json against the rules of its format, and the harness finding a
cell's files by their names: a new configuration, mix, cell and per-layer
metric come as new files and manifest entries alone."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return H.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) for p in bench["paths"])
    assert len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(H.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(H.ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_every_cell_is_whole(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        reported = {m["name"] for m in H.end_to_end_of(bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = H.per_layer_of(bench, w["name"])
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in reported and m["moves"] in e2e
            assert os.path.isfile(os.path.join(H.BENCH, "metrics", m["name"] + ".py"))
        mix = H.traffic(w["traffic"])
        assert os.path.isfile(os.path.join(H.BENCH, "runners", mix["runner"] + ".py"))
        lims = H.limits(w["name"])
        assert lims and all(v >= 0 for v in lims.values())
        H.config(w["config"], bench)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a cell, its limits and
    a per-layer metric as files and entries, and let that copy's harness find
    them; no file of the copy is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(H.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = H.manifest()
    shutil.copy(root / "benchmark" / "configs" / "dna_default.json",
                root / "benchmark" / "configs" / "dna_wide.json")
    (root / "benchmark" / "traffic" / "short_reads.json").write_text(json.dumps(
        dict(H.traffic("dna_fast_reads"), reads={"n_reads": 4, "median_bases": 1000,
                                                  "sigma": 0.5, "min_bases": 500,
                                                  "max_bases": 2000})))
    (root / "benchmark" / "limits" / "dna_wide.short.json").write_text('{"window_edit": 0.1}')
    (root / "benchmark" / "metrics" / "call.new_share.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.trace is not None else None\n")
    bench["configs"].append(dict(bench["configs"][0], name="DNA_wide",
                                 file="benchmark/configs/dna_wide.json"))
    bench["workloads"].append({"name": "dna_wide.short", "config": "DNA_wide",
                               "traffic": "short_reads", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "call.new_share", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "bases_per_s", "workloads": ["dna_wide.short"]})
    bench["end_to_end"][0]["workloads"].append("dna_wide.short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json\n"
        "from benchmark import harness as H\n"
        "b = H.manifest()\n"
        "w = H.cell('dna_wide.short', b)\n"
        "cfg = H.config(w['config'], b)\n"
        "mix = H.traffic(w['traffic'])\n"
        "names = [m['name'] for m in H.per_layer_of(b, w['name'])]\n"
        "ctx = H.ReaderContext(cell=w, config=cfg, traffic=mix, trace=object(), work={})\n"
        "print(json.dumps({'runner': H.runner(mix['runner']).__name__, 'names': names,\n"
        "                  'limits': H.limits(w['name']), 'value': H.reader('call.new_share')"
        ".read(ctx), 'e2e': [m['name'] for m in H.end_to_end_of(b, w['name'])]}))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["runner"] == "benchmark.runners.call"
    assert got["names"][-1] == "call.new_share" and got["value"] == 42.0
    assert got["limits"] == {"window_edit": 0.1}
    assert "bases_per_s" in got["e2e"] and "setup_s" in got["e2e"]
    for p, data in before.items():
        assert p.read_bytes() == data, p
