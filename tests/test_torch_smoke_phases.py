"""chip_smoke.py's phases and selector, and the one nvcc command line, on the CPU.

chip_smoke.py runs on the card; here it is only imported and its argument
parsing run, which comes before any card work. Its phases share one context
(``Smoke``); every input a phase takes from it is a name the context defines.
"""

import ast
import os
import subprocess
import sys

import pytest

import chip_smoke
from chiron_tpu_torch.ops import cuda_build
from test_torch_cuda import BF16_CONV_CASES, CONV_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["build", "kernels", "call", "train", "timing", "bench", "zoo", "serving", "multi_gpu",
         "model_tools", "last_modules", "bonito_hac"]


def test_phases_are_one_function_each_in_order():
    numbers = [n for n, _, _ in chip_smoke.PHASES]
    names = [name for _, name, _ in chip_smoke.PHASES]
    functions = [fn for _, _, fn in chip_smoke.PHASES]
    assert numbers == list(range(1, 13)) and names == NAMES
    assert len(set(functions)) == 12 and all(callable(fn) and fn.__doc__ for fn in functions)
    assert [fn.__name__ for fn in functions] == [f"phase_{name}" for name in NAMES]


@pytest.mark.parametrize("text,want", [("3,12", [3, 12]), ("bonito_hac", [12]),
                                       ("12,call", [3, 12]), (" 1 , kernels", [1, 2]),
                                       ("model_tools,11,11", [10, 11])])
def test_phases_select_by_number_and_name(text, want):
    assert [n for n, _, _ in chip_smoke.parse_args(["--phases", text]).phases] == want


def test_no_selector_runs_every_phase():
    assert chip_smoke.parse_args([]).phases == list(chip_smoke.PHASES)


@pytest.mark.parametrize("text", ["13", "0", "bogus", ",", "3,x"])
def test_an_unknown_phase_exits_nonzero(text, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.parse_args(["--phases", text])
    assert e.value.code != 0 and "unknown phase" in capsys.readouterr().err


def test_an_unknown_phase_exits_before_the_card_is_asked_for():
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "13"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "unknown phase" in proc.stderr and "cuda" not in proc.stderr.lower()


def _ctx_attributes(tree):
    """What ``Smoke`` defines: its methods and properties, and what its
    __init__ assigns to self."""
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Smoke")
    names = {n.name for n in cls.body if isinstance(n, ast.FunctionDef)}
    init = next(n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    for n in ast.walk(init):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store) \
                and isinstance(n.value, ast.Name) and n.value.id == "self":
            names.add(n.attr)
    return names


def test_every_input_a_phase_asks_of_the_context_is_one_it_makes():
    with open(chip_smoke.__file__) as f:
        tree = ast.parse(f.read())
    made = _ctx_attributes(tree)
    functions = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.args.args and n.args.args[0].arg == "ctx"]
    assert {fn.__name__ for _, _, fn in chip_smoke.PHASES} <= {f.name for f in functions}
    asked = {(f.name, n.attr) for f in functions for n in ast.walk(f)
             if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
             and n.value.id == "ctx"}
    assert asked and not {(f, a) for f, a in asked if a not in made}
    assert {"sig_dir", "train_dir", "dna_batch", "dna_step", "beam30", "bench_line",
            "row2_ms"} <= made


def test_the_kernel_rows_count_launches_only_where_every_counting_phase_runs():
    """The phases that write ctx.launches or add to the kernel rows' counts are
    COUNTING_PHASES: a run that leaves one out prints its rows' launches as
    null (Smoke.counted) and marks its ok line partial."""
    with open(chip_smoke.__file__) as f:
        tree = ast.parse(f.read())
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def is_ctx_launches(n):
        return isinstance(n, ast.Attribute) and n.attr == "launches" \
            and isinstance(n.value, ast.Name) and n.value.id == "ctx"

    def writes(fn):
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "update" and is_ctx_launches(n.func.value):
                return True
            if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store) \
                    and is_ctx_launches(n.value):
                return True
            if isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Subscript) \
                    and isinstance(n.target.slice, ast.Constant) \
                    and n.target.slice.value == "launches":
                return True
        return False

    assert {n for n, _, fn in chip_smoke.PHASES if writes(defs[fn.__name__])} \
        == chip_smoke.COUNTING_PHASES
    assert chip_smoke.COUNTING_PHASES <= {n for n, _, _ in chip_smoke.parse_args([]).phases}
    assert not chip_smoke.COUNTING_PHASES <= {
        n for n, _, _ in chip_smoke.parse_args(["--phases", "timing"]).phases}


@pytest.mark.parametrize("cases", [CONV_CASES, BF16_CONV_CASES], ids=["float32", "bfloat16"])
def test_the_bundled_fronts_conv_shapes_are_held_on_the_card(cases):
    held = {(b, t, ci, co, k, s, n, r) for k, s, t, ci, co, n, r, b in cases}
    assert set(chip_smoke.BUNDLED_CONV_SHAPES.values()) <= held


def test_every_library_is_built_by_one_nvcc_command_line(monkeypatch, tmp_path):
    """The package's libraries (their flags, -Xptxas -v included, as they
    were) and the probe's, through cuda_build.build."""
    commands = []

    class Proc:
        def __init__(self, cmd, **kw):
            commands.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

        def wait(self):
            return 0

    monkeypatch.setattr(cuda_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", Proc)
    line = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    for name in cuda_build.SOURCES:
        cuda_build._finish_build(name, cuda_build._start_build(name, *cuda_build._source(name)))
        source, flags = {"bilstm_bf16": ("bilstm", ["-DLSTM_XW_BF16"])}.get(name, (name, []))
        tmp = os.path.join(str(tmp_path), f"lib{name}.so.{os.getpid()}.tmp")
        assert commands[-1] == line + flags + ["-o", tmp,
                                               os.path.join(cuda_build.CSRC, f"{source}.cu")]
        assert os.path.exists(os.path.join(str(tmp_path), f"lib{name}.so"))
    src = os.path.join(cuda_build.CSRC, "gru.cu")
    built = cuda_build.build({"gru_probe_phases": (src, ["-DGRU_PROBE"])})
    assert commands[-1][:len(line)] == line and commands[-1][-4:-2] == ["-DGRU_PROBE", "-o"]
    assert built == {"gru_probe_phases": os.path.join(str(tmp_path), "libgru_probe_phases.so")}
    with open(os.path.join(REPO, "chiron_tpu_torch", "tools", "kernel_probe.py")) as f:
        probe = f.read()
    assert "cuda_build.build(" in probe and "Popen" not in probe and "nvcc_path" not in probe
