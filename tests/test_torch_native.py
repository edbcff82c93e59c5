"""The port's native host library (chiron_tpu_torch/native/*.cc, built by
ops/host_build.py) against the JAX package's native library and against
the port's own numpy paths, on seeded inputs: the .signal parser bit for
bit, the glue / stick assembler's counts and qualities and the global /
simple assemblers' displacements exactly, the resquiggle starts exactly and
DTW distances within 1e-6 relative; the build itself, also by two processes
at once; and a `call` that gives the same fastq with and without it.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from synth import make_training_dir, synth_read

import chiron_tpu.assembly.consensus as jcons
import chiron_tpu.io.signal as jsig
import chiron_tpu.tools.resquiggle as jrs
from chiron_tpu_torch import cli as tcli
from chiron_tpu_torch.assembly import consensus as tcons
from chiron_tpu_torch.io import signal as tsig
from chiron_tpu_torch.ops import host_build
from chiron_tpu_torch.tools import resquiggle as trs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: several test workers' torch
    thread pools competing for the cores made its CPU model runs ~20x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_lib():
    lib = jcons._load_native()
    if lib is None or jrs._load_native() is None or jsig._load_parse_lib() is None:
        pytest.skip("the JAX package's native library does not load here")
    return lib


def test_library_builds_with_gxx_here(tmp_path):
    path = host_build.build(str(tmp_path / "lib" / "libchiron_host.so"))
    lib = host_build.open_library(path)
    out = np.empty(4, np.float32)
    assert lib.chiron_parse_signal(b"1 -2 3.5\n", 9, out, 4) == 3
    assert out[:3].tolist() == [1.0, -2.0, 3.5]
    assert host_build.native_available()
    with host_build.numpy_paths():
        assert not host_build.native_available()
    assert host_build.native_available()


def test_two_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Both start with no library, both compile, each renames its own
    temporary file into place and loads a whole library."""
    target = str(tmp_path / "libchiron_host.so")
    script = textwrap.dedent(f"""
        import numpy as np
        from chiron_tpu_torch.ops import host_build
        lib = host_build.open_library(host_build.build({target!r}))
        out = np.empty(3, np.float32)
        assert lib.chiron_parse_signal(b"7 8 9", 5, out, 3) == 3 and out.tolist() == [7, 8, 9]
        print("loaded")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 and "loaded" in o for p, o in zip(procs, outs)), outs
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def _signal_text(kind, rng):
    n = 3000
    if kind == "int16":
        vals = [str(int(v)) for v in rng.randint(-32768, 32767, n)]
    elif kind == "float":
        vals = [repr(float(v)) for v in (rng.randn(n) * 100).astype(np.float32)]
    elif kind == "exponent":
        vals = [f"{v:.6e}" for v in rng.randn(n) * 1e4]
    else:  # mixed tokens, signs and whitespace, long digit runs
        pool = ["+12", "-0", "003", "1.", ".5", "-7.25e-3", "123456789012345678901", "42"]
        vals = [pool[i] for i in rng.randint(0, len(pool), n)]
    seps = [" ", "\n", "\t", "\r\n", "  "]
    return "".join(v + seps[rng.randint(len(seps))] for v in vals).encode()


@pytest.mark.parametrize("kind", ["int16", "float", "exponent", "mixed"])
def test_parse_signal_bit_for_bit(jax_lib, kind):
    raw = _signal_text(kind, np.random.RandomState(len(kind)))
    got = tsig.parse_signal_text(raw)
    want = jsig.parse_signal_text(raw)
    with host_build.numpy_paths():
        numpy_path = tsig.parse_signal_text(raw)
    assert got.dtype == want.dtype == numpy_path.dtype == np.float32
    assert got.tobytes() == numpy_path.tobytes()
    # the JAX package's native parser reads "-0" as +0.0; the port's as -0.0
    # (strtof's and numpy's value): the only bits where the two differ
    differ = got.view(np.uint32) != want.view(np.uint32)
    assert np.array_equal(got, want)
    assert np.all((got[differ] == 0) & np.signbit(got[differ]) & ~np.signbit(want[differ]))
    assert differ.any() == (kind == "mixed")


def test_read_signal_of_a_training_file_equal(tmp_path, jax_lib):
    make_training_dir(str(tmp_path), n_files=1, n_bases=120, seed=4)
    path = str(tmp_path / "read0.signal")
    for norm in (None, 0, 1):
        got = tsig.read_signal(path, norm)
        with host_build.numpy_paths():
            assert tsig.read_signal(path, norm).tobytes() == got.tobytes()
        assert jsig.read_signal(path, norm).tobytes() == got.tobytes()


def _window_reads(rng, n_windows, length=48, jump=44):
    """Overlapping windows of a random read, each with a few base errors, as
    a decoder gives them (lengths vary)."""
    genome = "".join("ACGT"[i] for i in rng.randint(0, 4, n_windows * jump + length))
    reads = []
    for w in range(n_windows):
        s = list(genome[w * jump: w * jump + length - rng.randint(0, 6)])
        for i in rng.randint(0, len(s), 3):
            s[i] = "ACGT"[rng.randint(4)]
        reads.append("".join(s))
    return reads


@pytest.mark.parametrize("kernel", ["glue", "stick"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_glue_counts_and_qualities_equal(jax_lib, kernel, seed):
    rng = np.random.RandomState(seed)
    reads = _window_reads(rng, 25)
    qs_list = [np.float32([v]) for v in rng.rand(len(reads))]
    got = tcons.simple_assembly_qs(reads, qs_list, 0.9, kernel=kernel)
    want = jcons.simple_assembly_qs(reads, qs_list, 0.9, kernel=kernel)
    counts = tcons.simple_assembly(reads, 0.9, kernel=kernel)
    with host_build.numpy_paths():
        numpy_path = tcons.simple_assembly_qs(reads, qs_list, 0.9, kernel=kernel)
        numpy_counts = tcons.simple_assembly(reads, 0.9, kernel=kernel)
    for a, b, c in zip(got, want, numpy_path):
        assert a.tobytes() == b.tobytes() == c.tobytes()
    assert counts.tobytes() == numpy_counts.tobytes() == got[0].tobytes()
    assert tcons.consensus_to_bases(got[0]) == jcons.consensus_to_bases(want[0])
    assert tcons.qs(*got) == jcons.qs(*want) == tcons.qs(*numpy_path)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_global_disp_equal(jax_lib, seed):
    rng = np.random.RandomState(seed)
    reads = _window_reads(rng, 6, length=60, jump=30)
    for prev, cur in zip(reads, reads[1:]):
        got = tcons.global_kernel(cur, prev)
        with host_build.numpy_paths():
            numpy_path = tcons.global_kernel(cur, prev)
        assert got == jcons.global_kernel(cur, prev) == numpy_path
    with pytest.raises(ValueError):
        tcons.global_kernel("AAAA", "")
    with host_build.numpy_paths(), pytest.raises(ValueError):
        tcons.global_kernel("AAAA", "")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_simple_blocks_equal(jax_lib, seed):
    import difflib

    rng = np.random.RandomState(seed)
    reads = _window_reads(rng, 6, length=80, jump=40)
    for prev, cur in zip(reads, reads[1:]):
        got = [tuple(int(v) for v in b) for b in tcons._matching_blocks(cur, prev)]
        want = [tuple(int(v) for v in b) for b in jcons._matching_blocks(cur, prev)]
        ref = [tuple(b) for b in difflib.SequenceMatcher(a=cur, b=prev).get_matching_blocks()]
        with host_build.numpy_paths():
            numpy_path = [tuple(b) for b in tcons._matching_blocks(cur, prev)]
        assert got == want == ref == numpy_path
        assert tcons.simple_kernel(cur, prev, 0.2, 0.5) == jcons.simple_kernel(cur, prev, 0.2,
                                                                               0.5)


@pytest.mark.parametrize("seed,n_bases", [(0, 90), (1, 140), (2, 60)])
def test_resquiggle_starts_equal(jax_lib, seed, n_bases):
    seq, _, _, sig = synth_read(np.random.RandomState(seed), n_bases=n_bases, noise=3.0)
    got = trs.resquiggle_signal(sig, seq, radius=40)
    with host_build.numpy_paths():
        numpy_path = trs.resquiggle_signal(sig, seq, radius=40)
    want = jrs.resquiggle_signal(sig, seq, radius=40)
    assert got.dtype == want.dtype == numpy_path.dtype
    assert np.array_equal(got, want) and np.array_equal(got, numpy_path)


@pytest.mark.parametrize("n,m", [(50, 40), (300, 120), (700, 1000)])
def test_dtw_distance_equal(jax_lib, n, m):
    rng = np.random.RandomState(n + m)
    a = trs.znorm(rng.randn(n).cumsum().astype(np.float32))
    b = trs.znorm(rng.randn(m).cumsum().astype(np.float32))
    got = trs.dtw_distance(a, b, radius=20)
    want = jrs._load_native().chiron_dtw_distance(a, n, b, m, 20)
    with host_build.numpy_paths():
        numpy_path = trs.dtw_distance(a, b, radius=20)
    assert got > 0 and got == want
    assert abs(numpy_path - got) <= 1e-6 * got


def test_call_writes_the_same_fastq_with_and_without_native_code(tmp_path):
    """`call` on .signal reads (the native parser and glue on the host path)
    against the same call on the numpy paths."""
    sig = str(tmp_path / "sig")
    make_training_dir(sig, n_files=3, n_bases=160, seed=5)
    for name in os.listdir(sig):
        if name.endswith(".label"):
            os.remove(os.path.join(sig, name))
    outs = {}
    for tag in ("native", "numpy"):
        out = str(tmp_path / tag)
        args = ["call", "-i", sig, "-o", out, "-p", "dna-pre", "-b", "16", "--beam", "0",
                "--sig_norm", "1", "--device", "cpu"]
        if tag == "numpy":
            with host_build.numpy_paths():
                tcli.main(args)
        else:
            tcli.main(args)
        outs[tag] = {f: open(os.path.join(out, "result", f)).read()
                     for f in sorted(os.listdir(os.path.join(out, "result")))}
    assert len(outs["native"]) == 3 and outs["native"] == outs["numpy"]


# ---- the static check, for every module this slice adds or extends ----------

SLICE_MODULES = ("io/labels.py", "io/signal.py", "cli.py", "params.py",
                 "tools/raw_extract.py", "tools/file_batch.py", "tools/labeler.py",
                 "tools/regen_goldens.py", "tools/resquiggle.py", "ops/host_build.py",
                 "ops/ctc_mc.py", "ops/__init__.py", "models/attention.py",
                 "assembly/consensus.py")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_no_jax_or_chiron_tpu(module):
    """No import of jax or chiron_tpu anywhere in the module, and h5py and
    mappy only inside functions (the card's machine has neither)."""
    import ast

    path = os.path.join(REPO, "chiron_tpu_torch", module)
    tree = ast.parse(open(path).read())
    top_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "chiron_tpu", "optax"), (module, name)
            if root in ("h5py", "mappy"):
                assert id(node) not in top_level, (module, name)


def test_slice_modules_import_without_h5py_mappy_or_jax():
    names = [f"chiron_tpu_torch.{m[:-3].replace('/', '.')}".replace(".__init__", "")
             for m in SLICE_MODULES]
    script = ("import sys\n"
              "for blocked in ('h5py', 'mappy', 'jax', 'chiron_tpu'):\n"
              "    sys.modules[blocked] = None\n"
              "import importlib\n"
              f"for name in {names!r}:\n"
              "    importlib.import_module(name)\n"
              "from chiron_tpu_torch.tools import labeler\n"
              "assert not labeler.HAVE_MAPPY\n"
              "print('imported')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and "imported" in proc.stdout, proc.stderr
