"""The port's regen_goldens (chiron_tpu_torch/tools/regen_goldens.py): on the
CPU it writes files byte for byte equal to the committed goldens of
chiron_tpu/example_data (DNA, RNA, DNA_SLOW), into --out only: it refuses an
--out under chiron_tpu/, names h5py when it is missing, and leaves
chiron_tpu/example_data as it was.
"""

import hashlib
import os
import sys

import pytest
import torch

from chiron_tpu_torch.tools import regen_goldens as trg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "chiron_tpu", "example_data")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: several test workers' torch
    thread pools competing for the cores made its CPU model runs ~20x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hash_tree(root):
    h = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(root)):
        dirs.sort()
        for f in sorted(files):
            path = os.path.join(d, f)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


BEFORE = _hash_tree(EXAMPLES)


def _files(root):
    out = {}
    for sub in ("result", "segments"):
        for f in sorted(os.listdir(os.path.join(root, sub))):
            with open(os.path.join(root, sub, f), "rb") as fh:
                out[f"{sub}/{f}"] = fh.read()
    return out


@pytest.mark.parametrize("mode", ["dna", "rna", "dna_slow"])
def test_regen_on_the_cpu_writes_the_committed_goldens(tmp_path, mode):
    out = str(tmp_path / "goldens")
    assert trg.main(["--mode", mode, "--device", "cpu", "--out", out]) == 0
    name = mode.upper()
    got = _files(os.path.join(out, name, "output"))
    assert got and got == _files(os.path.join(EXAMPLES, name, "output"))
    assert sorted(os.listdir(out)) == [name]  # its work folder is removed


@pytest.mark.parametrize("under", ["chiron_tpu", "chiron_tpu/example_data/DNA/output",
                                   "chiron_tpu/../chiron_tpu/model"])
def test_regen_refuses_an_out_under_the_jax_package(under):
    with pytest.raises(ValueError, match="chiron_tpu"):
        trg.main(["--mode", "dna", "--device", "cpu", "--out", os.path.join(REPO, under)])


def test_regen_without_h5py_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        trg.main(["--device", "cpu", "--out", str(tmp_path)])


def test_regen_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        trg.main(["--mode", "dna", "--out", str(tmp_path)])
    assert trg.DEFAULT_OUT.startswith(os.path.join(REPO, "chiron_tpu_torch", "_build"))


def test_example_data_unchanged():
    assert _hash_tree(EXAMPLES) == BEFORE
