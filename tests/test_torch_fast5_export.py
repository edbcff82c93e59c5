"""The port's fast5 labelling and fast5 tools against the JAX package's on the
CPU (both need h5py): io/labels.get_label_raw / get_label_segment (arrays
exact, each error the same type and message), `chiron export` and
tools/raw_extract (trees byte for byte, raw.log without its timestamps, the
printed counts), tools/file_batch (.bin and data.meta byte for byte) and
tools/labeler (corrected event tables equal to the JAX package's, on its
native DTW and on its numpy fallback, on the per-read-fasta path); the
exported tree trains one step with the port's `train --device cpu`.
"""

import os
import re
import types

import h5py
import numpy as np
import pytest
import torch

from synth import synth_read, write_fast5

import chiron_tpu.tools.resquiggle as jrs
from chiron_tpu import cli as jcli
from chiron_tpu.io import labels as jlabels
from chiron_tpu.tools import file_batch as jfb
from chiron_tpu.tools import labeler as jlab
from chiron_tpu.tools import raw_extract as jre
from chiron_tpu_torch import cli as tcli
from chiron_tpu_torch.io import labels as tlabels
from chiron_tpu_torch.tools import file_batch as tfb
from chiron_tpu_torch.tools import labeler as tlab
from chiron_tpu_torch.tools import raw_extract as tre

GROUP, SUB = "Corrected_000", "BaseCalled_template"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: several test workers' torch
    thread pools competing for the cores made its CPU model runs ~20x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fast5_dir(root, n=4, n_bases=160, seed=0, basecall_events=False, bad=True):
    """Resquiggled fast5s (Corrected_000 events), and with ``bad`` one file
    of each failure kind get_label_raw reports."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        seq, starts, lengths, sig = synth_read(rng, n_bases + 40 * i, noise=3.0)
        write_fast5(os.path.join(root, f"r{i}.fast5"), sig, starts, lengths, seq,
                    read_id=f"read{i}", basecall_events=basecall_events)
    if bad:
        _bad_files(root, rng)
    return root


def _bad_files(root, rng):
    seq, starts, lengths, sig = synth_read(rng, 30, noise=3.0)
    write_fast5(os.path.join(root, "x_no_events.fast5"), sig, read_id="ne")
    write_fast5(os.path.join(root, "x_one_event.fast5"), sig, starts[:1], lengths[:1], seq[:1],
                read_id="oe")
    path = os.path.join(root, "x_no_channel.fast5")
    write_fast5(path, sig, starts, lengths, seq, read_id="nc")
    with h5py.File(path, "a") as f:
        del f["/UniqueGlobalKey/channel_id"]
    path = os.path.join(root, "x_no_range.fast5")
    write_fast5(path, sig, starts, lengths, seq, read_id="nr")
    with h5py.File(path, "a") as f:
        del f["/UniqueGlobalKey/channel_id"].attrs["range"]
    path = os.path.join(root, "x_no_raw.fast5")
    write_fast5(path, sig, starts, lengths, seq, read_id="nw")
    with h5py.File(path, "a") as f:
        del f["/Raw/Reads/Read_0"]
    with open(os.path.join(root, "x_not_hdf5.fast5"), "w") as f:
        f.write("not an HDF5 file\n")


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # the error's type and message are compared
        return type(e), str(e)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_get_label_raw_arrays_and_errors_equal(tmp_path):
    root = _fast5_dir(str(tmp_path / "f5"))
    names = sorted(os.listdir(root))
    assert len(names) == 10
    kinds = set()
    for name in names:
        path = os.path.join(root, name)
        got = _outcome(tlabels.get_label_raw, path, GROUP, SUB)
        want = _outcome(jlabels.get_label_raw, path, GROUP, SUB)
        assert got[0] == want[0] and _same(got[1], want[1]), name
        kinds.add(got[0])
    assert kinds == {"ok", OSError, RuntimeError, NotImplementedError}


def test_get_label_raw_too_long_signal_raises_as_jax(tmp_path, monkeypatch):
    root = _fast5_dir(str(tmp_path / "f5"), n=1, bad=False)
    path = os.path.join(root, "r0.fast5")
    monkeypatch.setattr(tlabels, "MAX_RAW_SAMPLES", 100)
    monkeypatch.setattr(jlabels, "MAX_RAW_SAMPLES", 100)
    got = _outcome(tlabels.get_label_raw, path, GROUP, SUB)
    assert got == _outcome(jlabels.get_label_raw, path, GROUP, SUB) and got[0] is ValueError
    assert tlabels._LABEL_DTYPE == jlabels._LABEL_DTYPE
    assert tlabels.MAX_RAW_SAMPLES == 100 and jlabels.MAX_RAW_SAMPLES == 100


@pytest.mark.parametrize("seed", [0, 1])
def test_get_label_segment_equal(tmp_path, seed):
    root = _fast5_dir(str(tmp_path / "f5"), n=3, seed=seed, basecall_events=True, bad=False)
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        got = tlabels.get_label_segment(path, "Basecall_1D_000", SUB, corrected_group=GROUP)
        want = jlabels.get_label_segment(path, "Basecall_1D_000", SUB, corrected_group=GROUP)
        assert _same(got, want), name
        assert got[0]["move"].sum() > 0 and got[0]["kmer"].dtype == np.dtype("S5")


def test_get_label_segment_errors_equal(tmp_path):
    rng = np.random.RandomState(3)
    root = str(tmp_path / "f5")
    os.makedirs(root)
    seq, starts, lengths, sig = synth_read(rng, 40, noise=3.0)
    cases = {"no_basecall": dict(), "few_corrected": dict(n=4),
             "no_corrected": dict(drop_corrected=True)}
    for name, kw in cases.items():
        path = os.path.join(root, f"{name}.fast5")
        n = kw.get("n", len(seq))
        write_fast5(path, sig, starts[:n], lengths[:n], seq[:n],
                    basecall_events=name != "no_basecall")
        if kw.get("drop_corrected"):
            with h5py.File(path, "a") as f:
                del f["/Analyses/Corrected_000"]
        got = _outcome(tlabels.get_label_segment, path, "Basecall_1D_000", SUB, GROUP)
        want = _outcome(jlabels.get_label_segment, path, "Basecall_1D_000", SUB, GROUP)
        assert got[0] is RuntimeError and got == want, name


def _tree(root):
    """Every file under root: bytes, with raw.log's timestamps cut."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            data = open(path, "rb").read()
            if f == "raw.log":
                data = re.sub(rb"^\S+ \S+ ", b"", data, flags=re.M)
            out[os.path.relpath(path, root)] = data
    return out


EXPORT_CASES = {
    "default": [],
    "unit": ["--unit"],
    "rna": ["--mode", "rna"],
    "min_bps": ["--min_bps", "200", "--n_errors", "2"],
    "tffile": ["-f", "train.tfrecords", "-b", "2"],
}


@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_chiron_export_trees_byte_for_byte(tmp_path, capsys, case):
    src = _fast5_dir(str(tmp_path / "f5"), n=5)
    trees, printed = {}, {}
    for tag, cli in (("port", tcli), ("jax", jcli)):
        out = str(tmp_path / tag)
        cli.main(["export", "-i", src, "-o", out, "--basecall_group", GROUP,
                  *EXPORT_CASES[case]])
        printed[tag] = capsys.readouterr().out
        trees[tag] = _tree(out)
    assert trees["port"] == trees["jax"]
    assert printed["port"] == printed["jax"] and "failures" in printed["port"]
    signals = [k for k in trees["port"] if k.endswith(".signal")]
    assert len(signals) == (3 if case == "min_bps" else 5)  # reads of 160-320 bases
    if case == "tffile":
        assert sorted({k.split(os.sep)[0] for k in signals}) == ["1", "2", "3"]
        assert "train.tfrecords" in trees["port"]


def test_raw_extract_run_counts_equal(tmp_path):
    """raw_extract.run over two input folders: the same Counter and tree."""
    a = _fast5_dir(str(tmp_path / "a"), n=3, seed=1)
    b = _fast5_dir(str(tmp_path / "b"), n=2, seed=2, bad=False)
    results = {}
    for tag, mod in (("port", tre), ("jax", jre)):
        args = types.SimpleNamespace(input=f"{a},{b}", output=str(tmp_path / tag),
                                     basecall_group=GROUP, basecall_subgroup=SUB, batch=3,
                                     unit=False, mode="dna", min_bps=0, n_errors=5,
                                     tffile=None)
        results[tag] = (mod.run(args), _tree(str(tmp_path / tag)))
    assert results["port"] == results["jax"]
    assert results["port"][0][tre.SUCCEED_TAG] == 5 and tre.SUCCEED_TAG == jre.SUCCEED_TAG
    with pytest.raises(IOError):
        tre.run(types.SimpleNamespace(input=str(tmp_path / "missing"), output=str(tmp_path)))


@pytest.mark.parametrize("norm,mode,batch", [("median", "dna", 4), ("mean", "rna", 3),
                                             ("None", "dna", 100)])
def test_file_batch_bins_and_meta_byte_for_byte(tmp_path, capsys, norm, mode, batch):
    src = _fast5_dir(str(tmp_path / "f5"), n=4, n_bases=300)
    trees, results, printed = {}, {}, {}
    for tag, mod in (("port", tfb), ("jax", jfb)):
        out = str(tmp_path / tag)
        argv = ["-i", src, "-o", out, "--basecall_group", GROUP, "-l", "256", "-b",
                str(batch), "-n", norm, "--mode", mode, "-m", "2"]
        mod.main(argv)
        printed[tag] = capsys.readouterr().out
        trees[tag] = _tree(out)
        results[tag] = mod.run(types.SimpleNamespace(
            input=src, output=out + "_run", basecall_group=GROUP, basecall_subgroup=SUB,
            length=256, batch=batch, normalization=norm, max=2, mode=mode))
        capsys.readouterr()
    assert trees["port"] == trees["jax"] and "data.meta" in trees["port"]
    assert results["port"] == results["jax"] and results["port"]["success"] >= 1
    if batch == 100:  # no batch fills: every file is read, the 6 bad ones fail
        assert results["port"]["failed"] == 6 and results["port"]["batches"] == 0
    assert printed["port"] == printed["jax"]


@pytest.fixture
def labeler_inputs(tmp_path):
    rng = np.random.RandomState(1)
    f5dir = str(tmp_path / "fast5")
    os.makedirs(f5dir)
    seqs = {}
    for i in range(3):
        seq, _, _, signal = synth_read(rng, 100 + 20 * i, noise=2.0)
        write_fast5(os.path.join(f5dir, f"r{i}.fast5"), signal, read_id=f"read{i}")
        seqs[f"read{i}"] = seq
    ref = str(tmp_path / "refs.fasta")
    with open(ref, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n{seq}\n")
    return f5dir, ref, seqs


def _labeler_events(mod, f5dir, ref, out, thread=1):
    args = types.SimpleNamespace(input=f5dir, ref=ref, polya=None, mode=0, saving=out,
                                 thread=thread, pore_model=None, radius=40)
    results = mod.run(args)
    events = {}
    for name in sorted(os.listdir(os.path.join(out, "fast5s"))):
        with h5py.File(os.path.join(out, "fast5s", name), "r") as f:
            events[name] = np.asarray(f[f"/Analyses/{GROUP}/{SUB}/Events"]).tobytes()
    return results, events


@pytest.mark.parametrize("jax_dtw", ["native", "fallback"])
def test_labeler_event_tables_equal(tmp_path, monkeypatch, labeler_inputs, jax_dtw):
    if tlab.HAVE_MAPPY or jlab.HAVE_MAPPY:
        pytest.skip("mappy is installed: the per-read fasta path does not run")
    f5dir, ref, seqs = labeler_inputs
    if jax_dtw == "fallback":
        monkeypatch.setattr(jrs, "_lib", None)
        monkeypatch.setattr(jrs, "_load_native", lambda: None)
    got = _labeler_events(tlab, f5dir, ref, str(tmp_path / "port"))
    want = _labeler_events(jlab, f5dir, ref, str(tmp_path / "jax"))
    assert got == want and got[0] == {"ok": 3} and len(got[1]) == 3
    (raw, label, _, _), _ = tlabels.get_label_raw(
        os.path.join(str(tmp_path / "port"), "fast5s", "r0.fast5"), GROUP, SUB)
    assert b"".join(label["base"]).decode() == seqs["read0"]


def test_labeler_worker_pool_and_polya_table(tmp_path, labeler_inputs):
    f5dir, ref, _ = labeler_inputs
    one = _labeler_events(tlab, f5dir, ref, str(tmp_path / "one"))
    two = _labeler_events(tlab, f5dir, ref, str(tmp_path / "two"), thread=2)
    assert one == two
    tsv = tmp_path / "polya.tsv"
    tsv.write_text("readname\ttranscript_start\tqc_tag\nread0\t12.0\tPASS\nread1\t7\tNOREGION\n")
    assert tlab.read_polya_tsv(str(tsv)) == jlab.read_polya_tsv(str(tsv)) == {"read0": 12}
    headless = tmp_path / "headless.tsv"
    headless.write_text("name start\nread2 30\n")
    assert tlab.read_polya_tsv(str(headless)) == jlab.read_polya_tsv(str(headless))
    assert tlab._reference_for_read("ACG", None, {}, "r") == \
        jlab._reference_for_read("ACG", None, {}, "r") == "ACG"


def test_exported_tree_trains_one_step_on_the_cpu(tmp_path):
    import json

    src = _fast5_dir(str(tmp_path / "f5"), n=3, n_bases=300, bad=False)
    data = str(tmp_path / "pairs")
    tcli.main(["export", "-i", src, "-o", data, "--basecall_group", GROUP])
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"cnn": {"model": "custom"},
                   "rnn": {"layer_num": 1, "hidden_num": 16, "cell_type": "LSTM",
                           "layer_type": "normal"},
                   "opt_method": "Adam", "fl_gamma": 0}, f)
    log_dir = str(tmp_path / "log")
    tcli.main(["train", "-i", data, "-o", log_dir, "-m", "m", "-s", "200", "-b", "8",
               "-x", "1", "--configure", cfg, "--device", "cpu"])
    assert os.path.exists(os.path.join(log_dir, "m", "checkpoint"))
