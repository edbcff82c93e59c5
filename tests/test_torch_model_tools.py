"""The port's model tools against the JAX package's, on the same seeded
inputs: chiron_tpu_torch/tools/{convert_tf_checkpoint,net2wide,grid_search,
make_bundled_models,mfu}.py. Trees and files are compared byte for byte,
logits within the stated share of max |logit|. The trainer is replaced by a
recorder where a tool only hands it hyperparameters; nothing here writes
under chiron_tpu/model (the last test checks).
"""

import hashlib
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from chiron_tpu import config as jconfig
from chiron_tpu.models import apply_model as japply
from chiron_tpu.models import init_model as jinit
from chiron_tpu.tools import convert_tf_checkpoint as jconv
from chiron_tpu.tools import grid_search as jgrid
from chiron_tpu.tools import make_bundled_models as jmbm
from chiron_tpu.tools import net2wide as jwide
from chiron_tpu.tools import simulate as jsim
from chiron_tpu.train import checkpoint as jckpt
from chiron_tpu.train import loop as jloop
from chiron_tpu_torch import cli as tcli
from chiron_tpu_torch import config as tconfig
from chiron_tpu_torch.ops.cuda_build import KernelError
from chiron_tpu_torch.params import from_jax_params
from chiron_tpu_torch.tools import convert_tf_checkpoint as tconv
from chiron_tpu_torch.tools import grid_search as tgrid
from chiron_tpu_torch.tools import make_bundled_models as tmbm
from chiron_tpu_torch.tools import mfu as tmfu
from chiron_tpu_torch.tools import net2wide as twide
from chiron_tpu_torch.tools import simulate as tsim
from chiron_tpu_torch.train import checkpoint as tckpt
from chiron_tpu_torch.train import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "chiron_tpu", "model")
BUNDLED = ("DNA_default", "DNA_slow", "RNA_default")


def _hash_models():
    out = {}
    for root, _, names in os.walk(MODELS):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, MODELS)] = hashlib.sha256(f.read()).hexdigest()
    return out


MODEL_HASHES = _hash_models()  # before any test of this file runs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's torch ops on one thread (the test workers share the
    cores; tests/test_torch_accuracy.py says why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, sub in enumerate(tree)
                for k2, v in _flat(sub, f"{prefix}/[{i}]").items()}
    return {prefix: tree}


def _assert_trees_equal(got, want):
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        a, b = np.asarray(fg[k]), np.asarray(fw[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def _tree_bytes(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(dirpath, n), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, n), root)] = f.read()
    return out


def _npz_tree_equal(a, b):
    """Two directories hold the same files, the .npz ones with equal arrays."""
    ta, tb = _tree_bytes(a), _tree_bytes(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if ta[k] != tb[k] and k.endswith(".npz"):  # equal arrays in another zip
            with np.load(os.path.join(a, k)) as x, np.load(os.path.join(b, k)) as y:
                assert sorted(x.files) == sorted(y.files)
                for n in x.files:
                    assert x[n].tobytes() == y[n].tobytes() and x[n].dtype == y[n].dtype
        else:
            assert ta[k] == tb[k], k


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _logits_close(got, want, tol):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (err, scale)


# ---- tools/convert_tf_checkpoint ------------------------------------------------

def _get(tree, path):
    node = tree
    for p in path.split("/"):
        node = node[int(p[1:-1])] if p.startswith("[") else node[p]
    return np.asarray(node)


def _fake_tf_checkpoint(config, dialect, seed):
    """TF-shaped tensors for every variable of the reference graph's name
    map in ``dialect`` (tests/test_convert.py's construction; population
    variances positive)."""
    rng = np.random.RandomState(seed)
    ref = _np_tree(jinit(jax.random.PRNGKey(0), config))
    tensors = {}
    for name, (path, transform) in sorted(jconv.build_name_map(config, dialect).items()):
        if transform == "drop":
            shape = (4,)
        elif transform == "conv":
            shape = (1,) + _get(ref, path).shape
        elif transform in ("lstm_kernel", "gru_gates", "gru_cand"):
            sfx = {"lstm_kernel": "", "gru_gates": "_g", "gru_cand": "_c"}[transform]
            wx, wh = _get(ref, f"{path}/wx{sfx}"), _get(ref, f"{path}/wh{sfx}")
            shape = (wx.shape[0] + wh.shape[0], wx.shape[1])
        elif transform == "bnlstm_off":
            shape = _get(ref, path.rsplit("/", 1)[0] + "/b").shape
        elif path.endswith(("bn_mean", "bn_var")):
            shape = _get(ref, path.rsplit("/", 1)[0] + "/bn_scale").shape
        else:
            shape = _get(ref, path).shape
        t = rng.randn(*shape).astype(np.float32) * 0.1
        tensors[name] = np.abs(t) + 0.5 if path.endswith("bn_var") else t
    return tensors


@pytest.mark.parametrize("model,cell,dialect", [
    ("DNA_default", "LSTM", "global"), ("DNA_default", "LSTM", "pop"),
    ("RNA_default", "LSTM", "global"), ("RNA_default", "LSTM", "pop"),
    ("DNA_default", "GRU", "global"), ("DNA_default", "BNLSTM", "global")])
def test_convert_equal_and_runs_alike(model, cell, dialect):
    """The converted trees byte for byte, and the port's logits on the
    port's tree within 5e-4 of max |logit| of JAX apply_model's."""
    config = jconfig.read_config(os.path.join(MODELS, model, "model.json"))
    config["rnn"]["cell_type"] = cell
    assert tconv.build_name_map(config, dialect) == jconv.build_name_map(config, dialect)
    tensors = _fake_tf_checkpoint(config, dialect, seed=3)
    assert tconv.detect_dialect(tensors) == jconv.detect_dialect(tensors)
    got = tconv.convert(tensors.__getitem__, config, bn_dialect=dialect)
    want = jconv.convert(tensors.__getitem__, config, bn_dialect=dialect)
    _assert_trees_equal(got, want)
    # BNLSTM normalises each step over the batch rows: with a few rows its
    # variances fall near eps and amplify float32 rounding, so it runs 16
    seg, rows = 200, 16 if cell == "BNLSTM" else 4
    rng = np.random.RandomState(4)
    x = rng.randn(rows, seg).astype(np.float32)
    frames = seg // (5 if model == "RNA_default" else 1)
    sl = np.full(rows, frames, np.int32)
    jl = np.asarray(jax.jit(lambda p, a, b: japply(p, config, a, b))(want, x, sl))
    with torch.no_grad():
        tl = from_jax_params(got, config, "cpu")(torch.from_numpy(x), torch.from_numpy(sl))
    assert tl.shape == jl.shape == (rows, frames, 5)
    _logits_close(tl.numpy(), jl, 5e-4)


# ---- tools/net2wide -------------------------------------------------------------

CFG = {"cnn": {"model": "dna_model1"},
       "rnn": {"layer_num": 3, "hidden_num": 12, "cell_type": "LSTM", "layer_type": "normal"}}
CFG_WIDE = {"cnn": {"model": "dna_model1"},
            "rnn": {"layer_num": 3, "hidden_num": 16, "cell_type": "LSTM",
                    "layer_type": "normal"}}


@pytest.mark.parametrize("noise", [0.0, 1e-2])
def test_widen_params_byte_equal(noise):
    params = _np_tree(jinit(jax.random.PRNGKey(3), CFG))
    got = twide.widen_params(params, 12, 16, seed=1, noise=noise)
    want = jwide.widen_params(params, 12, 16, seed=1, noise=noise)
    _assert_trees_equal(got, want)
    if noise == 0.0:
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(2, 64).astype(np.float32))
        lens = torch.tensor([64, 48], dtype=torch.int32)
        with torch.no_grad():
            base = from_jax_params(params, CFG, "cpu")(x, lens).numpy()
            wide = from_jax_params(got, CFG_WIDE, "cpu")(x, lens).numpy()
        _logits_close(wide, base, 1e-5)


def test_widen_model_dir_equal(tmp_path):
    src = tmp_path / "src"
    params = _np_tree(jinit(jax.random.PRNGKey(3), CFG))
    tckpt.save_checkpoint(str(src), params, 7, prefix="ema")
    (src / "model.json").write_text(json.dumps(CFG))
    twide.widen_model_dir(str(src), str(tmp_path / "torch"), 16, seed=2)
    jwide.widen_model_dir(str(src), str(tmp_path / "jax"), 16, seed=2)
    _npz_tree_equal(str(tmp_path / "torch"), str(tmp_path / "jax"))
    gru = tmp_path / "gru"
    gru.mkdir()
    (gru / "model.json").write_text(json.dumps(
        {**CFG, "rnn": {**CFG["rnn"], "cell_type": "GRU"}}))
    for mod in (twide, jwide):
        with pytest.raises(NotImplementedError):
            mod.widen_model_dir(str(gru), str(tmp_path / "out"), 16)


# ---- tools/grid_search ------------------------------------------------------------

def test_generate_and_write_configs_equal(tmp_path):
    small = {"cnn_layers": [["res", "conv"], ["res"]], "hidden_num": [[64, 32], [16]],
             "kernels": [[3, 1], [5]], "strides": [[2, 1], [1]], "rnn_hidden": [8]}
    for grid in (None, small):
        assert tgrid.generate_configs(grid) == jgrid.generate_configs(grid)
        tgrid.write_configs(str(tmp_path / "torch"), tgrid.generate_configs(grid))
        jgrid.write_configs(str(tmp_path / "jax"), jgrid.generate_configs(grid))
        assert _tree_bytes(str(tmp_path / "torch")) == _tree_bytes(str(tmp_path / "jax"))
    assert len(tgrid.generate_configs()) == 16


def _recorder(calls, fail_index=None, exc=None):
    def train(h):
        calls.append(dict(vars(h)))
        i = int(h.model_name.split("_")[1])
        if i == fail_index:
            raise exc
        with open(h.configure) as f:  # a loss that depends on the candidate
            cfg = json.load(f)
        return {"final_loss": float(cfg["rnn"]["hidden_num"] + sum(cfg["cnn"]["kw"]) - i / 10)}
    return train


def test_search_passes_jax_hparams_and_ranks_alike(tmp_path, monkeypatch):
    calls = {"torch": [], "jax": []}
    monkeypatch.setattr(tloop, "train", _recorder(calls["torch"], 5, ValueError("bad config")))
    monkeypatch.setattr(jloop, "train", _recorder(calls["jax"], 5, ValueError("bad config")))
    got = tgrid.search("data", str(tmp_path / "g"), max_steps=7, batch_size=8, device="cpu")
    want = jgrid.search("data", str(tmp_path / "g"), max_steps=7, batch_size=8)
    assert got == want and got[-1] == {"config": os.path.join(str(tmp_path / "g"),
                                                               "config_005.json"),
                                       "final_loss": float("inf"), "index": 5,
                                       "error": "bad config"}
    assert [c.pop("device") for c in calls["torch"]] == ["cpu"] * 16
    assert calls["torch"] == calls["jax"]
    ranking = {}
    for tag, search in (("torch", tgrid.search), ("jax", jgrid.search)):
        kw = {"device": "cpu"} if tag == "torch" else {}
        search("data", str(tmp_path / "g"), max_steps=7, batch_size=8, **kw)
        with open(tmp_path / "g" / "ranking.json") as f:
            ranking[tag] = f.read()
    assert ranking["torch"] == ranking["jax"]


@pytest.mark.parametrize("exc", [torch.AcceleratorError("CUDA error: an illegal memory access"),
                                 KernelError("CUDA launch of lstm_fwd failed: cudaError 700"),
                                 torch.cuda.OutOfMemoryError("CUDA out of memory")],
                         ids=["accelerator", "kernel", "oom"])
def test_search_lets_a_device_fault_through(tmp_path, monkeypatch, exc):
    calls = []
    monkeypatch.setattr(tloop, "train", _recorder(calls, 2, exc))
    with pytest.raises(type(exc)):
        tgrid.search("data", str(tmp_path / "g"), max_steps=2, device="cpu")
    assert len(calls) == 3 and not (tmp_path / "g" / "ranking.json").exists()


def test_search_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgrid.search("data", str(tmp_path / "g"))
    assert not (tmp_path / "g").exists()


# ---- tools/make_bundled_models ----------------------------------------------------

def _cap_corpora(monkeypatch, n=2):
    """Both packages' simulate_corpus writing at most n reads a corpus."""
    for mod in (jsim, tsim):
        orig = mod.simulate_corpus

        def capped(out_dir, n_reads, *a, _orig=orig, **kw):
            return _orig(out_dir, min(n_reads, n), *a, **kw)

        monkeypatch.setattr(mod, "simulate_corpus", capped)


def test_stage_data_byte_equal(tmp_path, monkeypatch):
    _cap_corpora(monkeypatch, 3)
    for mod in (jmbm, tmbm):  # two DNA variants (one with its own read count), one RNA
        monkeypatch.setattr(mod, "DNA_VARIANTS", (mod.DNA_VARIANTS[0], mod.DNA_VARIANTS[6]))
        monkeypatch.setattr(mod, "RNA_VARIANTS", mod.RNA_VARIANTS[2:])
    trees = {}
    for tag, mod in (("torch", tmbm), ("jax", jmbm)):
        work = tmp_path / tag
        work.mkdir()
        (work / "dna_pore_model.tsv").write_bytes(
            open(os.path.join(MODELS, "DNA_default", "pore_model.tsv"), "rb").read())
        mod.stage_data(str(work), dna_reads=1, rna_reads=2)
        trees[tag] = _tree_bytes(str(work))
    assert len(trees["torch"]) == 1 + 2 * (1 + 3 + 3 + 2 + 3)
    assert trees["torch"] == trees["jax"]
    with pytest.raises(ValueError, match="--reference"):
        tmbm.stage_data(str(tmp_path / "empty"))


@pytest.mark.parametrize("mode", ["dna", "dna_slow", "rna"])
def test_train_passes_jax_hparams(tmp_path, monkeypatch, mode):
    calls = {"torch": [], "jax": []}
    for tag, mod in (("torch", tloop), ("jax", jloop)):
        monkeypatch.setattr(mod, "train", lambda h, _c=calls[tag]: _c.append(dict(vars(h)))
                            or {"final_loss": 1.0})
    kw = dict(retrain=True, step_rate=1e-3, model_name="m") if mode == "dna" else {}
    tmbm._train(str(tmp_path), mode, 12, device="cpu", **kw)
    jmbm._train(str(tmp_path), mode, 12, **kw)
    assert calls["torch"][0].pop("device") == "cpu"
    assert calls["torch"] == calls["jax"]
    if mode != "dna":
        assert calls["torch"][0]["configure"].startswith(tcli.MODEL_ROOT)


def test_train_restart_chain_runs_the_port(tmp_path, monkeypatch):
    import subprocess

    monkeypatch.setattr(tloop, "train", lambda h: {"restart": True, "step": 4})
    cmds = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: cmds.append(cmd) or 0)
    assert tmbm._train(str(tmp_path), "rna", 9, train_sub="t", device="cpu") is None
    assert cmds[0][1:3] == ["-m", "chiron_tpu_torch.tools.make_bundled_models"]
    assert cmds[0][-4:] == ["--device", "cpu", "--train_sub", "t"]
    monkeypatch.setattr(subprocess, "call", lambda cmd: 3)
    with pytest.raises(RuntimeError, match="exited 3"):
        tmbm._train(str(tmp_path), "rna", 9, device="cpu")


def test_stage_finetune_and_install_equal(tmp_path, monkeypatch):
    for mod in (tloop, jloop):
        monkeypatch.setattr(mod, "train", lambda h: {"final_loss": 1.0})
    for tag, mod in (("torch", tmbm), ("jax", jmbm)):
        kw = {"device": "cpu"} if tag == "torch" else {}
        mod.stage_finetune(str(tmp_path / tag), "dna", 5, **kw)
        mod.stage_finetune(str(tmp_path / tag), "rna", 5, **kw)
    _npz_tree_equal(str(tmp_path / "torch"), str(tmp_path / "jax"))
    # install: each package's trained checkpoints into a scratch model root
    work = tmp_path / "work"
    src = work / "models" / "DNA_retrain"
    tckpt.save_checkpoint(str(src), {"w": np.ones(2)}, 100, prefix="final")
    tckpt.save_checkpoint(str(src), {"w": np.ones(2) * 2}, 100, prefix="ema")
    tckpt.save_checkpoint(str(src), {"w": np.ones(2) * 3}, 50, prefix="model")
    (src / "model.json").write_text('{"rnn": {"hidden_num": 128}}')
    (work / "dna_pore_model.tsv").write_text("kmer\tm\ts\n")
    roots = {"torch": tmp_path / "root_torch", "jax": tmp_path / "root_jax"}
    for root in roots.values():
        for name in ("DNA_default", "RNA_default"):
            (root / name).mkdir(parents=True)
            (root / name / "old-1.npz").write_bytes(b"old")
    tmbm.stage_install(str(work), model_root=str(roots["torch"]))
    jrepo = tmp_path / "jrepo"
    os.makedirs(jrepo / "chiron_tpu")
    os.symlink(roots["jax"], jrepo / "chiron_tpu" / "model")
    monkeypatch.setattr(jmbm, "REPO", str(jrepo))
    jmbm.stage_install(str(work))
    _npz_tree_equal(str(roots["torch"]), str(roots["jax"]))
    assert sorted(os.listdir(roots["torch"] / "DNA_default")) == [
        "checkpoint", "ema-100.npz", "final-100.npz", "model.json", "pore_model.tsv"]


# every read of the synthetic reference, and _read_logits' read, spans
# WINDOWS 400-sample windows: the JAX forward compiles once for the file
WINDOWS = 4


def _reference_dir(root, n_reads=2, n_bases=100):
    """A reference example_data/DNA layout: output/raw/<name>.signal (integer
    samples, one a line) and the golden fasta under output/result; each read
    cut at the last base that starts within WINDOWS windows."""
    km = tsim.KmerModel.load(os.path.join(MODELS, "DNA_default", "pore_model.tsv"))
    cfg = tsim.SimConfig(mean_dwell=24.0, max_dwell=140, noise_ar=0.7)
    rng = np.random.RandomState(12)
    os.makedirs(os.path.join(root, "output", "raw"))
    os.makedirs(os.path.join(root, "output", "result"))
    fasta = []
    for i in range(n_reads):
        seq, starts, _, sig = tsim.simulate_read(rng, km, n_bases, cfg)
        k = int(np.searchsorted(starts, 400 * WINDOWS)) - 1
        seq, sig = seq[:k], sig[:starts[k]]
        assert 400 * (WINDOWS - 1) < len(sig) <= 400 * WINDOWS
        raw = np.round(sig * 30 + 500).astype(np.int64)
        np.savetxt(os.path.join(root, "output", "raw", f"read{i}.signal"), raw, fmt="%d")
        fasta.append(f">read{i} golden\n{seq}\n")
    with open(os.path.join(root, "output", "result", "golden.fasta"), "w") as f:
        f.write("".join(fasta))
    return root


def test_stage_realdata_equal(tmp_path, monkeypatch):
    """Byte-equal corpora without an align model; with DNA_default as the
    align model (its forward on the CPU in each package) >= 99% of the label
    rows equal."""
    _cap_corpora(monkeypatch)
    ref = _reference_dir(str(tmp_path / "reference"))
    monkeypatch.setattr(jmbm, "REFERENCE_DNA", ref)
    trees = {}
    for align in (None, os.path.join(MODELS, "DNA_default")):
        for tag in ("torch", "jax"):
            work = str(tmp_path / f"{tag}_{align is not None}")
            if tag == "torch":
                tmbm.stage_realdata(work, repeats=2, align_model=align, reference=ref,
                                    device="cpu")
            else:
                jmbm.stage_realdata(work, repeats=2, align_model=align)
            trees[tag] = _tree_bytes(work)
        assert sorted(trees["torch"]) == sorted(trees["jax"])
        assert len(trees["torch"]) == 2 * 2 * 2 + 3 * 2 * 2
        if align is None:
            assert trees["torch"] == trees["jax"]
            continue
        same = total = 0
        for k in trees["jax"]:
            if k.endswith(".label"):
                a = trees["torch"][k].decode().splitlines()
                b = trees["jax"][k].decode().splitlines()
                assert len(a) == len(b)
                same += sum(x == y for x, y in zip(a, b))
                total += len(b)
            else:
                assert trees["torch"][k] == trees["jax"][k], k
        assert same >= 0.99 * total, (same, total)
    with pytest.raises(ValueError, match="--reference"):
        tmbm.stage_realdata(str(tmp_path / "none"))


def test_read_logits_close():
    config = jconfig.read_config(os.path.join(MODELS, "DNA_default", "model.json"))
    tree, _ = tckpt.restore_latest(os.path.join(MODELS, "DNA_default"))
    n = 400 * WINDOWS - 150  # the last window padded
    sig = np.round(np.random.RandomState(13).randn(n) * 40 + 500).astype(np.float32)
    got = tmbm._read_logits(tree, config, sig, device="cpu")
    want = jmbm._read_logits(jckpt.restore_latest(os.path.join(MODELS, "DNA_default"))[0],
                             config, sig)
    assert got.shape == want.shape == (n, 5)
    _logits_close(got, want, 5e-4)


# ---- tools/mfu ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mfu():
    spec = importlib.util.spec_from_file_location("jax_tools_dev_mfu",
                                                  os.path.join(REPO, "tools_dev", "mfu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,seg", [("DNA_default", 400), ("DNA_slow", 2000),
                                      ("RNA_default", 2000)])
def test_mfu_count_against_xla(jax_mfu, name, seg):
    """Without its recurrence the analytic count is within 2% of XLA's cost
    analysis (which counts the scan body once); the recurrence term is
    2·H·4H a step, direction and layer."""
    mdir = os.path.join(MODELS, name)
    config = tconfig.read_config(os.path.join(mdir, "model.json"))
    terms = tmfu.flop_terms(config, seg)
    rnn = config["rnn"]
    steps = -(-seg // {"DNA_default": 1, "DNA_slow": 4, "RNA_default": 5}[name])
    h = rnn["hidden_num"]
    assert terms["recurrence"] == 2 * h * 4 * h * steps * 2 * rnn["layer_num"]
    assert tmfu.flops_per_sample(mdir, seg) == sum(terms.values()) / seg
    xla = jax_mfu.flops_per_sample(mdir, seg, batch=1)
    ours = (sum(terms.values()) - terms["recurrence"]) / seg
    assert abs(ours - xla) <= 0.02 * xla, (ours, xla)


def test_mfu_terms_of_other_cells_and_the_head():
    base = {"cnn": {"model": "dna_model1"}}
    gru = tmfu.flop_terms({**base, "rnn": {"layer_num": 2, "hidden_num": 100,
                                           "cell_type": "GRU", "layer_type": "rna"}}, 400)
    assert gru["recurrence"] == 2 * 100 * 3 * 100 * 400 * 2 * 2
    assert gru["projection"] == 2 * 400 * 2 * (256 * 300 + 100 * 300)
    head = tmfu.flop_terms({**base, "rnn": {"layer_num": 0, "hidden_num": 100,
                                            "cell_type": "LSTM", "layer_type": "normal"}}, 400)
    assert head == {"conv": gru["conv"], "head": 2 * 400 * 256 * 5}
    s = tmfu.shares(4e6, 5e6)
    assert s["effective_tflops"] == 20.0 and s["share_of_bf16_peak"] == 20e12 / 989e12


def test_mfu_main_on_the_cpu_prints_counts(capsys):
    assert tmfu.main(["--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["model"] for r in rows] == list(BUNDLED)
    assert rows[0]["flops_per_sample"] == 4459264.0 and "share_of_bf16_peak" not in rows[0]


def test_zz_bundled_models_unchanged():
    assert _hash_models() == MODEL_HASHES
