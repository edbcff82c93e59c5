"""The port's `train` entry point on CPU: a short run on synthetic
.signal/.label data through the CLI, and checkpoints that go both ways
between the port and the JAX package.

Logits tolerance atol 5e-4, as tests/test_torch_model.py (12 batch-stat
convs and an LSTM stack, float32 sums in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu import config as jconfig
from chiron_tpu.models import model as jmodel
from chiron_tpu.train import checkpoint as jckpt
from chiron_tpu_torch import cli
from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
from chiron_tpu_torch.train import checkpoint as tckpt
from chiron_tpu_torch.train import loop as tloop
from synth import make_training_dir

CONFIG = {"cnn": {"model": "dna_model1"},
          "rnn": {"layer_num": 1, "hidden_num": 16, "cell_type": "LSTM", "layer_type": "normal"},
          "opt_method": "Adam", "fl_gamma": 2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: the plain kernels run many
    small ops, and several test workers' torch thread pools competing for the
    cores made the 30-step CLI run ~30x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_config(tmp_path):
    path = os.path.join(str(tmp_path), "config.json")
    with open(path, "w") as f:
        json.dump(CONFIG, f)
    return path


def _train_args(tmp_path, max_steps, extra=()):
    return ["train", "-i", os.path.join(str(tmp_path), "train"), "-o",
            os.path.join(str(tmp_path), "log"), "-m", "m", "-s", "120", "-b", "16",
            "-t", "4e-3", "-x", str(max_steps), "--configure", _write_config(tmp_path),
            "--device", "cpu", *extra]


def test_cli_train_on_cpu_learns_and_writes_every_file(tmp_path):
    make_training_dir(os.path.join(str(tmp_path), "train"), n_files=3, n_bases=300, seed=0)
    make_training_dir(os.path.join(str(tmp_path), "valid"), n_files=1, n_bases=150, seed=1)
    result = cli.main(_train_args(tmp_path, 30, ["-v", os.path.join(str(tmp_path), "valid")]))
    losses = result["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    mdir = result["model_dir"]
    names = os.listdir(mdir)
    for want in ("model.json", "checkpoint", "train_config", "metrics.jsonl", "final-30.npz",
                 "ema-30.npz", "model-10.npz", "model-20.npz"):
        assert want in names, (want, names)
    with open(os.path.join(mdir, "checkpoint")) as f:
        assert f.read().strip() == "final-30.npz"
    rows = [json.loads(line) for line in open(os.path.join(mdir, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [10, 20, 30]
    assert all(r["valid_edit_distance"] is not None for r in rows)
    assert rows[0]["learning_rate"] == pytest.approx(4e-3)
    assert rows[-1]["learning_rate"] == pytest.approx(4e-5)  # past 83% of 30 steps

    # the port's checkpoint loads in JAX and gives the port's logits
    jtree, step = jckpt.restore_latest(mdir)
    assert step == 30
    cfg = jconfig.read_config(os.path.join(mdir, "model.json"))
    rng = np.random.RandomState(3)
    x = rng.randn(4, 120).astype(np.float32)
    sl = np.array([120, 100, 7, 0], np.int32)
    want = jmodel.apply_model(jtree, cfg, jnp.asarray(x), jnp.asarray(sl))
    tree, _ = tckpt.restore_latest(mdir)
    got = from_jax_params(tree, cfg, "cpu")(torch.tensor(x), torch.tensor(sl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def test_retrain_resumes_a_jax_checkpoint(tmp_path):
    make_training_dir(os.path.join(str(tmp_path), "train"), n_files=2, n_bases=200, seed=2)
    mdir = os.path.join(str(tmp_path), "log", "m")
    params = jmodel.init_model(jax.random.PRNGKey(5), CONFIG)
    jconfig.save_config(os.path.join(mdir, "model.json"), CONFIG)
    jckpt.save_checkpoint(mdir, params, 4)
    # what the port restores is JAX's tree, leaf for leaf
    tree, step = tckpt.restore_latest(mdir)
    assert step == 4
    back = to_numpy_tree(from_jax_params(tree, CONFIG, "cpu"))
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                               jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(kp))
    args = _train_args(tmp_path, 6, ["--retrain"])
    args[args.index("--configure") + 1] = "missing.json"  # --retrain reads model.json
    result = cli.main(args)
    assert result["losses"] and len(result["losses"]) == 1  # steps 5 and 6 only
    assert tckpt.restore_latest(mdir)[1] == 6


def test_train_without_gpu_raises_and_each_source_loads_or_raises_as_jax(tmp_path):
    from chiron_tpu.train import loop as jloop

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    train_dir = os.path.join(str(tmp_path), "train")
    make_training_dir(train_dir, n_files=1, n_bases=100, seed=3)
    args = _train_args(tmp_path, 2)
    with pytest.raises(RuntimeError):
        cli.main(args[:-2])  # default --device cuda
    # data parallel on the CPU: two gloo ranks (one torch thread each), rank 0 writes
    two = cli.main(args + ["--n_devices", "2", "-o", os.path.join(str(tmp_path), "log2")])
    assert len(two["losses"]) == 1 and np.isfinite(two["losses"][0])
    assert "final-2.npz" in os.listdir(two["model_dir"])
    # a missing TFRecord, named by -f or by path, fails as in the JAX package
    with pytest.raises(FileNotFoundError):
        cli.main(args + ["-f", "x.tfrecord"])
    missing = os.path.join(str(tmp_path), "x.tfrecords")  # no such file: an empty walk
    assert tloop.load_dataset(missing, 120).n == jloop.load_dataset(missing, 120).n == 0
    # an empty data.meta: read_meta finds no signal_length
    bin_dir = os.path.join(str(tmp_path), "bin")
    os.makedirs(bin_dir)
    open(os.path.join(bin_dir, "data.meta"), "w").close()
    for load in (tloop.load_dataset, jloop.load_dataset):
        with pytest.raises(KeyError):
            load(bin_dir, 120)
    # the window cache is built, then served like the in-RAM Dataset
    cached = tloop.load_dataset(train_dir, 120, cache_dir=os.path.join(str(tmp_path), "cache"))
    assert cached.n == tloop.load_dataset(train_dir, 120).n > 0
    cached.close()


def _hparams(tmp_path, **kw):
    import types

    h = types.SimpleNamespace(
        data_dir=os.path.join(str(tmp_path), "train"), log_dir=os.path.join(str(tmp_path), "log"),
        model_name="m", validation=None, sequence_len=120, batch_size=8, step_rate=4e-3,
        max_steps=6, configure=_write_config(tmp_path), device="cpu", save_every=2)
    for k, v in kw.items():
        setattr(h, k, v)
    return h


def test_resample_after_epoch_reloads_with_a_growing_offset(tmp_path, monkeypatch):
    make_training_dir(os.path.join(str(tmp_path), "train"), n_files=1, n_bases=80, seed=4)
    skips = []
    real = tloop.load_dataset

    def spy(*args, **kw):
        skips.append(kw.get("skip_start", 10))
        return real(*args, **kw)

    monkeypatch.setattr(tloop, "load_dataset", spy)
    n = real(os.path.join(str(tmp_path), "train"), 120).n
    # a batch of n rows ends the first epoch, so the second step reloads with
    # the offset 3 further on (and later reloads keep adding 3)
    tloop.train(_hparams(tmp_path, batch_size=n, max_steps=3, resample_after_epoch=1))
    assert skips[:2] == [10, 13] and np.all(np.diff(skips) == 3)


def test_rss_guard_checkpoints_and_requests_restart(tmp_path):
    make_training_dir(os.path.join(str(tmp_path), "train"), n_files=1, n_bases=120, seed=5)
    result = tloop.train(_hparams(tmp_path, max_rss_gb=0.001, max_steps=10))
    assert result["restart"] is True and result["step"] == 2
    names = os.listdir(result["model_dir"])
    assert "model-2.npz" in names and "rss-ema-2.npz" in names
    assert tckpt.restore_latest(result["model_dir"])[1] == 2  # resumes from the raw params


@pytest.mark.parametrize("cell_type,layer_type", [("GRU", "rna"), ("BNLSTM", "normal")])
def test_cli_train_then_call_with_other_cells(tmp_path, cell_type, layer_type):
    """model.json carries the cell and layer type: `train` and then `call`
    with the model it wrote run with no other flag."""
    data = os.path.join(str(tmp_path), "train")
    make_training_dir(data, n_files=2, n_bases=200, seed=2)
    config = {**CONFIG, "rnn": {**CONFIG["rnn"], "cell_type": cell_type,
                                "layer_type": layer_type}}
    cfg_path = os.path.join(str(tmp_path), "cell.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    args = _train_args(tmp_path, 10)
    args[args.index("--configure") + 1] = cfg_path
    result = cli.main(args)
    assert len(result["losses"]) == 1 and np.isfinite(result["losses"][0])
    with open(os.path.join(result["model_dir"], "model.json")) as f:
        assert json.load(f)["rnn"]["cell_type"] == cell_type
    tree, step = tckpt.restore_latest(result["model_dir"])
    assert step == 10
    assert ("wh_g" if cell_type == "GRU" else "scale_c") in tree["rnn"]["stack"]["layers"][0]["fw"]
    out = os.path.join(str(tmp_path), "out")
    res = cli.main(["call", "-i", data, "-o", out, "-m", result["model_dir"], "-b", "8", "-l",
                    "120", "-j", "110", "--beam", "5", "--device", "cpu"])
    assert res["n_files"] == 2 and res["total_windows"] > 0
    assert len(os.listdir(os.path.join(out, "result"))) == 2
