"""The port's data parallelism (chiron_tpu_torch/parallel, ROADMAP A10) on
the CPU against the JAX package's mesh.

Two semantics are held:
- the sharded decode normalises each shard by its own batch moments (the
  JAX package's ``jax.shard_map`` step): with a batch-stat BN front it equals
  one step per shard, and differs from the unsharded step;
- the data-parallel train step is the global batch's (the JAX package's
  GSPMD step): two gloo ranks equal JAX's ``make_train_step`` over
  ``make_mesh(2)``.

Tolerances: decodes and lengths equal, scores and path probabilities rtol
1e-5 / atol 1e-6 (tests/test_dist.py's); params after SGD steps rtol 1e-5 /
atol 1e-6 (tests/test_multihost.py:208-211's), but for the elements of
res1's branch1 and conv2a, which read the 1-channel signal straight into a
batch-stat BN, whose initial |w| is below SINGULAR_W: there w^2 var(x) is
under 10 eps, the gradient grows as the weight nears 0, and at lr 1e-3 such
a weight crosses 0 within three steps, so a last-bit difference of the
moments' sum order (two ranks' partial sums against one sum) moves it by up
to ~3e-6; they are held within 1e-4 (a tenth of one step), and every other
element to the stated tolerance. Losses 1e-5 relative. Adam's params are
not compared: its first update is +-lr for any gradient that is not tiny,
and a near-zero gradient's sign flips with the order of summation.
Validation logits on the ranks' rows: 5e-4 of max |logit| (tests/
test_torch_model.py's, batch-stat convs and an RNN summed in another
order). The BNLSTM step (per-step moments over the global batch) is held
to JAX's 2-device mesh step at the same tolerances as the LSTM's.

Cost: three spawned process groups (one run_ranks group for the train
steps, the CLI's own two ranks, two `call` processes), each rank on one
torch thread, every join bounded by 120 s.
"""

import ast
import functools
import json
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.eval import pipeline as jpipe
from chiron_tpu.io.labels import _in_shard as j_in_shard
from chiron_tpu.models import model as jmodel
from chiron_tpu.parallel import dist as jdist
from chiron_tpu.parallel import mesh as jmesh
from chiron_tpu.train import checkpoint as jckpt
from chiron_tpu.train import loop as jloop
from chiron_tpu_torch.eval import pipeline as tpipe
from chiron_tpu_torch.io.labels import _in_shard
from chiron_tpu_torch.parallel import dist as tdist
from chiron_tpu_torch.parallel import dryrun
from chiron_tpu_torch.parallel import mesh as tmesh
from chiron_tpu_torch.params import from_jax_params
from synth import make_training_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
LSTM = {"cnn": {"model": "dna_model1"},
        "rnn": {"layer_num": 1, "hidden_num": 16, "cell_type": "LSTM", "layer_type": "normal"},
        "opt_method": "SGD", "fl_gamma": 0}
BNLSTM = {**LSTM, "rnn": {**LSTM["rnn"], "cell_type": "BNLSTM", "hidden_num": 8}}
SINGULAR_W = 0.01
ONE_CHANNEL_BN = ("['cnn']['res1']['branch1']['w']", "['cnn']['res1']['conv2a']['w']")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread (so each spawned rank takes
    one, this process's threads / ranks): several test workers' torch thread
    pools competing for the cores made these tests ~15x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_tree(config, seed=0):
    return jax.tree_util.tree_map(np.asarray, jmodel.init_model(jax.random.PRNGKey(seed), config))


@pytest.mark.parametrize("n,k", [(1, 1), (57, 4), (10, 2), (100, 3), (33, 8)])
def test_file_shards_and_padding_match_jax(n, k):
    files = [f"sub{i % 3}/read{i}.signal" for i in range(n)]
    shards = [tdist.shard_files(files, k, i) for i in range(k)]
    assert shards == [jdist.shard_files(files, k, i) for i in range(k)]
    assert sorted(sum(shards, [])) == sorted(files)
    for i in range(k):
        assert [f for f in files if _in_shard(f, (i, k))] == \
            [f for f in files if j_in_shard(f, (i, k))] == shards[i]
    rng = np.random.RandomState(n)
    arrays = [rng.randn(n, 3).astype(np.float32), rng.randint(0, 9, n).astype(np.int32)]
    got, got_n = tmesh.pad_to_multiple(arrays, k)
    want, want_n = jmesh.pad_to_multiple(arrays, k)
    assert got_n == want_n == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_mesh_rows_and_device_checks():
    assert tmesh.make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert tmesh.make_mesh(0, device="cpu") == [torch.device("cpu")]
    assert tmesh.make_mesh(2, devices=["cpu", "cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match=r"torch.cuda.device_count\(\) is"):
        tmesh.make_mesh(torch.cuda.device_count() + 1, device="cuda")
    batch = {"x": np.arange(12).reshape(6, 2), "y": torch.arange(6)}
    parts = [tmesh.shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    np.testing.assert_array_equal(tmesh.local_rows([p["y"] for p in parts]), np.arange(6))
    with pytest.raises(ValueError, match="equal shards"):
        tmesh.shard_batch(batch, 0, 4)
    assert tdist.process_info() == (0, 1)
    assert not tdist.moments_are_global()
    with pytest.raises(RuntimeError, match="initialised process group"):
        with tdist.global_moments():
            pass


@pytest.mark.parametrize("beam", [0, 5])
def test_sharded_decode_matches_jax_per_shard_moments(beam):
    """B = 16 over 8 devices: the port's buffer equals eight 2-row steps bit
    for bit, and JAX's n_devices=8 step (decodes exact); the unsharded step
    differs (batch-stat BN over the whole batch)."""
    tree = _jax_tree(LSTM)
    rng = np.random.RandomState(0)
    x = rng.randn(16, 64).astype(np.float32)
    sl = np.full((16,), 64, np.int32)
    jbuf = np.asarray(jpipe.make_decode_step(LSTM, 64, beam, 16, n_devices=8)(
        tree, jnp.asarray(x), jnp.asarray(sl)))
    model = from_jax_params(tree, LSTM, "cpu")
    step = functools.partial(tpipe.decode_step, beam=beam)
    sharded = tdist.make_sharded_decode_step(step, tmesh.make_mesh(8, device="cpu"))
    buf = sharded(model, torch.tensor(x), torch.tensor(sl)).numpy()
    parts = np.concatenate([step(model, torch.tensor(x[i:i + 2]), torch.tensor(sl[i:i + 2]))
                            .numpy() for i in range(0, 16, 2)])
    assert buf.tobytes() == parts.tobytes()
    got, want = tpipe.unpack_step_outputs(buf), jpipe.unpack_step_outputs(jbuf)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-6)
    whole = tpipe.unpack_step_outputs(step(model, torch.tensor(x), torch.tensor(sl)).numpy())
    assert np.abs(whole[3] - got[3]).max() > 1e-3  # per-shard moments move the path prob


def test_cli_call_n_devices_matches_jax_pipeline(tmp_path):
    """`call --n_devices 2 --device cpu` (each batch in two shards, each
    normalised by its own moments) writes the JAX pipeline's n_devices=2
    fastq byte for byte; the batch must split evenly."""
    from chiron_tpu_torch import cli

    root = str(tmp_path)
    sig = os.path.join(root, "signal")
    make_training_dir(sig, n_files=2, n_bases=120, seed=1)
    model = os.path.join(root, "model")
    jckpt.save_checkpoint(model, _jax_tree(LSTM, 3), 1)
    _write_config(os.path.join(model, "model.json"), LSTM)
    flags = types.SimpleNamespace(
        input=sig, output=os.path.join(root, "jax"), model=model, start=0, batch_size=8,
        segment_len=100, jump=95, threads=0, beam=0, extension="fastq", concise=True,
        mode="dna", reverse_fast5=False, recursive=True, n_devices=2)
    jpipe.run(flags)
    args = ["call", "-i", sig, "-o", os.path.join(root, "port"), "-m", model, "-b", "8", "-l",
            "100", "-j", "95", "--beam", "0", "--concise", "--device", "cpu"]
    cli.main(args + ["--n_devices", "2"])
    for name in os.listdir(os.path.join(root, "jax", "result")):
        with open(os.path.join(root, "jax", "result", name)) as a, \
                open(os.path.join(root, "port", "result", name)) as b:
            assert a.read() == b.read(), name
    with pytest.raises(ValueError, match="not divisible"):
        cli.main(args + ["--n_devices", "3"])


def test_call_n_devices_inside_a_group_raises(monkeypatch):
    """Inside a process group each rank basecalls its file shard on its own
    device: `call --n_devices` k > 1 there raises (as `train` does) rather
    than put every rank's shards on the same devices."""
    monkeypatch.setattr(tpipe, "process_info", lambda: (1, 2))
    flags = types.SimpleNamespace(device="cpu", n_devices=2, batch_size=8)
    with pytest.raises(ValueError, match="inside a process group of 2 ranks"):
        tpipe.evaluation(flags)


def _global_batch(rng, b=16, t=48, u=8):
    seq_len = np.array([48, 48, 44, 36, 48, 25, 48, 20] * (b // 8), np.int32)
    label_len = rng.randint(3, u + 1, size=b).astype(np.int32)
    labels = np.full((b, u), -1, np.int32)
    for i in range(b):
        labels[i, :label_len[i]] = rng.randint(0, 4, label_len[i])
    return {"signal": rng.randn(b, t).astype(np.float32), "seq_len": seq_len,
            "label": labels, "label_len": label_len}


def _jax_logits(config, params, batch):
    return np.asarray(jmodel.apply_model(jax.device_get(params), config,
                                         jnp.asarray(batch["signal"]),
                                         jnp.asarray(batch["seq_len"])))


def _jax_mesh_steps(config, tree, batches, opt_name, lr=1e-3, n_devices=2):
    mesh = jmesh.make_mesh(n_devices)
    params = jmesh.replicate(mesh, tree)
    tx = jloop.make_optimizer(opt_name, lr, 100)
    opt_state = jmesh.replicate(mesh, tx.init(jax.device_get(params)))
    step = jloop.make_train_step(config, tx, 0.0)
    ema, losses = params, []
    for i, batch in enumerate(batches):
        params, ema, opt_state, loss = step(params, ema, opt_state,
                                            jmesh.shard_batch(mesh, dict(batch)), np.float32(i))
        losses.append(float(loss))
    return losses, _leaves(jax.device_get(params)), _jax_logits(config, params, batches[-1])


def test_two_gloo_ranks_train_as_jax_mesh_step():
    """3 SGD steps and 3 Adam steps (LSTM), one SGD step (BNLSTM: per-step
    moments over the global batch), each on two ranks of 8 rows."""
    rng = np.random.RandomState(1)
    batches = [_global_batch(rng) for _ in range(3)]
    jobs = [dict(config=LSTM, tree=_jax_tree(LSTM), batches=batches, opt_name="SGD"),
            dict(config=LSTM, tree=_jax_tree(LSTM), batches=batches, opt_name="Adam"),
            dict(config=BNLSTM, tree=_jax_tree(BNLSTM, 2), batches=batches[:1],
                 opt_name="SGD")]

    def jax_side():  # compiled while the ranks run
        return [_jax_mesh_steps(job["config"], job["tree"], job["batches"], job["opt_name"])
                for job in jobs]

    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(jax_side)
        ranks = tdist.run_ranks(dryrun.data_parallel_jobs, ["cpu", "cpu"], args=(jobs,),
                                threads=1, timeout=JOIN_S)
        refs = refs.result(timeout=JOIN_S)
    for job, (losses, want, logits), r0, r1 in zip(jobs, refs, *ranks):
        label = f"{job['config']['rnn']['cell_type']} {job['opt_name']}"
        assert r0["losses"] == r1["losses"], label
        p0, p1 = _leaves(r0["params"]), _leaves(r1["params"])
        assert all(p0[k].tobytes() == p1[k].tobytes() for k in p0), label  # bit for bit
        np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5, err_msg=label)
        if job["opt_name"] == "SGD":
            assert p0.keys() == want.keys()
            init = _leaves(job["tree"])
            for k in want:
                singular = (np.abs(init[k]) < SINGULAR_W) if k in ONE_CHANNEL_BN else \
                    np.zeros(init[k].shape, bool)
                assert singular.mean() < 0.2, k
                np.testing.assert_allclose(p0[k][~singular], want[k][~singular], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{label} {k}")
                np.testing.assert_allclose(p0[k][singular], want[k][singular], rtol=0,
                                           atol=1e-4, err_msg=f"{label} {k} near 0")
        assert r0["launches"] == {"lstm_fwd_residuals": 0, "lstm_bwd": 0}  # plain on the CPU
        if job["opt_name"] == "SGD":
            # a validation forward on the ranks' rows: moments over the global batch
            # (a BNLSTM layer through the recurrence, not the kernels' per-rank ones)
            got = np.concatenate([r0["logits"], r1["logits"]])
            np.testing.assert_allclose(got, logits, rtol=0, atol=5e-4 * np.abs(logits).max(),
                                       err_msg=label)


def test_bnlstm_validation_under_a_group_runs_the_recurrence(monkeypatch):
    """Inside global_moments a BNLSTM inference forward takes the training
    recurrence (moments over the ranks), never the inference kernels, whose
    moments are their own rows'."""
    import torch.distributed as dist

    from chiron_tpu_torch.models import rnn

    from chiron_tpu_torch.models.model import init_model

    model = from_jax_params(init_model(torch.Generator().manual_seed(0), BNLSTM), BNLSTM, "cpu")
    x, sl = torch.randn(4, 48), torch.tensor([48, 40, 48, 30], dtype=torch.int32)
    want = model(x, sl)

    def kernel(*args, **kw):
        raise AssertionError("a BNLSTM inference kernel ran with global moments")

    monkeypatch.setattr(rnn, "bibnlstm_layer", kernel)
    monkeypatch.setattr(rnn, "bnlstm_layer", kernel)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{tdist.free_port()}",
                            world_size=1, rank=0)
    try:
        with torch.no_grad(), tdist.global_moments():
            got = model(x, sl)
            fw = model.params["rnn"]["stack"]["layers"][0]["fw"]  # a forward-only stack
            uni = rnn.unirnn_layers({"layers": [fw], "w_class": torch.zeros(8, 5),
                                     "b_class": torch.zeros(5)}, torch.randn(4, 48, 256), sl)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want) and uni.shape == (4, 48, 5)


def test_world_of_one_equals_no_group_bit_for_bit():
    """Inside a gloo group of one rank every collective runs and changes no
    bit: the step equals the step without a group."""
    import torch.distributed as dist

    batches = [_global_batch(np.random.RandomState(3), b=8)]
    for config in (LSTM, BNLSTM):
        tree = _jax_tree(config)
        alone = dryrun.data_parallel_steps(0, 1, torch.device("cpu"), config, tree, batches)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{tdist.free_port()}",
                                world_size=1, rank=0)
        try:
            grouped = dryrun.data_parallel_steps(0, 1, torch.device("cpu"), config, tree,
                                                 batches)
        finally:
            dist.destroy_process_group()
        assert grouped["losses"] == alone["losses"]
        for k, g in alone["grads"].items():
            assert g.tobytes() == grouped["grads"][k].tobytes(), k
        a, b = _leaves(alone["params"]), _leaves(grouped["params"])
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def _write_config(path, config):
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def test_cli_train_two_ranks_matches_jax_train(tmp_path):
    """`train --n_devices 2 --device cpu -v` (two gloo ranks) from a JAX
    checkpoint against JAX `train` with n_devices=2 from the same one, SGD:
    the logged loss and validation edit distance; only rank 0 writes."""
    from chiron_tpu_torch import cli

    root = str(tmp_path)
    make_training_dir(os.path.join(root, "train"), n_files=3, n_bases=200, seed=5)
    make_training_dir(os.path.join(root, "valid"), n_files=1, n_bases=150, seed=6)
    config = {**LSTM, "fl_gamma": 2}
    tree = _jax_tree(config, 4)
    for log in ("port", "jax"):
        mdir = os.path.join(root, log, "m")
        jckpt.save_checkpoint(mdir, tree, 0)
        _write_config(os.path.join(mdir, "model.json"), config)
    args = ["train", "-i", os.path.join(root, "train"), "-v", os.path.join(root, "valid"),
            "-o", os.path.join(root, "port"), "-m", "m", "-s", "120", "-b", "16", "-t", "1e-2",
            "-x", "3", "--retrain", "--n_devices", "2", "--device", "cpu"]
    hparams = types.SimpleNamespace(
        data_dir=os.path.join(root, "train"), validation=os.path.join(root, "valid"),
        log_dir=os.path.join(root, "jax"), model_name="m", sequence_len=120, batch_size=16,
        step_rate=1e-2, max_steps=3, retrain=True, n_devices=2)
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(jloop.train, hparams)  # while the ranks run
        result = cli.main(args)
        want = want.result(timeout=JOIN_S)
    np.testing.assert_allclose(result["losses"], want["losses"], rtol=1e-5)
    rows = [json.loads(line) for line in open(os.path.join(result["model_dir"],
                                                          "metrics.jsonl"))]
    jrows = [json.loads(line) for line in open(os.path.join(want["model_dir"],
                                                           "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == [3]  # one writer
    assert rows[0]["valid_edit_distance"] == pytest.approx(jrows[0]["valid_edit_distance"],
                                                           abs=1e-6)
    names = set(os.listdir(result["model_dir"]))
    assert {"final-3.npz", "ema-3.npz", "model-3.npz", "train_config"} <= names
    assert not any("shard" in n for n in names)


def test_two_call_processes_shard_files_as_one(tmp_path):
    """Two `call` processes in one gloo group (torchrun's environment) each
    basecall their hash shard; the union of their fastq files equals a
    one-process run byte for byte. The front is tests/test_multihost.py's
    `custom` one, without batch norm: a batch packs windows across files, so
    a batch-stat BN front decodes a read differently beside other reads."""
    root = str(tmp_path)
    sig = os.path.join(root, "signal")  # .signal/.label pairs: `call` reads the .signal files
    make_training_dir(sig, n_files=6, n_bases=80, seed=0)
    model = os.path.join(root, "model")
    config = {**LSTM, "cnn": {"model": "custom"}, "rnn": {**LSTM["rnn"], "hidden_num": 8}}
    jckpt.save_checkpoint(model, _jax_tree(config), 1)
    _write_config(os.path.join(model, "model.json"), config)

    def args(out):
        return ["call", "-i", sig, "-o", os.path.join(root, out), "-m", model, "-b", "8",
                "-l", "100", "-j", "95", "--beam", "2", "--device", "cpu"]

    from chiron_tpu_torch import cli

    cli.main(args("single"))
    code = ("import sys, torch\ntorch.set_num_threads(1)\nfrom chiron_tpu_torch import cli\n"
            "cli.main(sys.argv[1:])\n")
    port = tdist.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args(f"rank{rank}")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      cwd=REPO, env=env))
    try:
        outs = [p.communicate(timeout=JOIN_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "Process 0/2" in outs[0] and "Process 1/2" in outs[1]

    def fastqs(out):
        d = os.path.join(root, out, "result")
        return {f: open(os.path.join(d, f)).read() for f in os.listdir(d)}

    single, shard0, shard1 = fastqs("single"), fastqs("rank0"), fastqs("rank1")
    assert len(single) == 6 and shard0 and shard1 and not set(shard0) & set(shard1)
    assert {**shard0, **shard1} == single


def _launch_calls(tree):
    """Calls of a kernel library's ``*_launch`` entry: ``lib.x_launch(...)``
    or ``getattr(lib, "..._launch")(...)``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr.endswith("_launch"):
            yield node
        elif isinstance(f, ast.Call) and isinstance(f.func, ast.Name) and \
                f.func.id == "getattr" and "_launch" in ast.unparse(f.args[1]):
            yield node


def test_every_kernel_launch_runs_under_its_device():
    ops = os.path.join(REPO, "chiron_tpu_torch", "ops")
    found = 0
    for name in sorted(os.listdir(ops)):
        if not name.endswith(".py"):
            continue
        src = open(os.path.join(ops, name)).read()
        tree = ast.parse(src)
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    ast.unparse(item.context_expr).startswith("cuda_build.on_device(")
                    for item in node.items):
                guarded |= {id(n) for n in ast.walk(node)}
        # a launch entry may not be aliased (fn = lib.x_launch) and called elsewhere
        for node in ast.walk(tree):
            value = getattr(node, "value", None)
            entry = isinstance(value, ast.Attribute) and value.attr.endswith("_launch") or \
                isinstance(value, ast.Call) and ast.unparse(value.func) == "getattr" and \
                "_launch" in ast.unparse(value)
            assert not (isinstance(node, ast.Assign) and entry), \
                f"{name}:{node.lineno}: launch entry aliased: {ast.unparse(node)}"
        for call in _launch_calls(tree):
            found += 1
            assert id(call) in guarded, \
                f"{name}:{call.lineno}: kernel launch outside cuda_build.on_device"
    # conv_bn, bilstm, lstm x2 (csrc/bilstm.cu and csrc/lstm_c16.cu), beam x2,
    # lstm_grad x2, gru, bnlstm, ctc_loss x2, crf x3
    assert found == 15


def test_synthetic_launch_outside_the_device_is_caught():
    bad = ast.parse("def f(lib, x):\n    return lib.conv_bn_launch(x)\n")
    good = ast.parse("def f(lib, x, dev):\n    with cuda_build.on_device(dev):\n"
                     "        return getattr(lib, f'{x}_launch')(x)\n")
    assert len(list(_launch_calls(bad))) == 1 and len(list(_launch_calls(good))) == 1
