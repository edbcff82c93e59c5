"""The port's training pieces against the JAX package on CPU: data loading,
optimizers and the LR schedule, one train step, and the registered weights.

Tolerances (float32 on both sides):
- optimizer updates against optax: rtol 1e-5 / atol 1e-7 (the same formulas,
  evaluated in another order);
- one dna_model1 train step: loss rtol 1e-5; each gradient leaf within 1e-4
  of that leaf's max |grad| (12 batch-stat convs and an LSTM stack whose
  float32 sums run in another order); params after 3 Adam steps and the
  EMA: at least 99% of all elements within 1e-4 absolute (a tenth of one
  step at lr 1e-3; measured: 0.24% of params and 0.13% of the EMA beyond
  it), and every element within 6 * lr. Adam scales each element's step to
  ~lr whatever its gradient's size, so an element whose gradient is at the
  float32 noise floor (dead relu channels, directions a batch-stat BN
  cancels: |g| ~ 1e-7 of its leaf's max) may step either way in the two
  frameworks, and after one step the two runs evaluate their next
  gradients at slightly different params.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chiron_tpu.io.labels import read_raw_data_sets as j_read_raw_data_sets
from chiron_tpu.models import model as jmodel
from chiron_tpu.train import loop as jloop
from chiron_tpu.train import checkpoint as jckpt
from chiron_tpu_torch.io.labels import read_raw_data_sets
from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
from chiron_tpu_torch.train import checkpoint as tckpt
from chiron_tpu_torch.train import loop as tloop
from synth import make_training_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "chiron_tpu", "model")


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("seq_len,k_mer", [(200, 1), (120, 3)])
def test_read_raw_data_sets_matches_jax(tmp_path, seq_len, k_mer):
    make_training_dir(str(tmp_path), n_files=3, n_bases=150, seed=4)
    got = read_raw_data_sets(str(tmp_path), seq_length=seq_len, k_mer=k_mer)
    want = j_read_raw_data_sets(str(tmp_path), seq_length=seq_len, k_mer=k_mer)
    assert len(got[0]) > 10
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("max_steps", [1, 6, 100, 10000])
def test_lr_schedule_matches_optax(max_steps):
    t_sched = tloop.make_lr_schedule(4e-3, max_steps)
    j_sched = jloop.make_lr_schedule(4e-3, max_steps)
    edges = {0, 1, int(max_steps * 0.66), int(max_steps * 0.83), max_steps}
    for c in sorted({e + d for e in edges for d in (-1, 0, 1) if e + d >= 0}):
        np.testing.assert_allclose(t_sched(c), float(j_sched(c)), rtol=1e-6)


@pytest.mark.parametrize("opt_name,clip", [("Adam", None), ("SGD", None), ("RMSProp", None),
                                          ("Momentum", None), ("Adam", 0.5)])
def test_optimizer_matches_optax(opt_name, clip):
    # max_steps 6: boundaries at counts 3 and 4, so 6 updates cross both
    rng = np.random.RandomState(11)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 0.1).astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    tx = jloop.make_optimizer(opt_name, 0.05, 6, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = tloop.make_optimizer(opt_name, 0.05, 6, tp.values(), clip_norm=clip)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{opt_name} {k} at {opt.count}")
    assert opt.count == 6


def _step_batch(rng, b=8, t=64, u=14):
    seq_len = np.array([64, 64, 60, 52, 40, 33, 20, 6], np.int32)[:b]
    label_len = rng.randint(3, u + 1, size=b).astype(np.int32)
    label_len[-1] = 9  # longer than its 6 frames: ignored
    labels = np.full((b, u), -1, np.int32)
    for i in range(b):
        labels[i, :label_len[i]] = rng.randint(0, 4, label_len[i])
    return {"signal": rng.randn(b, t).astype(np.float32), "seq_len": seq_len,
            "label": labels, "label_len": label_len}


def test_train_step_matches_jax():
    cfg = {"cnn": {"model": "dna_model1"},
           "rnn": {"layer_num": 2, "hidden_num": 16, "cell_type": "LSTM",
                   "layer_type": "normal"},
           "opt_method": "Adam", "fl_gamma": 2}
    params = jmodel.init_model(jax.random.PRNGKey(3), cfg)
    batch = _step_batch(np.random.RandomState(2))
    tx = jloop.make_optimizer("Adam", 1e-3, 100)
    jstep = jloop.make_train_step(cfg, tx, 2.0)
    jp, jema, jopt = params, params, tx.init(params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses, jgrads = [], None
    for it in range(3):
        jp, jema, jopt, loss = jstep(jp, jema, jopt, jbatch, np.float32(it))
        jlosses.append(float(loss))
        if it == 0:  # Adam's first moment after one update is 0.1 * grad
            jgrads = _leaves(jax.tree_util.tree_map(lambda m: m / 0.1, jopt[0].mu))

    tree = jax.tree_util.tree_map(np.asarray, params)
    model = from_jax_params(tree, cfg, "cpu").requires_grad_(True)
    ema = from_jax_params(tree, cfg, "cpu")
    opt = tloop.make_optimizer("Adam", 1e-3, 100, model.parameters())
    tstep = tloop.make_train_step(cfg, 2.0)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    for it in range(3):
        loss = tstep(model, ema, opt, tbatch, it)
        np.testing.assert_allclose(float(loss), jlosses[it], rtol=1e-5)
        if it == 0:
            grads = {k: p.grad.numpy().copy() for k, p in model.flat.items()}
    assert len(grads) == len(jgrads)
    for key, g in grads.items():
        jk = "".join(f"[{p!r}]" if not p.startswith("[") else p for p in key.split("/"))
        want = jgrads[jk]
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g - want).max()) <= 1e-4 * scale, key
    for got, want in ((to_numpy_tree(model), jp), (to_numpy_tree(ema), jema)):
        got, want = _leaves(got), _leaves(want)
        assert got.keys() == want.keys()
        diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in got])
        assert diff.max() <= 6 * 1e-3
        assert (diff > 1e-4).mean() < 0.01


def test_registered_parameters_and_round_trip():
    model_dir = os.path.join(MODELS, "DNA_default")
    config = tloop.C.read_config(os.path.join(model_dir, "model.json"))
    tree, _ = tckpt.restore_latest(model_dir)
    model = from_jax_params(tree, config, "cpu")
    named = dict(model.named_parameters())
    keys = set(jckpt._flatten(tree))
    assert {k.split(".", 1)[1] for k in named} == keys
    assert len(list(model.parameters())) == len(keys)
    assert all(isinstance(p, torch.nn.Parameter) and not p.requires_grad
               for p in model.parameters())
    # the params tree points at the registered Parameters themselves
    assert model.params["rnn"]["head"]["w_class"] is model.flat["rnn/head/w_class"]
    back = _leaves(to_numpy_tree(model))
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(back[k], v)
    # inference through the Basecaller equals apply_model on the plain tree
    from chiron_tpu_torch.models.model import apply_model

    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(3, 50).astype(np.float32))
    sl = torch.tensor([50, 31, 0], dtype=torch.int32)
    plain = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)), tree)
    torch.testing.assert_close(model(x, sl), apply_model(plain, config, x, sl), rtol=0, atol=0)
    assert len(model.state_dict()) == len(keys)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_distances_match_jax(seed):
    rng = np.random.RandomState(seed)
    b = rng.randint(1, 9)
    hyps = rng.randint(0, 4, (b, 20))
    refs = rng.randint(0, 4, (b, 16))
    hl, rl = rng.randint(0, 21, b), rng.randint(0, 17, b)
    np.testing.assert_array_equal(tloop.batched_edit_distance(hyps, hl, refs, rl),
                                  jloop.batched_edit_distance(hyps, hl, refs, rl))
    assert tloop.mean_edit_distance(hyps, hl, refs, rl) == \
        jloop.mean_edit_distance(hyps, hl, refs, rl)
    for i in range(b):
        assert tloop.edit_distance(list(hyps[i, :hl[i]]), list(refs[i, :rl[i]])) == \
            jloop.edit_distance(list(hyps[i, :hl[i]]), list(refs[i, :rl[i]]))


def test_dataset_batches_match_jax():
    rng = np.random.RandomState(6)
    arrays = (rng.randn(13, 5).astype(np.float32), rng.randint(1, 5, 13),
              rng.randint(0, 4, (13, 3)), rng.randint(1, 3, 13))
    ours, theirs = tloop.Dataset(*arrays), jloop.Dataset(*arrays)
    for size in (5, 5, 7, 13, 2):
        a, b = ours.next_batch(size), theirs.next_batch(size)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.epochs_completed == theirs.epochs_completed == 2
