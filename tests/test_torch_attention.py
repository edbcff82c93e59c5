"""The port's attention decode head (chiron_tpu_torch/models/attention.py,
carried across by params.attention_from_jax) against the JAX package's
(chiron_tpu/models/attention.py) on the CPU, with the JAX weights, at
E = 32, hidden 16, B = 4, T = 50 and 12 steps: greedy tokens equal, logits
within 1e-5 of max |logit|, the teacher-forced loss within 1e-6 relative and
each leaf's gradient (autograd against jax.grad) within 1e-4 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.models import attention as ja
from chiron_tpu_torch.models import attention as ta
from chiron_tpu_torch.params import AttentionDecoder, attention_from_jax

E, HIDDEN, B, T, STEPS = 32, 16, 4, 50, 12
LEAVES = ("embed", "att_we", "att_wh", "att_v", "gru_wx", "gru_wh", "gru_b", "out_w", "out_b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: several test workers' torch
    thread pools competing for the cores made its CPU model runs ~20x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tree(seed):
    tree = ja.init_attention_decoder(jax.random.PRNGKey(seed), enc_dim=E, hidden=HIDDEN)
    # biases drawn too, so that their use is held as well as their gradient
    rng = np.random.RandomState(seed)
    tree["gru_b"] = jnp.asarray(rng.randn(3 * HIDDEN).astype(np.float32) * 0.1)
    tree["out_b"] = jnp.asarray(rng.randn(5).astype(np.float32) * 0.1)
    return tree


def _inputs(seed):
    rng = np.random.RandomState(100 + seed)
    enc = rng.randn(B, T, E).astype(np.float32)
    lens = np.asarray([T, 41, 17, 1], np.int32)
    targets = rng.randint(0, 4, (B, STEPS)).astype(np.int32)
    tlens = np.asarray([STEPS, 9, 4, 0], np.int32)
    targets[2, 4:] = -1  # padding, as the training labels carry it
    return enc, lens, targets, tlens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_tokens_and_logits(seed):
    tree = _jax_tree(seed)
    enc, lens, _, _ = _inputs(seed)
    jt, jl = ja.attention_decode(tree, jnp.asarray(enc), jnp.asarray(lens), STEPS)
    dec = attention_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    tt, tl = dec.decode(torch.from_numpy(enc), torch.from_numpy(lens), STEPS)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (B, STEPS)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    jl = np.asarray(jl)
    assert tuple(tl.shape) == jl.shape == (B, STEPS, 5)
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_teacher_forced_loss_and_gradients(seed):
    tree = _jax_tree(seed)
    enc, lens, targets, tlens = _inputs(seed)
    jloss, jgrad = jax.value_and_grad(ja.attention_teacher_forcing_loss)(
        tree, jnp.asarray(enc), jnp.asarray(lens), jnp.asarray(targets), jnp.asarray(tlens))
    dec = attention_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    dec.requires_grad_(True)
    loss = dec.loss(torch.from_numpy(enc), torch.from_numpy(lens), torch.from_numpy(targets),
                    torch.from_numpy(tlens))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert sorted(dec.flat) == sorted(LEAVES)
    for name in LEAVES:
        want = np.asarray(jgrad[name])
        got = dec.flat[name].grad.numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_gru_cell_applies_the_reset_gate_before_the_recurrent_product():
    tree = jax.tree_util.tree_map(np.asarray, _jax_tree(3))
    rng = np.random.RandomState(3)
    x = rng.randn(B, HIDDEN + E).astype(np.float32)
    h = rng.randn(B, HIDDEN).astype(np.float32)
    want = np.asarray(ja._gru_cell(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                   jnp.asarray(h)))
    params = {k: torch.tensor(v) for k, v in tree.items()}
    got = ta._gru_cell(params, torch.from_numpy(x), torch.from_numpy(h)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    # nn.GRU's form, r * (h @ wh), is another function
    hd = HIDDEN
    wx, wh, b = params["gru_wx"], params["gru_wh"], params["gru_b"]
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    r, u = torch.sigmoid(xt @ wx[:, :2 * hd] + ht @ wh[:, :2 * hd] + b[:2 * hd]).split(hd, -1)
    cand = torch.tanh(xt @ wx[:, 2 * hd:] + r * (ht @ wh[:, 2 * hd:]) + b[2 * hd:])
    assert np.abs((u * ht + (1 - u) * cand).numpy() - want).max() > 1e-3


def test_attention_masks_frames_past_the_length():
    tree = jax.tree_util.tree_map(np.asarray, _jax_tree(4))
    params = {k: torch.tensor(v) for k, v in tree.items()}
    enc = torch.from_numpy(np.random.RandomState(4).randn(B, T, E).astype(np.float32))
    lens = torch.tensor([T, 30, 5, 1])
    proj, mask, h = ta._setup(params, enc, lens)
    context, weights = ta._attend(params, enc, proj, mask, h + 0.3)
    assert float(weights[~mask].abs().max()) == 0.0
    assert torch.allclose(weights.sum(-1), torch.ones(B))
    jc, jw = ja._attend(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(enc.numpy()),
                        jnp.asarray(mask.numpy()), jnp.asarray((h + 0.3).numpy()))
    assert np.abs(np.asarray(jw) - weights.numpy()).max() <= 1e-6
    assert np.abs(np.asarray(jc) - context.numpy()).max() <= 1e-5


def test_init_matches_jax_shapes_and_limits():
    got = ta.init_attention_decoder(torch.Generator().manual_seed(0), E, HIDDEN)
    want = ja.init_attention_decoder(jax.random.PRNGKey(0), E, HIDDEN)
    assert sorted(got) == sorted(want) == sorted(LEAVES)
    for k in LEAVES:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32
        lim = float(np.abs(np.asarray(want[k])).max())
        if lim:  # xavier-uniform leaves share their limit; biases are zero
            fan = sum(want[k].shape[-2:]) if want[k].ndim > 1 else 2 * want[k].shape[0]
            assert float(got[k].abs().max()) <= np.sqrt(6.0 / fan) + 1e-7
        else:
            assert float(got[k].abs().max()) == 0.0
    assert ta.GO_TOKEN == ja.GO_TOKEN == 5
    dec = attention_from_jax({k: v.numpy() for k, v in got.items()}, "cpu")
    assert isinstance(dec, AttentionDecoder)
    assert not any(p.requires_grad for p in dec.parameters())


def test_attention_from_jax_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    tree = jax.tree_util.tree_map(np.asarray, _jax_tree(5))
    with pytest.raises(RuntimeError):
        attention_from_jax(tree)


@pytest.mark.parametrize("layer_num", [2, 0])
def test_encode_is_what_the_head_reads(layer_num):
    """Basecaller.encode (the attention decoder's encodings): the features
    whose head is apply_model's logits, bit for bit."""
    from chiron_tpu_torch.models import model as tmodel
    from chiron_tpu_torch.models import rnn as trnn
    from chiron_tpu_torch.params import from_jax_params, to_numpy_tree

    config = {"cnn": {"model": "dna_model1"},
              "rnn": {"layer_num": layer_num, "hidden_num": 16, "cell_type": "LSTM",
                      "layer_type": "normal"}}
    tree = tmodel.init_model(torch.Generator().manual_seed(9), config)
    model = from_jax_params(to_numpy_tree(from_jax_params(tree, config, "cpu")), config, "cpu")
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(3, 60).astype(np.float32))
    sl = torch.tensor([60, 41, 7], dtype=torch.int32)
    with torch.no_grad():
        fea = model.encode(x, sl)
        want = model(x, sl)
        head = (trnn.rnn_head(model.params["rnn"]["head"], fea) if layer_num
                else tmodel.cnn_logit(model.params["cnn_logit"], fea))
    assert fea.shape[:2] == want.shape[:2] and fea.shape[-1] == (32 if layer_num else 256)
    assert torch.equal(head, want)
