"""The port's model (chiron_tpu_torch/{params,models}) against the JAX
package's apply_model on CPU, with JAX init_model weights carried across by
from_jax_params, and the bundled checkpoints loaded with no JAX.

Logits tolerance atol 5e-4: 12 batch-stat convs whose moments are summed in
another order (one-pass in the port, two-pass in XLA) compound through the
BiLSTM stack.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.models import initializers as jinit
from chiron_tpu.models import model as jmodel
from chiron_tpu.models import rnn as jrnn
from chiron_tpu.train import checkpoint as jckpt
from chiron_tpu_torch import config as tconfig
from chiron_tpu_torch.models import initializers as tinit
from chiron_tpu_torch.models import model as tmodel
from chiron_tpu_torch.models import rnn as trnn
from chiron_tpu_torch.params import from_jax_params, to_numpy_tree
from chiron_tpu_torch.train import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "chiron_tpu", "model")


CELLS = ("LSTM", "GRU", "BNLSTM")
LAYER_TYPES = ("normal", "rna")


def _config(front, cell_type="LSTM", layer_type="normal"):
    return {"cnn": {"model": front},
            "rnn": {"layer_num": 2, "hidden_num": 16, "cell_type": cell_type,
                    "layer_type": layer_type}}


def _shapes(tree):
    return {jax.tree_util.keystr(k): tuple(np.shape(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("front,seg", [("dna_model1", 64), ("slow_model1", 64),
                                       ("rna_model2", 100)])
def test_apply_model_matches_jax(front, seg):
    config = _config(front)
    params = jmodel.init_model(jax.random.PRNGKey(1), config)
    rng = np.random.RandomState(0)
    x = rng.randn(4, seg).astype(np.float32)
    t_out = jmodel.output_len(config, seg)
    seq_len = np.array([t_out, t_out - 3, 1, 0], np.int32)
    want = jmodel.apply_model(params, config, jnp.asarray(x), jnp.asarray(seq_len))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), config, "cpu")
    got = model(torch.tensor(x), torch.tensor(seq_len))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


@pytest.mark.parametrize("cell_type,layer_type", [("GRU", "normal"), ("BNLSTM", "normal"),
                                                  ("GRU", "rna"), ("BNLSTM", "rna"),
                                                  ("LSTM", "rna")])
def test_apply_model_other_cells_match_jax(cell_type, layer_type):
    """Within 5e-4 of max |logit| (the batch-stat convs' sum order, and for
    BNLSTM the per-step batch moments, compound through the stack)."""
    config = _config("dna_model1", cell_type, layer_type)
    params = jmodel.init_model(jax.random.PRNGKey(2), config)
    rng = np.random.RandomState(1)
    seg = 48
    x = rng.randn(6, seg).astype(np.float32)
    seq_len = np.array([seg, seg - 3, 2, 2, seg // 2, seg], np.int32)
    want = np.asarray(jmodel.apply_model(params, config, jnp.asarray(x), jnp.asarray(seq_len)))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), config, "cpu")
    got = model(torch.tensor(x), torch.tensor(seq_len)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("cell_type", CELLS)
@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_birnn_stack_matches_jax(cell_type, layer_type):
    """The port's fused inference layers (flip mode for LSTM/GRU) against
    the JAX package's scan + reverse_sequence path, weights carried over."""
    rng = np.random.RandomState(9)
    b, t, c_in, h = 8, 12, 6, 20
    params = jrnn.init_birnn_stack(jax.random.PRNGKey(5), c_in, h, 2, cell_type, layer_type)
    x = rng.randn(b, t, c_in).astype(np.float32)
    lengths = np.array([t, t, 9, 5, 3, 2, 2, 7], np.int32)
    if cell_type != "BNLSTM":
        lengths[5] = 0
    want = jrnn.birnn_stack(params, jnp.asarray(x), jnp.asarray(lengths), cell_type, layer_type)
    got = trnn.birnn_stack(_torch_tree(params), torch.tensor(x), torch.tensor(lengths),
                           cell_type, layer_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    train = trnn.birnn_stack(_torch_tree(params), torch.tensor(x), torch.tensor(lengths),
                             cell_type, layer_type, training=True)
    np.testing.assert_allclose(train.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cell_type", CELLS)
def test_unirnn_layers_match_jax(cell_type):
    rng = np.random.RandomState(10)
    b, t, c_in, h = 8, 12, 6, 20
    params = jrnn.init_unirnn_layers(jax.random.PRNGKey(6), c_in, h, 3, 5, cell_type)
    x = rng.randn(b, t, c_in).astype(np.float32)
    lengths = np.array([t, t, 9, 5, 3, 0, 2, 7], np.int32)
    want = jrnn.unirnn_layers(params, jnp.asarray(x), jnp.asarray(lengths), cell_type)
    tparams = _torch_tree(params)
    got = trnn.unirnn_layers(tparams, torch.tensor(x), torch.tensor(lengths), cell_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    train = trnn.unirnn_layers(tparams, torch.tensor(x), torch.tensor(lengths), cell_type,
                               training=True)
    np.testing.assert_allclose(train.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    init = trnn.init_unirnn_layers(torch.Generator().manual_seed(0), c_in, h, 3, 5, cell_type)
    assert _shapes(init) == _shapes(params)


def test_rnn_rejects_unknown_cell_and_layer_type():
    params = trnn.init_birnn_stack(torch.Generator().manual_seed(0), 4, 8, 1)
    x, lengths = torch.zeros(2, 5, 4), torch.tensor([5, 3], dtype=torch.int32)
    with pytest.raises(ValueError):
        trnn.birnn_stack(params, x, lengths, "RNN")
    with pytest.raises(ValueError):
        trnn.birnn_stack(params, x, lengths, "LSTM", "deep")
    with pytest.raises(ValueError):
        trnn.init_birnn_stack(torch.Generator().manual_seed(0), 4, 8, 1, "RNN")
    with pytest.raises(ValueError):  # flip-mode starts have no training or BNLSTM form
        trnn._run_cell("LSTM", params["layers"][0]["fw"], x.transpose(0, 1), lengths,
                       training=True, starts=lengths)


@pytest.mark.parametrize("front,seg", [("dna_model1", 400), ("slow_model1", 2000),
                                       ("rna_model2", 2000), ("dna_model1", 401)])
def test_output_len_and_ratio_match_jax(front, seg):
    config = _config(front)
    assert tmodel.output_len(config, seg) == jmodel.output_len(config, seg)
    assert tmodel.model_ratio(config, seg) == jmodel.model_ratio(config, seg)


@pytest.mark.parametrize("name", ["DNA_default", "DNA_slow", "RNA_default"])
def test_bundled_checkpoint_loads_with_jax_shapes(name):
    model_dir = os.path.join(MODELS, name)
    config = tconfig.read_config(os.path.join(model_dir, "model.json"))
    tree, step = tckpt.restore_latest(model_dir)
    jtree, jstep = jckpt.restore_latest(model_dir)
    assert step == jstep
    init = jmodel.init_model(jax.random.PRNGKey(0), config)
    flat_init = {jax.tree_util.keystr(k): v.shape
                 for k, v in jax.tree_util.tree_flatten_with_path(init)[0]}
    flat_ckpt = {jax.tree_util.keystr(k): v.shape
                 for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat_ckpt == flat_init
    model = from_jax_params(tree, config, "cpu")
    assert len(model.flat) == len(flat_init)
    for key, t in model.flat.items():
        assert t.dtype == torch.float32
    np.testing.assert_array_equal(
        model.params["rnn"]["head"]["w_class"].numpy(), jtree["rnn"]["head"]["w_class"])


def test_config_matches_jax():
    from chiron_tpu import config as jconfig

    assert tconfig.PRESETS == jconfig.PRESETS
    for name in ("DNA_default", "DNA_slow", "RNA_default"):
        path = os.path.join(MODELS, name, "model.json")
        c = tconfig.read_config(path)
        assert c == jconfig.read_config(path)
        assert tconfig.class_n(c) == jconfig.class_n(c)
        assert tconfig.alphabet(c) == jconfig.alphabet(c)
    assert tconfig.read_config(None) == jconfig.read_config(None)


@pytest.mark.parametrize("front", ["dna_model1", "slow_model1", "rna_model2"])
def test_init_model_matches_jax_shapes(front):
    config = _config(front)
    want = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_flatten_with_path(jmodel.init_model(jax.random.PRNGKey(0),
                                                                   config))[0]}
    tree = tmodel.init_model(torch.Generator().manual_seed(0), config)
    got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, tree))[0]}
    assert got == want
    model = from_jax_params(tree, config, "cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # the biases start at zero, as in JAX
    assert not model.params["rnn"]["stack"]["layers"][0]["fw"]["b"].any()


@pytest.mark.parametrize("cell_type", CELLS)
@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_init_model_cells_match_jax_shapes_and_round_trip(cell_type, layer_type):
    config = _config("dna_model1", cell_type, layer_type)
    want = _shapes(jmodel.init_model(jax.random.PRNGKey(0), config))
    tree = tmodel.init_model(torch.Generator().manual_seed(0), config)
    assert _shapes(jax.tree_util.tree_map(np.asarray, tree)) == want
    # from_jax_params / to_numpy_tree: every leaf registered, and back unchanged
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    model = from_jax_params(np_tree, config, "cpu")
    assert len(model.flat) == len(want)
    back = to_numpy_tree(model)
    assert _shapes(back) == want
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_flatten_with_path(np_tree)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    cell = model.params["rnn"]["stack"]["layers"][0]["fw"]
    if cell_type == "GRU":  # TF GRUCell's gate bias starts at 1
        assert bool((cell["b_g"] == 1).all()) and not cell["b_c"].any()
    if cell_type == "BNLSTM":
        assert bool((cell["scale_x"] == 0.1).all()) and bool((cell["scale_c"] == 0.1).all())
        wh = cell["wh"].detach().numpy()
        np.testing.assert_allclose(wh @ wh.T, np.eye(wh.shape[0]), atol=1e-5)


# (name, shape, extra args): each drawn large enough that the sample moments
# sit within 3% (std) / 0.02 std (mean) of the distribution's
INITS = [("xavier_normal", (3, 256, 256), ()), ("xavier_uniform", (256, 512), ()),
         ("variance_scaling", (200, 400), ()), ("truncated_normal", (300, 300), (0.25,))]


@pytest.mark.parametrize("name,shape,extra", INITS)
def test_initializer_moments_match_jax(name, shape, extra):
    want = np.asarray(getattr(jinit, name)(jax.random.PRNGKey(4), shape, *extra))
    got = getattr(tinit, name)(torch.Generator().manual_seed(4), shape, *extra).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert abs(got.std() / want.std() - 1) < 0.03
    assert abs(got.mean() - want.mean()) < 0.02 * want.std()
    # the same support: uniform limits, normals cut at 2 sigma
    assert abs(np.abs(got).max() / np.abs(want).max() - 1) < 0.03 or name == "xavier_normal"
    np.testing.assert_allclose(np.mean(np.abs(got) > want.std()),
                               np.mean(np.abs(want) > want.std()), atol=0.01)


@pytest.mark.parametrize("shape", [(64, 256), (256, 64)])
def test_orthogonal_matches_jax(shape):
    got = tinit.orthogonal(torch.Generator().manual_seed(1), shape).numpy()
    want = np.asarray(jinit.orthogonal(jax.random.PRNGKey(1), shape))
    assert got.shape == want.shape == shape
    # both are semi-orthogonal: every singular value is 1
    for m in (got, want):
        np.testing.assert_allclose(np.linalg.svd(m, compute_uv=False), 1.0, atol=1e-5)


def test_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        from_jax_params({"w": np.zeros(2, np.float32)}, _config("dna_model1"))
