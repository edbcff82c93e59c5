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

from chiron_tpu.models import model as jmodel
from chiron_tpu.train import checkpoint as jckpt
from chiron_tpu_torch import config as tconfig
from chiron_tpu_torch.models import model as tmodel
from chiron_tpu_torch.params import from_jax_params
from chiron_tpu_torch.train import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "chiron_tpu", "model")


def _config(front):
    return {"cnn": {"model": front},
            "rnn": {"layer_num": 2, "hidden_num": 16, "cell_type": "LSTM",
                    "layer_type": "normal"}}


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


def test_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        from_jax_params({"w": np.zeros(2, np.float32)}, _config("dna_model1"))
