"""The port's fused conv+BN (chiron_tpu_torch/ops/conv_bn.py) against the JAX
package: the Pallas kernel in interpret mode and the XLA conv + global_bn.

Inputs are made with numpy from a seed and fed to both. Tolerance 1e-4
(rtol and atol): the moments are one-pass sums taken in another order
than XLA's (convbn.py:28-31).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.models import layers as JL
from chiron_tpu.ops.pallas import convbn as jconvbn
from chiron_tpu_torch.models import layers as TL
from chiron_tpu_torch.ops import conv_bn as tconv

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, bsz, t, c_in, c_out, k, n_terms):
    rng = np.random.RandomState(seed)
    terms = [(rng.randn(bsz, t, c_in).astype(np.float32),
              (0.5 + rng.rand(c_in)).astype(np.float32),
              (rng.randn(c_in) * 0.2).astype(np.float32)) for _ in range(n_terms)]
    w = (rng.randn(k, c_in, c_out) * 0.3).astype(np.float32)
    return terms, w


def _xla_conv(terms, w, relu_in, stride):
    x = sum(jnp.asarray(r) * a + b for r, a, b in terms)
    if relu_in:
        x = jax.nn.relu(x)
    return jax.lax.conv_general_dilated(
        x, jnp.asarray(w), window_strides=(stride,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))


def _torch_terms(terms, device="cpu"):
    return [tuple(torch.tensor(v, device=device) for v in term) for term in terms]


CASES = [
    # k, stride, t, c_in, c_out, n_terms, relu_in, bsz
    (1, 1, 24, 1, 16, 1, False, 4),    # first-layer C_in = 1
    (1, 1, 24, 16, 8, 2, True, 4),
    (3, 1, 32, 16, 32, 1, True, 3),
    (3, 1, 32, 32, 16, 2, True, 4),
    (3, 1, 20, 8, 8, 2, False, 2),
    (9, 5, 50, 1, 16, 1, False, 4),    # rna_model2 front
    (8, 4, 64, 1, 16, 1, False, 3),    # slow_model1 front
    (9, 5, 51, 8, 8, 2, True, 2),      # t % stride != 0, two terms
    (8, 4, 30, 4, 8, 1, True, 4),
]


@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,relu_in,bsz", CASES)
def test_conv_bn_matches_pallas_interpret(k, stride, t, c_in, c_out, n_terms,
                                          relu_in, bsz):
    terms, w = _inputs(k * 100 + stride + c_in, bsz, t, c_in, c_out, k, n_terms)
    jy, js, jq = jconvbn.conv_bn_pallas(
        tuple(tuple(jnp.asarray(v) for v in term) for term in terms),
        jnp.asarray(w), k, relu_in, stride=stride, interpret=True)
    ty, ts, tq = tconv.conv_bn(_torch_terms(terms), torch.tensor(w), relu_in, stride)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)


@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,relu_in,bsz", CASES)
def test_conv_bn_then_bn_matches_xla_global_bn(k, stride, t, c_in, c_out, n_terms,
                                               relu_in, bsz):
    """conv_bn + bn_affine == XLA conv followed by the two-pass global_bn."""
    terms, w = _inputs(k * 7 + stride + n_terms, bsz, t, c_in, c_out, k, n_terms)
    rng = np.random.RandomState(1)
    scale = (0.5 + rng.rand(c_out)).astype(np.float32)
    offset = (rng.randn(c_out) * 0.1).astype(np.float32)
    ref = JL.global_bn(_xla_conv(terms, w, relu_in, stride), jnp.asarray(scale),
                       jnp.asarray(offset))
    y, s, q = tconv.conv_bn(_torch_terms(terms), torch.tensor(w), relu_in, stride)
    a, b = tconv.bn_affine(s, q, float(y.shape[0] * y.shape[1]),
                           torch.tensor(scale), torch.tensor(offset))
    np.testing.assert_allclose((y * a + b).numpy(), np.asarray(ref), **TOL)


def test_same_padding_matches_xla_arithmetic():
    for t, k, s in [(400, 3, 1), (400, 1, 1), (2000, 9, 5), (2000, 8, 4), (51, 9, 5),
                    (23, 14, 7)]:
        out_t, lpad = tconv.same_padding(t, k, s)
        assert out_t == -(-t // s)
        assert lpad == max((out_t - 1) * s + k - t, 0) // 2


def test_global_and_pop_bn_match_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 17, 8) * 2 + 1).astype(np.float32)
    scale, offset, mean = (rng.rand(8).astype(np.float32) for _ in range(3))
    var = (rng.rand(8) + 0.1).astype(np.float32)
    np.testing.assert_allclose(
        TL.global_bn(torch.tensor(x), torch.tensor(scale), torch.tensor(offset)).numpy(),
        np.asarray(JL.global_bn(jnp.asarray(x), scale, offset)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TL.pop_bn(*(torch.tensor(v) for v in (x, scale, offset, mean, var))).numpy(),
        np.asarray(JL.pop_bn(*(jnp.asarray(v) for v in (x, scale, offset, mean, var)))),
        rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    terms, w = _inputs(0, 2, 8, 4, 4, 3, 1)
    tt = _torch_terms(terms)
    with pytest.raises(ValueError):
        tconv.conv_bn(tt, torch.tensor(w[:, :2]), False)  # C_in mismatch
    with pytest.raises(ValueError):
        tconv.conv_bn([(tt[0][0].double(), tt[0][1], tt[0][2])], torch.tensor(w), False)
    with pytest.raises(ValueError):
        tconv.conv_bn(tt * 3, torch.tensor(w), False)  # three terms


def test_cpu_path_does_not_count_launches():
    terms, w = _inputs(0, 2, 8, 4, 4, 3, 1)
    before = tconv.launches
    tconv.conv_bn(_torch_terms(terms), torch.tensor(w), True)
    assert tconv.launches == before


# The card kernel runs the product on the tensor cores as three TF32 products
# (head*head + head*tail + tail*head, float32 sums). Its arithmetic, repeated
# on the CPU by conv_bn_3xtf32, must stay float32-grade: within 1e-5 of max
# |y| of the plain version and of the XLA conv, at the main path's depth
# (K = 3 x 256, relu'd inputs, He-scale weights) and at a ragged small size.
# A single TF32 product must miss the 1e-4 absolute gate of the on-card
# holds: that is why the kernel runs three.
TF32_CASES = [
    # k, stride, t, c_in, c_out, n_terms, bsz
    (3, 1, 80, 256, 64, 2, 2),     # the depth of dna_model1's k=3 convs
    (1, 1, 80, 256, 64, 2, 2),     # its k=1 convs
    (3, 1, 37, 20, 72, 1, 3),      # ragged rows and channels
    (9, 5, 51, 8, 8, 2, 2),        # strided, two terms
]


def _he_inputs(seed, bsz, t, c_in, c_out, k, n_terms):
    rng = np.random.RandomState(seed)
    terms = [(rng.randn(bsz, t, c_in).astype(np.float32),
              (0.5 + np.abs(rng.randn(c_in))).astype(np.float32),
              (rng.randn(c_in) * 0.2).astype(np.float32)) for _ in range(n_terms)]
    w = (rng.randn(k, c_in, c_out) * np.sqrt(2.0 / (k * c_in))).astype(np.float32)
    return terms, w


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -11,
                      3.14159265, -1e-20, 0.0], dtype=torch.float32)
    r = tconv.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    # ties go away from zero, as cvt.rna rounds
    np.testing.assert_array_equal(r[:4].numpy(), np.float32(
        [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10]))
    assert float(((r - x).abs() / x.abs().clamp(min=1e-30)).max()) <= 2.0 ** -11
    # head + tail recovers x to ~2^-22 relative
    tail = tconv.tf32_round(x - r)
    assert float(((r + tail - x).abs() / x.abs().clamp(min=1e-30)).max()) <= 2.0 ** -21


@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,bsz", TF32_CASES)
def test_three_tf32_products_are_float32_grade(k, stride, t, c_in, c_out, n_terms, bsz):
    terms, w = _he_inputs(11 * k + c_in, bsz, t, c_in, c_out, k, n_terms)
    tt, tw = _torch_terms(terms), torch.tensor(w)
    py, ps, pq = tconv.conv_bn_plain(tt, tw, True, stride)
    ey, es, eq = tconv.conv_bn_3xtf32(tt, tw, True, stride)
    scale = float(py.abs().max())
    assert float((ey - py).abs().max()) <= 1e-5 * scale
    jy = np.asarray(_xla_conv(terms, w, True, stride))
    assert ey.shape == jy.shape
    assert float(np.abs(ey.numpy() - jy).max()) <= 1e-5 * scale
    np.testing.assert_allclose(es.numpy(), ps.numpy(), rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(eq.numpy(), pq.numpy(), rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,bsz", TF32_CASES[:2])
def test_one_tf32_product_breaks_the_gate(k, stride, t, c_in, c_out, n_terms, bsz):
    terms, w = _he_inputs(11 * k + c_in, bsz, t, c_in, c_out, k, n_terms)
    tt, tw = _torch_terms(terms), torch.tensor(w)
    py, _, _ = tconv.conv_bn_plain(tt, tw, True, stride)
    one, _, _ = tconv.conv_bn_3xtf32(tt, tw, True, stride, products=1)
    three, _, _ = tconv.conv_bn_3xtf32(tt, tw, True, stride, products=3)
    assert float((one - py).abs().max()) > 1e-4
    assert float((three - py).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        tconv.conv_bn_3xtf32(tt, tw, True, stride, products=2)
