"""The port's CTC loss (chiron_tpu_torch/ops/ctc_loss.py) against the JAX
package's ``ctc_loss`` / ``ctc_focal_loss`` and ``jax.grad`` on CPU.

Tolerances: loss values rtol 1e-5 / atol 1e-4, gradients atol 1e-5 (float32
log-space recursions summed in the same order; the residue is the
log-softmax and exp rounding of two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiron_tpu.ops.ctc_loss import ctc_focal_loss as j_ctc_focal_loss
from chiron_tpu.ops.ctc_loss import ctc_loss as j_ctc_loss
from chiron_tpu_torch.ops import ctc_loss as tctc


def _case(seed, b=6, t=20, u=7, n_class=5):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, t, n_class) * 2).astype(np.float32)
    logit_len = rng.randint(t // 2, t + 1, size=b).astype(np.int32)
    label_len = rng.randint(1, u + 1, size=b).astype(np.int32)
    labels = np.full((b, u), -1, np.int32)
    for i in range(b):
        labels[i, :label_len[i]] = rng.randint(0, n_class - 1, label_len[i])
    # repeated labels (need a blank between them), an empty label, a label
    # longer than its logits (ignored: zero loss, zero gradient), a row with
    # no frames, and a full-length row
    labels[0, :4], label_len[0] = [1, 1, 2, 2], 4
    label_len[1], labels[1] = 0, -1
    logit_len[2], label_len[2] = 3, 5
    labels[2, :5] = [0, 1, 2, 3, 0]
    logit_len[3] = t
    logit_len[4], label_len[4], labels[4] = 0, 0, -1
    return logits, logit_len, labels, label_len


def _jax(fn, logits, *rest):
    args = [jnp.asarray(a) for a in rest]
    return jax.value_and_grad(lambda lg: fn(lg, *args))(jnp.asarray(logits))


def _torch(fn, logits, *rest):
    lg = torch.tensor(logits, requires_grad=True)
    val = fn(lg, *(torch.tensor(a) for a in rest))
    val.backward()
    return val.detach().numpy(), lg.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_values_and_grad_match_jax(seed):
    logits, logit_len, labels, label_len = _case(seed)
    want = np.asarray(j_ctc_loss(jnp.asarray(logits), jnp.asarray(logit_len),
                                 jnp.asarray(labels), jnp.asarray(label_len)))
    got = tctc.ctc_loss(torch.tensor(logits), torch.tensor(logit_len), torch.tensor(labels),
                        torch.tensor(label_len))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert got[2] == 0.0  # label longer than logits: ignored
    # gradient of a weighted sum, so every example's cotangent differs
    w = np.linspace(0.5, 1.5, len(label_len)).astype(np.float32)
    jv, jg = _jax(lambda lg, *a: jnp.sum(j_ctc_loss(lg, *a) * w), logits, logit_len, labels,
                  label_len)
    tv, tg = _torch(lambda lg, *a: (tctc.ctc_loss(lg, *a) * torch.tensor(w)).sum(), logits,
                    logit_len, labels, label_len)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-5, rtol=0)
    assert not tg[2].any() and not tg[4].any()


@pytest.mark.parametrize("fl_gamma", [0.0, 2.0])
def test_ctc_focal_loss_matches_jax(fl_gamma):
    logits, logit_len, labels, label_len = _case(5, b=8, t=40, u=12)
    jv, jg = _jax(lambda lg, *a: j_ctc_focal_loss(lg, *a, fl_gamma=fl_gamma), logits,
                  logit_len, labels, label_len)
    tv, tg = _torch(lambda lg, *a: tctc.ctc_focal_loss(lg, *a, fl_gamma=fl_gamma), logits,
                    logit_len, labels, label_len)
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-5, rtol=0)


def test_ctc_loss_six_classes_and_no_labels():
    # a 5-letter alphabet (blank = class 5) and a batch whose labels are all empty
    rng = np.random.RandomState(9)
    logits = rng.randn(3, 12, 6).astype(np.float32)
    logit_len = np.array([12, 7, 1], np.int32)
    labels = np.array([[4, 4, 0], [2, -1, -1], [-1, -1, -1]], np.int32)
    label_len = np.array([3, 1, 0], np.int32)
    for lab, lab_len in ((labels, label_len), (np.zeros((3, 0), np.int32),
                                               np.zeros(3, np.int32))):
        jv, jg = _jax(lambda lg, *a: jnp.sum(j_ctc_loss(lg, *a)), logits, logit_len, lab,
                      lab_len)
        tv, tg = _torch(lambda lg, *a: tctc.ctc_loss(lg, *a).sum(), logits, logit_len, lab,
                        lab_len)
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fl_gamma", [0.0, 2.0])
def test_cpu_tensors_take_the_plain_version(fl_gamma):
    # ctc_loss on CPU tensors is ctc_loss_plain bit for bit and launches no kernel
    logits, logit_len, labels, label_len = _case(7, b=8, t=30, u=9)
    w = np.linspace(0.5, 1.5, len(label_len)).astype(np.float32)
    before = dict(tctc.launches)
    assert set(before) == {"ctc_alpha", "ctc_beta_grad"}

    def weighted(fn):
        def loss(lg, *a):
            per_row = fn(lg, *a)
            if fl_gamma > 0:
                per_row = torch.pow(1.0 - torch.exp(-per_row), fl_gamma) * per_row
            return (per_row * torch.tensor(w)).sum()
        return loss

    got = _torch(weighted(tctc.ctc_loss), logits, logit_len, labels, label_len)
    want = _torch(weighted(tctc.ctc_loss_plain), logits, logit_len, labels, label_len)
    assert tctc.launches == before
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    focal = _torch(lambda lg, *a: tctc.ctc_focal_loss(lg, *a, fl_gamma=fl_gamma), logits,
                   logit_len, labels, label_len)
    assert tctc.launches == before and np.isfinite(focal[1]).all()


@pytest.mark.parametrize("n_slots,want", [(1, (1, 32)), (13, (1, 32)), (241, (1, 256)),
                                          (1024, (1, 1024)), (1025, (2, 544)),
                                          (1201, (2, 608)), (2048, (2, 1024)), (2049, (8, 288)),
                                          (4096, (8, 512)), (4097, (16, 288)), (5120, (16, 320))])
def test_kernel_geometry(n_slots, want):
    # a slot a thread up to 1024 slots; then the fewest slots a thread that fit
    # 1024 threads (two slots), 512 (eight) or 320 (sixteen), every slot covered
    spt, threads = tctc.geometry(n_slots)
    assert (spt, threads) == want
    assert spt * threads >= n_slots and threads % 32 == 0
    assert max(tctc.shared_bytes(n_slots, 5)) <= tctc.MAX_SHARED_BYTES


def test_kernel_input_checks():
    logits, logit_len, labels, label_len = (torch.tensor(a) for a in _case(1))
    # the kernels' inputs: contiguous float32 logits, int32 lengths and labels
    args = tctc._cuda_inputs(logits.transpose(0, 1).contiguous().transpose(0, 1),
                             logit_len.long(), labels.long(), label_len)
    assert args[0].is_contiguous() and torch.equal(args[0], logits)
    assert all(a.dtype == torch.int32 and a.is_contiguous() for a in args[1:])
    with pytest.raises(ValueError):  # float64 and bf16 logits: the kernels are float32
        tctc._cuda_inputs(logits.double(), logit_len, labels, label_len)
    with pytest.raises(ValueError):
        tctc._cuda_inputs(logits.bfloat16(), logit_len, labels, label_len)
    with pytest.raises(ValueError):  # float labels
        tctc._cuda_inputs(logits, logit_len, labels.float(), label_len)
    with pytest.raises(ValueError):  # lengths of another batch
        tctc._cuda_inputs(logits, logit_len[:-1], labels, label_len)
    with pytest.raises(ValueError):  # lengths on another device than the logits
        tctc._cuda_inputs(logits, logit_len.to("meta"), labels, label_len)
    with pytest.raises(ValueError):  # more slots than the kernels hold (5,120)
        tctc._cuda_inputs(logits, logit_len, torch.zeros(6, 2560, dtype=torch.int32), label_len)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        tctc.ctc_loss(logits.to("meta"), logit_len, labels, label_len)
