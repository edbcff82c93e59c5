"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
Tolerances: float32 sums in another order than the plain version's
(1e-4 for conv outputs and moments, 1e-5 for the BiLSTM); the beam search
is exact (trace, decodes) with log masses within 1e-4.
"""

import numpy as np
import pytest
import torch

from chiron_tpu_torch.ops import beam as tbeam
from chiron_tpu_torch.ops import bilstm as tbl
from chiron_tpu_torch.ops import conv_bn as tconv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


CONV_CASES = [
    # k, stride, t, c_in, c_out, n_terms, relu_in, bsz
    (1, 1, 24, 1, 16, 1, False, 4),
    (1, 1, 70, 16, 8, 2, True, 4),
    (3, 1, 130, 20, 72, 1, True, 3),   # ragged row and channel tiles
    (3, 1, 32, 32, 16, 2, True, 4),
    (9, 5, 50, 1, 16, 1, False, 4),
    (8, 4, 64, 1, 16, 1, False, 3),
    (9, 5, 51, 8, 8, 2, True, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,t,c_in,c_out,n_terms,relu_in,bsz", CONV_CASES)
def test_conv_bn_kernel_matches_plain(cuda, k, stride, t, c_in, c_out, n_terms,
                                      relu_in, bsz):
    rng = np.random.RandomState(k + stride + c_in)
    terms = [tuple(torch.tensor(v, device=cuda) for v in (
        rng.randn(bsz, t, c_in).astype(np.float32), (0.5 + rng.rand(c_in)).astype(np.float32),
        (rng.randn(c_in) * 0.2).astype(np.float32))) for _ in range(n_terms)]
    w = torch.tensor((rng.randn(k, c_in, c_out) * 0.3).astype(np.float32), device=cuda)
    before = tconv.launches
    got = tconv.conv_bn(terms, w, relu_in, stride)
    assert tconv.launches == before + 1
    want = tconv.conv_bn_plain(terms, w, relu_in, stride)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 100, 128])
def test_bilstm_kernel_matches_plain(cuda, h):
    rng = np.random.RandomState(h)
    t, b = 30, 11
    to = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    xw_f, xw_b = (to(rng.randn(t, b, 4 * h).astype(np.float32)) for _ in range(2))
    wh_f, wh_b = (to((rng.randn(h, 4 * h) * 0.3).astype(np.float32)) for _ in range(2))
    lengths = rng.randint(1, t, size=b).astype(np.int32)
    lengths[0], lengths[-1] = 0, t
    args = (xw_f, xw_b, wh_f, wh_b, to(lengths), to((t - lengths).astype(np.int32)))
    before = tbl.launches
    got = tbl.bilstm_layer(*args)
    assert tbl.launches == before + 1
    want = tbl.bilstm_layer_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,w,nclass,bonus", [(0, 8, 5, 0.0), (1, 30, 5, 0.6),
                                                 (2, 50, 5, 0.0), (3, 8, 6, 0.7),
                                                 (4, 64, 8, 1.5)])
def test_beam_kernels_match_plain(cuda, seed, w, nclass, bonus):
    rng = np.random.RandomState(seed)
    b, t = 9, 40
    logits = (rng.randn(b, t, nclass) * 2).astype(np.float32)
    lens = rng.randint(1, t, size=b).astype(np.int32)
    lens[0], lens[1] = 0, t
    lp = torch.log_softmax(torch.tensor(logits, device=cuda), dim=-1)
    sl = torch.tensor(lens, device=cuda)
    got = tbeam.beam_search(lp, sl, w, bonus)
    want = tbeam.beam_search_plain(lp, sl, w, bonus)
    best = torch.argmax(tbeam._lae(*got[1:]), dim=1).to(torch.int32)
    chars = tbeam.beam_traceback(got[0], best)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(chars.cpu().numpy(),
                                  tbeam.beam_traceback_plain(got[0], best).cpu().numpy())
    dg = tbeam.beam_search_decode(torch.tensor(logits, device=cuda), sl, w, bonus)
    dc = tbeam.beam_search_decode(torch.tensor(logits), torch.tensor(lens), w, bonus)
    np.testing.assert_array_equal(dg[0].cpu().numpy(), dc[0].numpy())
    np.testing.assert_array_equal(dg[1].cpu().numpy(), dc[1].numpy())


@pytest.mark.cuda
def test_wrapper_raises_on_bad_cuda_input(cuda):
    x = torch.zeros(2, 8, 4, device=cuda, dtype=torch.float64)
    one = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        tconv.conv_bn([(x, one, one)], torch.zeros(3, 4, 4, device=cuda), False)
    with pytest.raises(ValueError):
        tbeam.beam_search(torch.zeros(2, 5, 5, device=cuda), torch.zeros(2, device=cuda,
                                                                          dtype=torch.int32),
                          beam_width=65)
