"""CTC loss (forward algorithm) with optional focal-loss modulation.

Port of ``chiron_tpu/ops/ctc_loss.py`` (reference: chiron/chiron_model.py:
50-74, ``tf.nn.ctc_loss`` with ``ctc_merge_repeated=True``), with its
semantics kept exactly:

- blank is the LAST class; labels are dense [B, U] int, padded past each
  length (with -1 by the data loader);
- ``ignore_longer_outputs_than_inputs=True``: an example whose label is
  longer than its logit sequence gives zero loss and zero gradient;
- log-probabilities use the -1e30 sentinel for "impossible", not -inf.

``ctc_loss`` dispatches on the logits' device:

- CPU tensors take the plain version, ``ctc_loss_plain``: a
  ``torch.autograd.Function`` whose forward runs the alpha recursion over the
  blank-interleaved labels as a Python loop over T, and whose backward runs
  the symmetric beta loop and returns the analytic posterior gradient through
  the log-softmax, as the JAX package's custom VJP does (the JAX package runs
  it as ``lax.scan``, not as a Pallas kernel). Called directly it takes CUDA
  tensors too, which is how the kernels are held against it on the card.
- CUDA float32 tensors launch the two kernels of ``csrc/ctc_loss.cu`` on the
  logits' device and current stream: ``ctc_alpha`` (each frame's
  log-softmax, the alpha recursion and nll, keeping lp and the [B, T, S]
  alpha for the backward) and ``ctc_beta_grad`` (the beta recursion, the
  posterior and dlogits), one launch each a loss. Any other dtype on the
  card, or a length or label tensor on another device than the logits,
  raises.

``torch.nn.functional.ctc_loss`` differs in its blank, padding and infinity
rules and is not used. Under a profiler either backward records a
``train.loss_backward`` span (``utils/timing.py``) with the ids of the span
its forward ran in.
"""

from __future__ import annotations

import ctypes

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.utils.timing import current_ids, span

_NEG_INF = -1e30
# the kernels' slots a thread (csrc/ctc_loss.cu instantiates each) -> the most
# threads a block of them runs (its max_threads), so that __launch_bounds__
# leaves each slot its registers
SLOTS_PER_THREAD = {1: 1024, 2: 1024, 8: 512, 16: 320}
MAX_SHARED_BYTES = 232448

# launches of each CUDA entry point (plain-version calls are not counted)
launches = {"ctc_alpha": 0, "ctc_beta_grad": 0}


def _shift_down(x, n):
    """Shift slots toward higher index (alpha direction), -1e30 fill."""
    return torch.nn.functional.pad(x, (n, 0), value=_NEG_INF)[:, :x.shape[1]]


def _shift_up(x, n):
    """Shift slots toward lower index (beta direction), -1e30 fill."""
    return torch.nn.functional.pad(x, (0, n), value=_NEG_INF)[:, n:]


def _setup(logits, labels, label_lengths):
    """Shared tensors of the alpha/beta recursions."""
    bsz, t_max, n_class = logits.shape
    blank = n_class - 1
    u_max = labels.shape[1]
    s = 2 * u_max + 1
    lp = torch.log_softmax(logits, dim=-1)
    ex = torch.full((bsz, s), blank, dtype=torch.int64, device=logits.device)
    ex[:, 1::2] = labels.to(torch.int64)
    ex_prev2 = torch.nn.functional.pad(ex, (2, 0), value=blank)[:, :s]
    skip_ok = (ex != blank) & (ex != ex_prev2)
    skip_add = torch.where(skip_ok, 0.0, _NEG_INF).to(lp.dtype)
    # one-hot product instead of a gather: padding labels (-1) emit 0, and
    # the backward is the transposed product (no scatter-add)
    onehot = (ex[:, :, None] == torch.arange(n_class, device=logits.device)).to(lp.dtype)
    emit = torch.bmm(lp, onehot.transpose(1, 2))  # [B, T, S]
    valid_slot = torch.arange(s, device=logits.device)[None, :] < (2 * label_lengths[:, None] + 1)
    slot_mask = torch.where(valid_slot, 0.0, _NEG_INF).to(lp.dtype)
    return lp, onehot, skip_add, emit, slot_mask, s


def _final_nll(alpha_last, label_lengths):
    last = (2 * label_lengths).to(torch.int64)
    a_last = alpha_last.gather(1, last[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0,
                         alpha_last.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0],
                         torch.full_like(a_last, _NEG_INF))
    return -torch.logaddexp(a_last, a_prev)


class _CTCLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths):
        bsz, t_max, _ = logits.shape
        lp, onehot, skip_add, emit, slot_mask, s = _setup(logits, labels, label_lengths)
        alpha = torch.full((bsz, s), _NEG_INF, dtype=lp.dtype, device=lp.device)
        alpha[:, 0] = emit[:, 0, 0]
        if s > 1:
            alpha[:, 1] = torch.where(label_lengths > 0, emit[:, 0, 1],
                                      torch.full_like(emit[:, 0, 1], _NEG_INF))
        alpha = alpha + slot_mask
        alphas = [alpha]
        for t in range(1, t_max):
            merged = torch.logaddexp(torch.logaddexp(alpha, _shift_down(alpha, 1)),
                                     _shift_down(alpha, 2) + skip_add)
            new_alpha = merged + emit[:, t, :] + slot_mask
            alpha = torch.where((t < logit_lengths)[:, None], new_alpha, alpha)
            alphas.append(alpha)
        nll = _final_nll(alpha, label_lengths)
        ignore = label_lengths > logit_lengths
        ctx.span_ids = current_ids()  # the step's, for the backward's span
        ctx.save_for_backward(torch.stack(alphas), lp, onehot, skip_add, emit, slot_mask,
                              nll, ignore, logit_lengths, label_lengths)
        return torch.where(ignore, torch.zeros_like(nll), nll)

    @staticmethod
    def backward(ctx, g):
        with span("train.loss_backward", **ctx.span_ids):
            return _CTCLoss._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        (alphas, lp, onehot, skip_add, emit, slot_mask, nll, ignore, logit_lengths,
         label_lengths) = ctx.saved_tensors
        t_max, bsz, s = alphas.shape
        last = 2 * label_lengths.to(torch.int64)
        s_idx = torch.arange(s, device=lp.device)[None, :]
        beta_init = torch.where((s_idx == last[:, None])
                                | ((s_idx == last[:, None] - 1) & (label_lengths[:, None] > 0)),
                                0.0, _NEG_INF).to(lp.dtype)
        beta = beta_init
        betas = [None] * t_max
        for t in range(t_max - 1, -1, -1):
            # beta[t] from beta[t+1] + emit[t+1]; beta excludes the emit at t
            nxt = beta + emit[:, min(t + 1, t_max - 1), :] + slot_mask
            rec = torch.logaddexp(torch.logaddexp(nxt, _shift_up(nxt, 1)),
                                  _shift_up(nxt + skip_add, 2))
            beta = torch.where(((t == logit_lengths - 1) | (t >= logit_lengths))[:, None],
                               beta_init, rec)
            betas[t] = beta
        betas = torch.stack(betas)
        active = torch.arange(t_max, device=lp.device)[:, None, None] < logit_lengths[None, :, None]
        gamma = alphas + betas + nll[None, :, None]
        post = torch.where(active & ~ignore[None, :, None] & (gamma > _NEG_INF / 2),
                           torch.exp(torch.clamp(gamma, max=0.0)), torch.zeros_like(gamma))
        dlp = -torch.bmm(post.permute(1, 0, 2), onehot)  # [B, T, C]
        dlogits = dlp - torch.exp(lp) * dlp.sum(dim=-1, keepdim=True)
        return dlogits * g[:, None, None], None, None, None


def ctc_loss_plain(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor) -> torch.Tensor:
    """The plain version of ``ctc_loss`` on any device (its arguments)."""
    return _CTCLoss.apply(logits, logit_lengths, labels, label_lengths)


def geometry(n_slots: int):
    """(slots a thread, threads a block) of both kernels for ``n_slots`` =
    2U + 1: a slot a thread up to 1024 slots, else the fewest slots a thread
    of ``SLOTS_PER_THREAD`` whose threads, a multiple of 32, fit the block."""
    for spt, most in SLOTS_PER_THREAD.items():
        threads = 32 * -(-n_slots // (32 * spt))
        if threads <= most:
            return spt, threads
    raise ValueError(f"ctc_loss: {n_slots} slots (2U + 1) are more than the kernels hold "
                     f"({max(spt * most for spt, most in SLOTS_PER_THREAD.items())})")


def shared_bytes(n_slots: int, n_class: int):
    """Dynamic shared memory of (``ctc_alpha``, ``ctc_beta_grad``) at the
    geometry of ``n_slots``: alpha by frame parity and the extended labels;
    the beta terms by parity, each warp's class sums and the class sums by
    parity, and the extended labels."""
    warps = geometry(n_slots)[1] // 32
    return 12 * n_slots, 12 * n_slots + 8 * n_class * (warps + 1)


def _cuda_inputs(logits, logit_lengths, labels, label_lengths):
    """The kernels' inputs: contiguous float32 logits and int32 lengths and
    labels on the logits' card, or ValueError."""
    dev = logits.device
    if logits.dtype != torch.float32:
        raise ValueError(f"ctc_loss: the kernels take float32 logits on {dev}, got {logits.dtype}")
    if logits.dim() != 3 or labels.dim() != 2:
        raise ValueError(f"ctc_loss: logits [B, T, C] and labels [B, U], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    bsz, t_max, n_class = logits.shape
    if bsz < 1 or t_max < 1 or n_class < 1:
        raise ValueError(f"ctc_loss: empty logits {tuple(logits.shape)}")
    ints = []
    for name, tsr, shape in (("logit_lengths", logit_lengths, (bsz,)),
                             ("labels", labels, (bsz, labels.shape[1])),
                             ("label_lengths", label_lengths, (bsz,))):
        if tsr.device != dev:
            raise ValueError(f"ctc_loss: {name} on {tsr.device}, the logits on {dev}")
        if tsr.dtype.is_floating_point or tsr.dtype.is_complex or tsr.dtype == torch.bool:
            raise ValueError(f"ctc_loss: {name} must be integers, got {tsr.dtype}")
        if tuple(tsr.shape) != shape:
            raise ValueError(f"ctc_loss: {name} {tuple(tsr.shape)}, expected {shape}")
        ints.append(tsr.to(torch.int32).contiguous())
    n_slots = 2 * labels.shape[1] + 1
    if max(shared_bytes(n_slots, n_class)) > MAX_SHARED_BYTES:
        raise ValueError(f"ctc_loss: {n_slots} slots and {n_class} classes need more shared "
                         f"memory than a block has")
    return (logits.contiguous(), *ints)


def ctc_alpha(logits, logit_lengths, labels, label_lengths):
    """The forward kernel on checked inputs (``_cuda_inputs``): (loss [B],
    nll [B], lp [B, T, C], alpha [B, T, 2U + 1], written at frames t <
    logit_lengths and at frame 0)."""
    bsz, t_max, n_class = logits.shape
    u_max = labels.shape[1]
    n_slots = 2 * u_max + 1
    dev = logits.device
    loss = torch.empty(bsz, dtype=torch.float32, device=dev)
    nll = torch.empty_like(loss)
    lp = torch.empty_like(logits)
    alpha = torch.empty((bsz, t_max, n_slots), dtype=torch.float32, device=dev)
    spt, threads = geometry(n_slots)
    lib = cuda_build.load("ctc_loss")
    with cuda_build.on_device(dev):
        rc = lib.ctc_alpha_launch(logits.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                                  label_lengths.data_ptr(), lp.data_ptr(), alpha.data_ptr(),
                                  nll.data_ptr(), loss.data_ptr(), bsz, t_max, n_class, u_max,
                                  spt, threads, shared_bytes(n_slots, n_class)[0],
                                  torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "ctc_alpha")
    launches["ctc_alpha"] += 1
    return loss, nll, lp, alpha


def ctc_beta_grad(lp, alpha, nll, g, logit_lengths, labels, label_lengths):
    """The backward kernel: dlogits [B, T, C] of the loss under the
    cotangent ``g`` [B], from ``ctc_alpha``'s lp, alpha and nll."""
    bsz, t_max, n_class = lp.shape
    u_max = labels.shape[1]
    n_slots = 2 * u_max + 1
    dev = lp.device
    if g.dtype != torch.float32 or g.device != dev:
        raise ValueError(f"ctc_beta_grad: the cotangent must be float32 on {dev}, got "
                         f"{g.dtype} on {g.device}")
    g = g.contiguous()
    dlogits = torch.empty_like(lp)
    spt, threads = geometry(n_slots)
    lib = cuda_build.load("ctc_loss")
    with cuda_build.on_device(dev):
        rc = lib.ctc_beta_grad_launch(lp.data_ptr(), alpha.data_ptr(), nll.data_ptr(),
                                      g.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                                      label_lengths.data_ptr(), dlogits.data_ptr(), bsz, t_max,
                                      n_class, u_max, spt, threads,
                                      shared_bytes(n_slots, n_class)[1],
                                      torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "ctc_beta_grad")
    launches["ctc_beta_grad"] += 1
    return dlogits


class _CTCLossKernels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths):
        loss, nll, lp, alpha = ctc_alpha(logits, logit_lengths, labels, label_lengths)
        ctx.span_ids = current_ids()  # the step's, for the backward's span
        ctx.save_for_backward(lp, alpha, nll, logit_lengths, labels, label_lengths)
        return loss

    @staticmethod
    def backward(ctx, g):
        lp, alpha, nll, logit_lengths, labels, label_lengths = ctx.saved_tensors
        with span("train.loss_backward", **ctx.span_ids):
            dlogits = ctc_beta_grad(lp, alpha, nll, g, logit_lengths, labels, label_lengths)
        return dlogits, None, None, None


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-example negative log-likelihood [B]: the plain version for CPU
    tensors, the kernels for CUDA float32 tensors.

    Args:
      logits: [B, T, C] unnormalised (log-softmax applied inside); blank = C-1.
      logit_lengths: [B] valid frames per example.
      labels: [B, U] int labels in [0, C-2], anything past each length.
      label_lengths: [B] valid labels per example.
    """
    if logits.device.type == "cpu":
        return ctc_loss_plain(logits, logit_lengths, labels, label_lengths)
    if logits.device.type != "cuda":
        raise ValueError(f"ctc_loss: unsupported device {logits.device}")
    return _CTCLossKernels.apply(*_cuda_inputs(logits, logit_lengths, labels, label_lengths))


def ctc_focal_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor, fl_gamma: float = 0.0) -> torch.Tensor:
    """Mean CTC loss with focal modulation (chiron/chiron_model.py:62-70)."""
    loss = ctc_loss(logits, logit_lengths, labels, label_lengths)
    if fl_gamma > 0:
        loss = torch.pow(1.0 - torch.exp(-loss), fl_gamma) * loss
    return loss.mean()


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ctc_alpha_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.ctc_alpha_launch.restype = ci
    lib.ctc_beta_grad_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.ctc_beta_grad_launch.restype = ci


cuda_build.register("ctc_loss", _declare)
