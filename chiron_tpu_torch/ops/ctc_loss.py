"""CTC loss (forward algorithm) with optional focal-loss modulation.

Port of ``chiron_tpu/ops/ctc_loss.py`` (reference: chiron/chiron_model.py:
50-74, ``tf.nn.ctc_loss`` with ``ctc_merge_repeated=True``), with its
semantics kept exactly:

- blank is the LAST class; labels are dense [B, U] int, padded past each
  length (with -1 by the data loader);
- ``ignore_longer_outputs_than_inputs=True``: an example whose label is
  longer than its logit sequence gives zero loss and zero gradient;
- log-probabilities use the -1e30 sentinel for "impossible", not -inf.

``ctc_loss`` is a ``torch.autograd.Function``: the forward runs the alpha
recursion over the blank-interleaved labels as a Python loop over T, and
the backward runs the symmetric beta loop and returns the analytic
posterior gradient through the log-softmax, as the JAX package's custom
VJP does. It is plain torch (the JAX package runs it as ``lax.scan``, not as
a Pallas kernel); ``torch.nn.functional.ctc_loss`` differs in its blank,
padding and infinity rules and is not used. Under a profiler the backward
records a ``train.loss_backward`` span (``utils/timing.py``) with the ids
of the span its forward ran in.
"""

from __future__ import annotations

import torch

from chiron_tpu_torch.utils.timing import current_ids, span

_NEG_INF = -1e30


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


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-example negative log-likelihood [B].

    Args:
      logits: [B, T, C] unnormalised (log-softmax applied inside); blank = C-1.
      logit_lengths: [B] valid frames per example.
      labels: [B, U] int labels in [0, C-2], anything past each length.
      label_lengths: [B] valid labels per example.
    """
    return _CTCLoss.apply(logits, logit_lengths, labels, label_lengths)


def ctc_focal_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor, fl_gamma: float = 0.0) -> torch.Tensor:
    """Mean CTC loss with focal modulation (chiron/chiron_model.py:62-70)."""
    loss = ctc_loss(logits, logit_lengths, labels, label_lengths)
    if fl_gamma > 0:
        loss = torch.pow(1.0 - torch.exp(-loss), fl_gamma) * loss
    return loss.mean()
