"""Greedy (best-path) CTC decoding with static shapes, in plain PyTorch.

Port of ``chiron_tpu/ops/ctc_greedy.py`` (tf.nn.ctc_greedy_decoder with
merge_repeated=True, chiron/chiron_eval.py:486-487): per-frame argmax,
collapse repeats, drop blanks; emits a [B, T] int32 matrix front-packed
and -1 padded plus per-example decoded lengths.
"""

from __future__ import annotations

import torch


def greedy_decode(logits: torch.Tensor, seq_lengths: torch.Tensor):
    """Best-path decode of logits [B, T, C] (blank = C-1).

    Returns (decoded [B, T] int32, lengths [B] int32, neg_sum_logits [B]:
    the negated sum of the max logit over used frames).
    """
    b, t, n_class = logits.shape
    blank = n_class - 1
    classes = logits.argmax(dim=-1).to(torch.int32)  # first max on ties
    max_logits = logits.amax(dim=-1)
    tidx = torch.arange(t, device=logits.device)[None, :]
    valid = tidx < seq_lengths.to(torch.int64)[:, None]
    prev = torch.nn.functional.pad(classes, (1, 0), value=-1)[:, :t]
    keep = valid & (classes != blank) & (classes != prev)
    decoded, lengths = compact_labels(classes, keep)
    neg_sum = -torch.where(valid, max_logits, torch.zeros_like(max_logits)).sum(dim=1)
    return decoded, lengths, neg_sum


def compact_labels(classes: torch.Tensor, keep: torch.Tensor):
    """Front-pack kept labels, -1 padded; returns (decoded, lengths)."""
    b, t = classes.shape
    tidx = torch.arange(t, device=classes.device)[None, :]
    key = torch.where(keep, tidx, t + tidx)
    order = torch.argsort(key, dim=1, stable=True)
    decoded = torch.gather(classes.to(torch.int32), 1, order)
    lengths = keep.sum(dim=1).to(torch.int32)
    decoded = torch.where(tidx < lengths[:, None], decoded, torch.full_like(decoded, -1))
    return decoded, lengths
