"""Experimental CTC decoders: Monte-Carlo, exact enumeration, sections.

Port of ``chiron_tpu/ops/ctc_mc.py`` (reference: chiron/utils/
easy_assembler.py:69-206, per-window numpy loops of 300 sequential path
samples each):

* ``mc_decode``: all paths of all windows are sampled in one device pass
  (the inverse CDF of each frame's softmax at [S, B, T] uniforms drawn from
  a ``torch.Generator``), CTC-collapsed on the device with the greedy
  decoder's compaction, and copied back as one packed label matrix; the
  host computes each window's mode (np.unique) and its 10*log10(p1/p2)
  quality score.
* ``best_path_decode``: exact CTC decoding for tiny T by enumerating every
  path (numpy, as the JAX package).
* ``section_decoding``: windows are cut where the blank probability
  exceeds the threshold; the sections are padded into ONE batch for a
  single ``mc_decode`` call.

The JAX package samples with ``jax.random.categorical`` and a PRNG key; no
torch generator draws the same paths, so the port takes a ``generator``
where JAX takes ``key`` (default: seeded with 0 on the logits' device, as
JAX defaults to ``PRNGKey(0)``). The host side (mode, quality, the section
cutting) is an exact copy, so equal sampled paths give equal outputs.
Deviations from the reference, as in the JAX package: path probabilities
are softmax probabilities, and when all samples agree p2 falls back to
1/sample_n.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from chiron_tpu_torch.ops.ctc_greedy import compact_labels
from chiron_tpu_torch.utils.device import resolve_device

_ALPHABET = "ACGT"


def _as_logits(logits, device) -> torch.Tensor:
    """A [B, T, C] float32 tensor: a tensor stays on its device, an array
    goes to ``device`` (default the card)."""
    if not isinstance(logits, torch.Tensor):
        logits = torch.as_tensor(np.asarray(logits, np.float32), device=resolve_device(
            "cuda" if device is None else device))
    logits = logits.float()
    return logits[None] if logits.ndim == 2 else logits


def _collapse_paths(paths: torch.Tensor, lengths: torch.Tensor, blank: int):
    """CTC-collapse sampled paths [N, T] (merge repeats, drop blanks)."""
    n, t = paths.shape
    tidx = torch.arange(t, device=paths.device)[None, :]
    valid = tidx < lengths.to(torch.int64)[:, None]
    prev = torch.nn.functional.pad(paths, (1, 0), value=-1)[:, :t]
    keep = valid & (paths != blank) & (paths != prev)
    return compact_labels(paths, keep)


def sample_paths(logits: torch.Tensor, generator: torch.Generator,
                 sample_n: int) -> torch.Tensor:
    """``sample_n`` alignment paths per window, [S, B, T] int32: class k at
    a frame where cdf[k-1] <= u < cdf[k] for a uniform u."""
    b, t, c = logits.shape
    cdf = torch.softmax(logits, dim=-1).cumsum(dim=-1).reshape(b * t, c)
    u = torch.rand((b * t, sample_n), generator=generator, device=logits.device)
    paths = torch.searchsorted(cdf.contiguous(), u, right=True).clamp_(max=c - 1)
    return paths.to(torch.int32).T.reshape(sample_n, b, t)


def _sample_and_collapse(logits: torch.Tensor, seq_lengths: torch.Tensor,
                         generator: torch.Generator, sample_n: int):
    b, t, c = logits.shape
    flat = sample_paths(logits, generator, sample_n).reshape(sample_n * b, t)
    lens = seq_lengths.to(torch.int32).repeat(sample_n)
    decoded, dlens = _collapse_paths(flat, lens, c - 1)
    return decoded.reshape(sample_n, b, t), dlens.reshape(sample_n, b)


def _mode_and_qs(decoded: np.ndarray, sample_n: int) -> Tuple[np.ndarray, int, float]:
    """Most-common row of [S, T'] + 10*log10(p1/p2) quality score."""
    uniq, inv = np.unique(decoded, axis=0, return_inverse=True)
    counts = np.bincount(inv)
    order = np.argsort(counts)[::-1]
    p1 = counts[order[0]] / sample_n
    p2 = (counts[order[1]] if len(order) > 1 else 1) / sample_n
    p2 = max(p2, 1.0 / sample_n)
    return uniq[order[0]], int(counts[order[0]]), 10.0 * math.log10(p1 / p2)


def modes_to_strings(decoded: np.ndarray, sample_n: int,
                     alphabet: str = _ALPHABET) -> Tuple[List[str], List[float]]:
    """The host half of ``mc_decode``: decoded [S, B, T'] -> each window's
    most frequent label string and its quality score."""
    strings, scores = [], []
    for i in range(decoded.shape[1]):
        # compare full padded rows: equal strings have equal padding
        best, _, qs = _mode_and_qs(decoded[:, i, :], sample_n)
        n = int((best >= 0).sum())
        strings.append("".join(alphabet[x] for x in best[:n]))
        scores.append(qs)
    return strings, scores


def mc_decode(logits, seq_lengths, generator: torch.Generator | None = None,
              sample_n: int = 300, alphabet: str = _ALPHABET,
              device=None) -> Tuple[List[str], List[float]]:
    """Monte-Carlo CTC decode (parity: easy_assembler.py:122-206).

    Samples ``sample_n`` alignment paths per window from the per-frame
    posterior, CTC-collapses them on the device, and returns the most
    frequent label string per window plus a 10*log10(p1/p2) confidence.

    Args:
      logits: [B, T, C] or [T, C] raw logits; a tensor is decoded on its
        device, an array on ``device`` (default the card).
      seq_lengths: [B] valid frame counts (None: all T).
      generator: a torch.Generator on the logits' device (default: seeded
        with 0).
      sample_n: Monte-Carlo sample count.
    Returns:
      (decoded strings [B], quality scores [B]).
    """
    logits = _as_logits(logits, device)
    b, t, _ = logits.shape
    if seq_lengths is None:
        seq_lengths = torch.full((b,), t, dtype=torch.int32)
    seq_lengths = torch.as_tensor(seq_lengths).to(logits.device, torch.int32)
    if generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    decoded, _ = _sample_and_collapse(logits, seq_lengths, generator, sample_n)
    return modes_to_strings(decoded.cpu().numpy(), sample_n, alphabet)


def best_path_decode(logits, alphabet: str = _ALPHABET, max_frames: int = 9) -> str:
    """Exact CTC decode by full path enumeration (easy_assembler.py:101-119).

    Marginalises alignment probability over every possible path (C**T of
    them) and returns the label string with the largest total mass — the
    exact MAP label sequence. Exponential: guarded to T <= ``max_frames``.
    """
    logits = np.asarray(logits.cpu() if isinstance(logits, torch.Tensor) else logits,
                        np.float32)
    t, c = logits.shape
    if t > max_frames:
        raise ValueError(
            f"best_path_decode enumerates {c}**T paths; T={t} > {max_frames}"
        )
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)

    n = c ** t
    idx = np.arange(n, dtype=np.int64)
    digits = (idx[:, None] // c ** np.arange(t, dtype=np.int64)[None, :]) % c
    path_p = np.ones(n, np.float64)
    for j in range(t):
        path_p *= probs[j, digits[:, j]]
    # CTC collapse (merge repeats then drop blanks), vectorized
    blank = c - 1
    prev = np.concatenate([np.full((n, 1), -1, np.int64), digits[:, :-1]], 1)
    keep = (digits != blank) & (digits != prev)
    order = np.argsort(np.where(keep, np.arange(t), t + np.arange(t)), axis=1)
    packed = np.take_along_axis(digits, order, axis=1)
    lens = keep.sum(axis=1)
    packed = np.where(np.arange(t)[None, :] < lens[:, None], packed, -1)
    uniq, inv = np.unique(packed, axis=0, return_inverse=True)
    mass = np.bincount(inv, weights=path_p)
    best = uniq[np.argmax(mass)]
    return "".join(alphabet[x] for x in best[: (best >= 0).sum()])


def section_spans(logits: np.ndarray, blank_thres: float = 0.6):
    """Cut windows at blank-dominated frames: the padded section batch
    [n_sections, L, C] (pad frames carry a strong blank logit), its lengths,
    and the (window, start, stop) span of each section; None without any
    section."""
    b, t, c = logits.shape
    probs = np.exp(logits - logits.max(axis=2, keepdims=True))
    probs /= probs.sum(axis=2, keepdims=True)
    nonblank = probs[:, :, c - 1] < blank_thres

    spans: List[Tuple[int, int, int]] = []  # (window, start, stop)
    for i in range(b):
        on = np.flatnonzero(nonblank[i])
        if len(on) == 0:
            continue
        breaks = np.flatnonzero(np.diff(on) > 1)
        starts = np.concatenate([[0], breaks + 1])
        stops = np.concatenate([breaks, [len(on) - 1]])
        spans.extend((i, int(on[s]), int(on[e]) + 1) for s, e in zip(starts, stops))
    if not spans:
        return None
    max_len = max(stop - start for _, start, stop in spans)
    batch = np.zeros((len(spans), max_len, c), np.float32)
    # pad frames get a strong blank logit so they contribute no labels
    batch[:, :, c - 1] = 30.0
    lens = np.zeros(len(spans), np.int32)
    for k, (i, start, stop) in enumerate(spans):
        batch[k, : stop - start] = logits[i, start:stop]
        lens[k] = stop - start
    return batch, lens, spans


def section_decoding(logits, blank_thres: float = 0.6,
                     generator: torch.Generator | None = None, sample_n: int = 300,
                     alphabet: str = _ALPHABET, device=None) -> List[str]:
    """Cut windows at blank-dominated frames, MC-decode each section
    (easy_assembler.py:69-98).

    All sections from all windows are padded into ONE [n_sections, L, C]
    batch and decoded with a single ``mc_decode`` call on the logits'
    device (an array: on ``device``, default the card), then re-joined per
    window in order.
    """
    if isinstance(logits, torch.Tensor):
        device = logits.device
        logits = logits.detach().float().cpu().numpy()
    logits = np.asarray(logits, np.float32)
    if logits.ndim == 2:
        logits = logits[None]
    b = logits.shape[0]
    cut = section_spans(logits, blank_thres)
    if cut is None:
        return [""] * b
    batch, lens, spans = cut
    strings, _ = mc_decode(batch, lens, generator=generator, sample_n=sample_n,
                           alphabet=alphabet, device=device)
    out = [""] * b
    for k, (i, _, _) in enumerate(spans):
        out[i] += strings[k]
    return out
