"""Faults planted in the program's timed path, to show that the comparison
deciding ``correct`` catches them: the CPU tests plant each one under a run,
and ``benchmark.control --fault`` reads them on the card.

Each fault patches one module of the program through a ``setattr``
callable (pytest's ``monkeypatch.setattr``, or ``Patch`` below), so that
the patch is undone afterwards.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def alter_token(setattr_, module) -> None:
    """The first decoded label of every window altered where the step's
    outputs are unpacked on the host."""
    real = module.unpack_step_outputs

    def altered(*a, **k):
        dec, lengths, score, prob = real(*a, **k)
        dec = dec.copy()
        dec[:, 0] = (dec[:, 0] + 1) % 4
        return dec, lengths, score, prob

    setattr_(module, "unpack_step_outputs", altered)


def half_batch(setattr_, module) -> None:
    """The device step run on the first half of the batch, its outputs
    repeated for the rest."""
    import torch

    real = module.decode_step

    def half(model, x, seq_len, *a, **k):
        h = x.shape[0] // 2
        out = real(model, x[:h], seq_len[:h], *a, **k)
        return torch.cat([out, out[:x.shape[0] - h]])

    setattr_(module, "decode_step", half)


def alter_answer(setattr_, module) -> None:
    """The first base of every read's consensus altered where it is made."""
    real = module.consensus_to_bases

    def altered(*a, **k):
        seq = real(*a, **k)
        return ("C" if seq[:1] == "A" else "A") + seq[1:] if seq else seq

    setattr_(module, "consensus_to_bases", altered)


def state_unchanged(setattr_, loop) -> None:
    """A training step that leaves the parameters and the optimizer as they were."""
    setattr_(loop.Optimizer, "step", lambda self: None)


def half_loss(setattr_, loop) -> None:
    """The training loss taken over the first half of the batch."""
    real = loop.ctc_focal_loss

    def half(logits, logit_lengths, labels, label_lengths, fl_gamma=0.0):
        h = logits.shape[0] // 2
        return real(logits[:h], logit_lengths[:h], labels[:h], label_lengths[:h], fl_gamma)

    setattr_(loop, "ctc_focal_loss", half)


def alter_label(setattr_, loop) -> None:
    """The first label of every training row altered where the batch is fed."""
    real = loop.batch_to_device

    def altered(batch, ratio, device):
        out = real(batch, ratio, device)
        out["label"][:, 0] = (out["label"][:, 0] + 1) % 4
        return out

    setattr_(loop, "batch_to_device", altered)


# fault -> (the module of the program it patches, the patch), by runner
FAULTS: Dict[str, Dict[str, tuple]] = {
    "call": {"half_batch": ("chiron_tpu_torch.eval.pipeline", half_batch),
             "token": ("chiron_tpu_torch.eval.pipeline", alter_token),
             "answer": ("chiron_tpu_torch.eval.pipeline", alter_answer)},
    "train": {"state_unchanged": ("chiron_tpu_torch.train.loop", state_unchanged),
              "half_batch": ("chiron_tpu_torch.train.loop", half_loss),
              "token": ("chiron_tpu_torch.train.loop", alter_label)},
}


class Patch:
    """A ``setattr`` that remembers what it replaced; ``undo()`` restores it."""

    def __init__(self):
        self._saved = []

    def __call__(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def plant(runner: str, fault: str, setattr_: Callable) -> None:
    module, patch = FAULTS[runner][fault]
    patch(setattr_, importlib.import_module(module))
