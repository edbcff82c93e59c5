"""Plain PyTorch reference of the training step, and the numbers that compare
a trainer's first steps with it.

A step is the model's forward pass in float32 (the reference model, with
autograd), the CTC loss with the blank last (``F.ctc_loss``, an example
whose labels cannot fit its frames counting zero) under the focal
modulation (1 - e^-l)^gamma · l, the batch mean, its gradients, and Adam
(beta 0.9 / 0.999, eps 1e-8, bias-corrected) at the configured rate
(reference: chiron/chiron_model.py:20-99).

The compared numbers, each by the worst leaf, a leaf's gap measured against
the reference's norm of that leaf or of the median leaf, whichever is
larger:
- ``loss_gap``: the first step's loss against the reference's, relative
  (the later steps' losses move with the first update of elements whose
  gradient is nought to rounding, which Adam moves by about the rate
  whatever their sign: they spread from seed to seed, the first does not);
- ``grad_gap``: the norm of each leaf's first gradient;
- ``update_gap``: the norm of each leaf's change over the steps, over the
  leaves whose first reference gradient is at least a thousandth of the
  median leaf's (a leaf with a gradient of nought to rounding moves under
  Adam by round-off alone).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import Reference, precision_flags

BETAS = (0.9, 0.999)
EPS = 1e-8


def focal_ctc(logits: torch.Tensor, frames: torch.Tensor, labels: torch.Tensor,
              label_lens: torch.Tensor, gamma: float) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1).transpose(0, 1)  # [T, B, C]
    blank = logits.shape[-1] - 1
    loss = F.ctc_loss(lp, labels.clamp(min=0).long(), frames.long(), label_lens.long(),
                      blank=blank, reduction="none", zero_infinity=True)
    if gamma > 0:
        loss = torch.pow(1.0 - torch.exp(-loss), gamma) * loss
    return loss.mean()


def reference_steps(model: Dict, batches: Sequence[Dict[str, np.ndarray]], lr: float,
                    gamma: float, precision: str, device) -> Dict:
    """Run the reference's steps from the checkpoint over ``batches``
    (``signal``, ``frames``, ``label``, ``label_len`` host arrays). Returns
    the losses, the first gradient of each leaf, and each leaf's change."""
    ref = Reference(model["model_dir"], model["front"], model["stride"], device, precision)
    params = {k: v.clone().requires_grad_(True) for k, v in ref.w.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[float] = []
    first = None
    with precision_flags(precision):
        for step, b in enumerate(batches, 1):
            ref.w = params
            x = torch.from_numpy(b["signal"]).to(device)
            frames = torch.from_numpy(b["frames"]).to(device)
            logits = ref.logits(ref.features(x), frames)
            loss = focal_ctc(logits, frames, torch.from_numpy(b["label"]).to(device),
                             torch.from_numpy(b["label_len"]).to(device), gamma)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(params, grads)}
            with torch.no_grad():
                c1 = 1 - BETAS[0] ** step
                c2 = 1 - BETAS[1] ** step
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    denom = (v2[k].sqrt() / c2 ** 0.5).add_(EPS)
                    p.addcdiv_(m[k], denom, value=-lr / c1)
    change = {k: (params[k].detach() - start[k]) for k in params}
    return {"losses": losses, "first_grad": first, "change": change}


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _gap(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    keys = list(keys)
    floor = float(np.median([want[k] for k in keys])) if keys else 0.0
    return max((abs(got[k] - want[k]) / max(want[k], floor) for k in keys), default=0.0)


def step_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """The compared numbers of a trainer's first steps (``got``: the same
    keys as ``reference_steps`` returns) against the reference's."""
    lw, lg = float(want["losses"][0]), float(got["losses"][0])
    g_want, g_got = _norms(want["first_grad"]), _norms(got["first_grad"])
    floor = float(np.median(list(g_want.values())))
    moved = [k for k in g_want if g_want[k] >= 1e-3 * floor]
    return {"loss_gap": abs(lg - lw) / abs(lw),
            "grad_gap": _gap(g_got, g_want, g_want.keys()),
            "update_gap": _gap(_norms(got["change"]), _norms(want["change"]), moved)}
