"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a torch.device; a CUDA request needs a card.

    There is no silent CPU fallback: asking for ``cuda`` on a machine
    without one raises.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev


def float32_strict() -> None:
    """Run float32 matmuls and cuDNN convolutions in full float32.

    On the card ``torch.backends.cudnn.allow_tf32`` is True by default, and
    TF32 keeps about three decimal digits; the trainer turns both flags off
    so that its steps match the float32 reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
