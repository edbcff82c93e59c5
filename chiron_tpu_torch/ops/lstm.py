"""One LSTM direction for inference (CUDA kernel + plain version).

Port of ``chiron_tpu/ops/pallas/lstm.py:lstm_layer_pallas``: the recurrence
over precomputed input projections ``xw = x @ wx + b`` ([T, B, 4H], gate
order i, g, f, o, forget bias +1). Row b is active on the window
``starts[b] <= t < starts[b] + lengths[b]`` (``starts`` None: from 0);
outside it the row's state is frozen and its output zero.

``lstm_layer`` launches the one-direction entry point of ``csrc/bilstm.cu``
(the fused layer's kernel with a single direction, at its own geometry) for
CUDA tensors and runs ``lstm_layer_plain`` for CPU tensors. H is handled
directly (no padding to 128 lanes), up to ``MAX_HIDDEN`` = 512 on the card:
the GRU and BNLSTM wrappers share that limit through ``check_cuda_size``.
As the fused layer (``ops/bilstm.py``), it takes float32 or bfloat16 ``xw``
(bf16 inference mode) and returns ``h`` in xw's dtype, through the kernel's
instance of that dtype on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.bilstm import (XW_DTYPES, _lstm_direction, dtype_name,
                                         inference_geometry, library, weight_args)
from chiron_tpu_torch.ops.lstm_grad import MAX_HIDDEN

# launches of the CUDA kernel (plain-version calls on the CPU are not counted),
# in all and by the instance's element type
launches = 0
launches_by_dtype = {"float32": 0, "bfloat16": 0}


def check_recurrent_inputs(name: str, floats: Sequence[torch.Tensor],
                           shapes: Sequence[Tuple[int, ...]],
                           ints: Sequence[Optional[torch.Tensor]], bsz: int,
                           first_dtypes: Sequence[torch.dtype] = (torch.float32,)
                           ) -> torch.device:
    """Shape, dtype and device checks shared by the recurrent-layer wrappers:
    every float input float32 (the first, the streamed projection, of one of
    ``first_dtypes``) of its expected shape, every given index vector int32
    [B], all on one CPU or CUDA device (which is returned)."""
    dev = floats[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if floats[0].dtype not in first_dtypes:
        raise ValueError(f"{name}: the projection must be one of {list(first_dtypes)}, got "
                         f"{floats[0].dtype}")
    for i, (tsr, shape) in enumerate(zip(floats, shapes)):
        if tsr.device != dev or (i > 0 and tsr.dtype != torch.float32):
            raise ValueError(f"{name}: every other float input must be float32 on {dev}")
        if tuple(tsr.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(tsr.shape)}, expected {tuple(shape)}")
    for tsr in ints:
        if tsr is None:
            continue
        if tsr.device != dev or tsr.dtype != torch.int32 or tuple(tsr.shape) != (bsz,):
            raise ValueError(f"{name}: lengths/starts must be int32 [B] on {dev}")
    return dev


def check_cuda_size(name: str, t_max: int, bsz: int, h_dim: int) -> None:
    """Raise for a shape the recurrent kernels do not take: every one holds
    1..MAX_HIDDEN (512) hidden units."""
    if not 1 <= h_dim <= MAX_HIDDEN:
        raise ValueError(f"{name}: the kernel holds 1..{MAX_HIDDEN} hidden units, got {h_dim}")
    if t_max < 1 or bsz < 1:
        raise ValueError(f"{name}: empty input [T={t_max}, B={bsz}]")


def lstm_layer_plain(xw, wh, lengths, starts=None):
    """Plain PyTorch version of the kernel: same inputs, same output."""
    lo = torch.zeros_like(lengths) if starts is None else starts
    return _lstm_direction(xw, wh, lo, lo + lengths)


def lstm_layer(xw: torch.Tensor, wh: torch.Tensor, lengths: torch.Tensor,
               starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One LSTM direction.

    Args:
      xw: [T, B, 4H] float32 or bfloat16; wh: [H, 4H] float32.
      lengths: [B] int32; starts: [B] int32 or None (every window from 0).
    Returns:
      hs [T, B, H] in xw's dtype, zero outside each row's window.
    """
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    dev = check_recurrent_inputs("lstm_layer (lstm_infer_kernel)", (xw, wh),
                                 ((t_max, bsz, 4 * h_dim), (h_dim, four_h)),
                                 (lengths, starts), bsz, XW_DTYPES)
    if dev.type == "cpu":
        return lstm_layer_plain(xw, wh, lengths, starts)
    check_cuda_size("lstm_layer", t_max, bsz, h_dim)
    global launches
    dtype = xw.dtype
    xw, lengths = xw.contiguous(), lengths.contiguous()
    starts = None if starts is None else starts.contiguous()
    out = torch.empty((t_max, bsz, h_dim), dtype=dtype, device=dev)
    geometry = inference_geometry(bsz, h_dim, 1, dev, dtype)
    cluster, rows, smem = geometry
    (wh,), wh_global = weight_args((wh.contiguous(),), h_dim, geometry, dtype)
    lib = cuda_build.load(library(dtype))
    with cuda_build.on_device(dev):
        rc = lib.lstm_launch(xw.data_ptr(), wh.data_ptr(), lengths.data_ptr(),
                             None if starts is None else starts.data_ptr(), out.data_ptr(),
                             t_max, bsz, h_dim, rows, cluster, smem, wh_global,
                             int(dtype == torch.bfloat16),
                             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, f"lstm_layer ({dtype_name(dtype)} instance)")
    launches += 1
    launches_by_dtype[dtype_name(dtype)] += 1
    return out
