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

Three routes on the card, chosen by ``route`` from the shape and the card:

- "resident": ``csrc/bilstm.cu`` with wh in the shared memory of a cluster of
  at most 8 blocks (``lstm_grad.cluster_geometry``), up to H ~ 320-336;
- "cluster16": above that, for float32 ``xw`` and H <= ``C16_MAX_HIDDEN``
  (384), ``csrc/lstm_c16.cu``: wh resident in a non-portable cluster of 16
  blocks (24 hidden units, 147 KB of wh a block), up to 64 rows a cluster,
  as many clusters as the card holds at once (``c16_clusters``), so a batch
  of 400 runs in one wave; the product on the tensor cores in three TF32
  passes summed in float32;
- "streamed": everything else (H 385-512; bf16 ``xw`` above the resident
  range), ``csrc/bilstm.cu`` reading each block's slice of wh from device
  memory (L2) every step.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build, lstm_grad
from chiron_tpu_torch.ops.bilstm import (XW_DTYPES, _lstm_direction, dtype_name,
                                         inference_geometry, library, weight_args)
from chiron_tpu_torch.ops.lstm_grad import MAX_HIDDEN

# launches of the CUDA kernels (plain-version calls on the CPU are not counted),
# in all, by the instance's element type and by route
launches = 0
launches_by_dtype = {"float32": 0, "bfloat16": 0}
launches_by_route = {"cluster16": 0, "streamed": 0, "resident": 0}

# csrc/lstm_c16.cu: hidden units it holds (16 blocks x 24), rows of a tile at
# most, and the dynamic shared memory of a block (wh [384][96] and the
# block's h [2][64][24], float32)
C16_MAX_HIDDEN = 384
C16_MAX_ROWS = 64
C16_SMEM_BYTES = 4 * (C16_MAX_HIDDEN * 96 + 2 * C16_MAX_ROWS * 24)


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


def route(bsz: int, h_dim: int, dirs: int = 1, xw_dtype: torch.dtype = torch.float32,
          sm_count: int = lstm_grad._H100_SMS) -> str:
    """The route of a layer of ``dirs`` directions (1: ``lstm_layer``; 2: the
    fused ``ops/bilstm.py``) on a card with ``sm_count`` SMs: "resident" where
    a cluster of at most 8 blocks holds wh, else "cluster16" for one float32
    direction up to ``C16_MAX_HIDDEN`` units, else "streamed"."""
    geometry = lstm_grad.cluster_geometry("infer", bsz, h_dim, dirs, sm_count,
                                          xw_bytes=xw_dtype.itemsize)
    if lstm_grad.weights_resident("infer", h_dim, *geometry, xw_bytes=xw_dtype.itemsize):
        return "resident"
    if dirs == 1 and xw_dtype == torch.float32 and h_dim <= C16_MAX_HIDDEN:
        return "cluster16"
    return "streamed"


def c16_geometry(bsz: int, clusters: int) -> Tuple[int, int]:
    """(rows of a tile, clusters of the grid) of ``csrc/lstm_c16.cu`` for a
    batch of ``bsz`` rows on a card that holds ``clusters`` clusters of 16 at
    once: each cluster ceil(B / clusters) rows rounded up to 16, at most 64; a
    batch past 64 rows a cluster walks its tiles inside the launch."""
    per_cluster = -(-bsz // clusters)
    rows = min(C16_MAX_ROWS, -(-per_cluster // 16) * 16)
    return rows, min(clusters, -(-bsz // rows))


_C16_CLUSTERS = {}


def c16_clusters(dev: torch.device) -> int:
    """Clusters of 16 blocks of ``csrc/lstm_c16.cu`` the card holds at once,
    asked once per device (the library is built for sm_90a, whose cards all
    hold them: a failure or a count of 0 is a fault, and raises)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _C16_CLUSTERS:
        lib = cuda_build.load("lstm_c16")
        count = ctypes.c_int(0)
        with cuda_build.on_device(idx):
            cuda_build.check(lib.lstm_c16_active_clusters(ctypes.byref(count)),
                             "lstm_c16_active_clusters")
        if count.value < 1:
            raise RuntimeError("lstm_c16_active_clusters: the card holds no cluster of 16 "
                               "blocks of lstm_infer_kernel_c16")
        _C16_CLUSTERS[idx] = count.value
    return _C16_CLUSTERS[idx]


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _launch(xw, wh, lengths, starts, route(bsz, h_dim, 1, xw.dtype, sms))


def _launch(xw, wh, lengths, starts, chosen: str) -> torch.Tensor:
    """Launch the kernel of route ``chosen`` ("cluster16" needs float32 xw and
    H <= 384; "streamed" and "resident" run ``csrc/bilstm.cu`` at the geometry
    ``inference_geometry`` chooses, and "resident" needs one that holds wh)."""
    global launches
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    dev, dtype = xw.device, xw.dtype
    xw, wh, lengths = xw.contiguous(), wh.contiguous(), lengths.contiguous()
    starts = None if starts is None else starts.contiguous()
    out = torch.empty((t_max, bsz, h_dim), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    starts_ptr = None if starts is None else starts.data_ptr()
    if chosen == "cluster16":
        if dtype != torch.float32 or h_dim > C16_MAX_HIDDEN:
            raise ValueError(f"lstm_layer: the cluster16 route holds float32 xw and H <= "
                             f"{C16_MAX_HIDDEN}, got {dtype} and H={h_dim}")
        rows, clusters = c16_geometry(bsz, c16_clusters(dev))
        lib = cuda_build.load("lstm_c16")
        with cuda_build.on_device(dev):
            rc = lib.lstm_c16_launch(xw.data_ptr(), wh.data_ptr(), lengths.data_ptr(),
                                     starts_ptr, out.data_ptr(), t_max, bsz, h_dim, rows,
                                     clusters, stream)
        cuda_build.check(rc, "lstm_layer (cluster16 route)")
    else:
        geometry = inference_geometry(bsz, h_dim, 1, dev, dtype)
        cluster, rows, smem = geometry
        (wh,), wh_global = weight_args((wh,), h_dim, geometry, dtype)
        if wh_global != (chosen == "streamed"):
            raise ValueError(f"lstm_layer: the {chosen} route does not hold H={h_dim}, B={bsz}")
        lib = cuda_build.load(library(dtype))
        with cuda_build.on_device(dev):
            rc = lib.lstm_launch(xw.data_ptr(), wh.data_ptr(), lengths.data_ptr(), starts_ptr,
                                 out.data_ptr(), t_max, bsz, h_dim, rows, cluster, smem,
                                 wh_global, int(dtype == torch.bfloat16), stream)
        cuda_build.check(rc, f"lstm_layer ({dtype_name(dtype)} instance)")
    launches += 1
    launches_by_dtype[dtype_name(dtype)] += 1
    launches_by_route[chosen] += 1
    return out


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lstm_c16_launch.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.lstm_c16_launch.restype = ci
    lib.lstm_c16_active_clusters.argtypes = [vp]
    lib.lstm_c16_active_clusters.restype = ci
    lib.lstm_c16_smem_bytes.argtypes = []
    lib.lstm_c16_smem_bytes.restype = ci


cuda_build.register("lstm_c16", _declare)
