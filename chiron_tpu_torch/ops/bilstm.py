"""Fused bidirectional LSTM layer (CUDA kernel + plain version).

Port of ``chiron_tpu/ops/pallas/lstm.py:bilstm_layer_pallas``. Both
directions of one layer run over precomputed input projections
``xw = x @ wx + b`` ([T, B, 4H], gate order i, g, f, o, forget bias +1).
The backward direction consumes the time-flipped sequence with a per-row
start offset ``T - len``: its state stays frozen at zero until the row's
data begins, which is exactly reversing each row within its length.

``bilstm_layer`` launches ``csrc/bilstm.cu`` for CUDA tensors and runs
``bilstm_layer_plain`` for CPU tensors. H is handled directly (no padding
to 128 lanes), up to 512 on the card. The kernel keeps each direction's
``wh`` resident in the shared memory of a thread-block cluster where one
holds it (H <= ~330) and reads it from device memory above that;
``inference_geometry`` chooses the cluster size and the rows per tile
(``lstm_grad.cluster_geometry``) so that both directions run in one wave
where they fit.

bf16 inference mode (``chiron_tpu/ops/pallas/lstm.py:70-72``): ``xw`` may be
bfloat16 (both directions in one dtype) and ``h`` is then returned in
bfloat16, rounded to nearest even from the float32 value; the state, the
recurrent product and ``wh`` stay float32. The kernel has a float32 and a
bfloat16 instance; a bfloat16 ``xw`` on the card goes to the bfloat16 one,
never upcast to the float32 one. The plain versions do the same arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.lstm_grad import cluster_geometry, weights_resident, wh_slices

_FORGET_BIAS = 1.0

# launches of the CUDA kernel (plain-version calls on the CPU are not counted),
# in all and by the instance's element type
launches = 0
launches_by_dtype = {"float32": 0, "bfloat16": 0}

# the element types of xw (and h) that the kernel has instances for
XW_DTYPES = (torch.float32, torch.bfloat16)


def dtype_name(dtype: torch.dtype) -> str:
    """"float32" or "bfloat16": the key of a per-dtype launch counter."""
    return str(dtype).split(".")[-1]


def library(dtype: torch.dtype) -> str:
    """The library holding the kernel's instance for xw's dtype: csrc/bilstm.cu
    built as is (float32) or with -DLSTM_XW_BF16 (``cuda_build.VARIANTS``)."""
    return "bilstm_bf16" if dtype == torch.bfloat16 else "bilstm"


def _lstm_direction(xw, wh, lo, hi):
    """One direction over float32 or bfloat16 xw: float32 state and product,
    the output in xw's dtype."""
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    h = torch.zeros((bsz, h_dim), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    out = xw.new_empty((t_max, bsz, h_dim))
    for t in range(t_max):
        gates = xw[t].float() + h @ wh
        i, g, f, o = gates.split(h_dim, dim=1)
        nc = torch.sigmoid(f + _FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
        nh = torch.sigmoid(o) * torch.tanh(nc)
        m = ((lo <= t) & (t < hi))[:, None]
        c = torch.where(m, nc, c)
        h = torch.where(m, nh, h)
        out[t] = torch.where(m, nh, torch.zeros_like(nh))
    return out


def inference_geometry(bsz: int, h_dim: int, dirs: int, dev: torch.device,
                       xw_dtype: torch.dtype = torch.float32):
    """(cluster size, rows per tile, shared-memory bytes per block) of the
    inference kernel's ``xw_dtype`` instance for ``dirs`` directions on the
    card ``dev`` (raises above ``MAX_HIDDEN``: no cluster of 8 blocks of 64
    units covers it)."""
    return cluster_geometry("infer", bsz, h_dim, dirs,
                            torch.cuda.get_device_properties(dev).multi_processor_count,
                            xw_bytes=xw_dtype.itemsize)


def weight_args(whs, h_dim, geometry, xw_dtype: torch.dtype = torch.float32):
    """The recurrent kernels as the inference kernel reads them at this
    geometry, and its ``wh_global`` flag: as they are where a cluster holds
    them, else as device-memory slices (``lstm_grad.wh_slices``)."""
    cluster, rows, smem = geometry
    xw_bytes = xw_dtype.itemsize
    if weights_resident("infer", h_dim, cluster, rows, smem, xw_bytes):
        return list(whs), 0
    return [wh_slices(w, cluster) for w in whs], 1


def bilstm_layer_plain(xw_fw, xw_bw, wh_fw, wh_bw, lengths, starts_bw):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    zero = torch.zeros_like(lengths)
    return (_lstm_direction(xw_fw, wh_fw, zero, lengths),
            _lstm_direction(xw_bw, wh_bw, starts_bw, starts_bw + lengths))


def bilstm_layer(xw_fw: torch.Tensor, xw_bw: torch.Tensor, wh_fw: torch.Tensor,
                 wh_bw: torch.Tensor, lengths: torch.Tensor,
                 starts_bw: torch.Tensor):
    """Both directions of one LSTM layer.

    Args:
      xw_fw, xw_bw: [T, B, 4H] float32, or both bfloat16 (bf16 inference
        mode); xw_bw already time-flipped.
      wh_fw, wh_bw: [H, 4H] float32 recurrent kernels.
      lengths, starts_bw: [B] int32 (starts_bw = T - lengths).
    Returns:
      (hs_fw, hs_bw) each [T, B, H] in xw's dtype, zero outside each row's
      window; hs_bw is in flipped time order (the caller flips back).
    """
    t_max, bsz, four_h = xw_fw.shape
    h_dim = four_h // 4
    dev = xw_fw.device
    if (xw_bw.shape != xw_fw.shape or wh_fw.shape != (h_dim, four_h)
            or wh_bw.shape != wh_fw.shape or lengths.shape != (bsz,)
            or starts_bw.shape != (bsz,)):
        raise ValueError("bilstm_layer: inconsistent shapes")
    if xw_fw.dtype not in XW_DTYPES or xw_bw.dtype != xw_fw.dtype:
        raise ValueError("bilstm_layer (lstm_infer_kernel): xw_fw and xw_bw must both be "
                         f"float32 or both bfloat16, got {xw_fw.dtype} and {xw_bw.dtype}")
    for tsr in (xw_fw, xw_bw, wh_fw, wh_bw):
        if tsr.device != dev:
            raise ValueError("bilstm_layer: xw/wh must be on one device")
    for tsr in (wh_fw, wh_bw):
        if tsr.dtype != torch.float32:
            raise ValueError(f"bilstm_layer (lstm_infer_kernel): wh must be float32, got "
                             f"{tsr.dtype}")
    for tsr in (lengths, starts_bw):
        if tsr.device != dev or tsr.dtype != torch.int32:
            raise ValueError("bilstm_layer: lengths/starts must be int32 on the xw device")
    if dev.type == "cpu":
        return bilstm_layer_plain(xw_fw, xw_bw, wh_fw, wh_bw, lengths, starts_bw)
    if dev.type != "cuda":
        raise ValueError(f"bilstm_layer: unsupported device {dev}")
    global launches
    dtype = xw_fw.dtype
    geometry = inference_geometry(bsz, h_dim, 2, dev, dtype)
    cluster, rows, smem = geometry
    whs, wh_global = weight_args((wh_fw.contiguous(), wh_bw.contiguous()), h_dim, geometry,
                                 dtype)
    args = [a.contiguous() for a in (xw_fw, xw_bw)] + whs + [lengths.contiguous(),
                                                              starts_bw.contiguous()]
    out_f = torch.empty((t_max, bsz, h_dim), dtype=dtype, device=dev)
    out_b = torch.empty_like(out_f)
    lib = cuda_build.load(library(dtype))
    with cuda_build.on_device(dev):
        rc = lib.bilstm_launch(*[a.data_ptr() for a in args], out_f.data_ptr(),
                               out_b.data_ptr(), t_max, bsz, h_dim, rows, cluster, smem,
                               wh_global, int(dtype == torch.bfloat16),
                               torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, f"bilstm ({dtype_name(dtype)} instance)")
    launches += 1
    launches_by_dtype[dtype_name(dtype)] += 1
    return out_f, out_b


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bilstm_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
    lib.bilstm_launch.restype = ci
    lib.lstm_launch.argtypes = [vp] * 5 + [ci] * 8 + [vp]  # ops/lstm.py's entry point
    lib.lstm_launch.restype = ci


cuda_build.register("bilstm", _declare)
cuda_build.register("bilstm_bf16", _declare)
