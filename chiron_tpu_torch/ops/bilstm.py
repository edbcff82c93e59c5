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
"""

from __future__ import annotations

import ctypes

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.lstm_grad import cluster_geometry, weights_resident, wh_slices

_FORGET_BIAS = 1.0

# launches of the CUDA kernel (plain-version calls on the CPU are not counted)
launches = 0


def _lstm_direction(xw, wh, lo, hi):
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    h = xw.new_zeros((bsz, h_dim))
    c = xw.new_zeros((bsz, h_dim))
    out = xw.new_empty((t_max, bsz, h_dim))
    for t in range(t_max):
        gates = xw[t] + h @ wh
        i, g, f, o = gates.split(h_dim, dim=1)
        nc = torch.sigmoid(f + _FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
        nh = torch.sigmoid(o) * torch.tanh(nc)
        m = ((lo <= t) & (t < hi))[:, None]
        c = torch.where(m, nc, c)
        h = torch.where(m, nh, h)
        out[t] = torch.where(m, nh, torch.zeros_like(nh))
    return out


def inference_geometry(bsz: int, h_dim: int, dirs: int, dev: torch.device):
    """(cluster size, rows per tile, shared-memory bytes per block) of the
    inference kernel for ``dirs`` directions on the card ``dev`` (raises
    above ``MAX_HIDDEN``: no cluster of 8 blocks of 64 units covers it)."""
    return cluster_geometry("infer", bsz, h_dim, dirs,
                            torch.cuda.get_device_properties(dev).multi_processor_count)


def weight_args(whs, h_dim, geometry):
    """The recurrent kernels as the inference kernel reads them at this
    geometry, and its ``wh_global`` flag: as they are where a cluster holds
    them, else as device-memory slices (``lstm_grad.wh_slices``)."""
    cluster, rows, smem = geometry
    if weights_resident("infer", h_dim, cluster, rows, smem):
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
      xw_fw, xw_bw: [T, B, 4H] float32; xw_bw already time-flipped.
      wh_fw, wh_bw: [H, 4H] float32 recurrent kernels.
      lengths, starts_bw: [B] int32 (starts_bw = T - lengths).
    Returns:
      (hs_fw, hs_bw) each [T, B, H] float32, zero outside each row's
      window; hs_bw is in flipped time order (the caller flips back).
    """
    t_max, bsz, four_h = xw_fw.shape
    h_dim = four_h // 4
    dev = xw_fw.device
    if (xw_bw.shape != xw_fw.shape or wh_fw.shape != (h_dim, four_h)
            or wh_bw.shape != wh_fw.shape or lengths.shape != (bsz,)
            or starts_bw.shape != (bsz,)):
        raise ValueError("bilstm_layer: inconsistent shapes")
    for tsr in (xw_fw, xw_bw, wh_fw, wh_bw):
        if tsr.device != dev or tsr.dtype != torch.float32:
            raise ValueError("bilstm_layer: xw/wh must be float32 on one device")
    for tsr in (lengths, starts_bw):
        if tsr.device != dev or tsr.dtype != torch.int32:
            raise ValueError("bilstm_layer: lengths/starts must be int32 on the xw device")
    if dev.type == "cpu":
        return bilstm_layer_plain(xw_fw, xw_bw, wh_fw, wh_bw, lengths, starts_bw)
    if dev.type != "cuda":
        raise ValueError(f"bilstm_layer: unsupported device {dev}")
    global launches
    geometry = inference_geometry(bsz, h_dim, 2, dev)
    cluster, rows, smem = geometry
    whs, wh_global = weight_args((wh_fw.contiguous(), wh_bw.contiguous()), h_dim, geometry)
    args = [a.contiguous() for a in (xw_fw, xw_bw)] + whs + [lengths.contiguous(),
                                                              starts_bw.contiguous()]
    out_f = torch.empty((t_max, bsz, h_dim), dtype=torch.float32, device=dev)
    out_b = torch.empty_like(out_f)
    lib = cuda_build.load("bilstm")
    rc = lib.bilstm_launch(*[a.data_ptr() for a in args], out_f.data_ptr(),
                           out_b.data_ptr(), t_max, bsz, h_dim, rows, cluster, smem, wh_global,
                           torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "bilstm")
    launches += 1
    return out_f, out_b


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bilstm_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.bilstm_launch.restype = ci
    lib.lstm_launch.argtypes = [vp] * 5 + [ci] * 7 + [vp]  # ops/lstm.py's entry point
    lib.lstm_launch.restype = ci


cuda_build.register("bilstm", _declare)
