"""Differentiable LSTM direction for training (CUDA kernels + plain versions).

Port of ``chiron_tpu/ops/pallas/lstm_grad.py:lstm_layer_pallas_ad``. One
direction of one LSTM layer over precomputed input projections
``xw = x @ wx + b`` ([T, B, 4H], gate order i, g, f, o, forget bias +1);
row b is active while t < lengths[b], and outside that its state is frozen
and its output zero (no start offsets: the training stack reverses the
backward direction's input with ``reverse_sequence``).

- ``lstm_fwd_residuals`` runs the forward and keeps the residuals the
  backward needs: the activated gates and the carried c and h.
- ``lstm_bwd`` runs the reverse-time BPTT: the gate gradients ``dxw`` and
  ``dwh = sum_t h_{t-1}^T da_t``. Masked steps pass dh and dc straight
  through, and the output gradient does not flow into them.
- ``lstm_layer_ad`` is the ``torch.autograd.Function`` over the two; the
  gradients of wx, b and x come from autograd of the surrounding
  ``x @ wx + b``, as in the JAX package.

For CUDA tensors the wrappers launch ``csrc/lstm_grad.cu`` (float32 only);
for CPU tensors they run the plain versions, which repeat the kernels'
arithmetic step by step (float32 or float64). H is handled directly (no
padding to 128 lanes), up to 256.

The forward kernel keeps ``wh`` in shared memory for the whole recurrence.
One direction's ``wh`` at H = 128 is 256 KB, more than a block's 227 KB, so a
thread-block cluster owns each tile of 8 batch rows and every block of the
cluster holds the gate columns of ``ceil(H / cluster)`` hidden units; the
blocks exchange the new h through distributed shared memory, one cluster
barrier a step. ``fwd_geometry`` chooses the cluster size from (B, H) here,
in Python, and the launcher is handed the result: the smallest modelled cost
``waves * (rows * units_per_block + overhead)`` among the cluster sizes whose
block fits the shared memory, where a wave is what the card's SMs hold at
once (a second wave doubles the time). H = 128 takes a cluster of 2 (76
blocks at B = 300, 100 at B = 400: one wave of an H100's 132 SMs), H = 256 a
cluster of 8.
"""

from __future__ import annotations

import ctypes

import torch

from chiron_tpu_torch.ops import cuda_build

_FORGET_BIAS = 1.0
MAX_HIDDEN = 256
# the dwh pass splits the T*B rows into at most this many fixed ranges
_MAX_SPLITS = 16
_ROWS_PER_SPLIT = 4096

# geometry of the forward kernel (csrc/lstm_grad.cu): batch rows per cluster,
# the most shared memory a block may ask for, threads per block at most (one
# per gate column of a block's slice), and the SMs of an H100
FWD_ROWS = 8
MAX_SHARED_BYTES = 232448
_FWD_MAX_COLUMNS = 512
_H100_SMS = 132
# per-step cost that does not shrink with the slice (barriers, the gate stage,
# latency), in the unit of one (row, hidden unit) product column: about what a
# 64-unit slice costs
_FWD_STEP_OVERHEAD = 512

# launches of each CUDA entry point (plain-version calls on the CPU are not counted)
launches = {"lstm_fwd_residuals": 0, "lstm_bwd": 0}


def lstm_fwd_residuals_plain(xw, wh, lengths):
    """Plain version of the forward kernel: (out, gates, cc, hc)."""
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    h = xw.new_zeros((bsz, h_dim))
    c = xw.new_zeros((bsz, h_dim))
    out = xw.new_empty((t_max, bsz, h_dim))
    gates = xw.new_empty((t_max, bsz, four_h))
    cc = xw.new_empty((t_max, bsz, h_dim))
    hc = xw.new_empty((t_max, bsz, h_dim))
    for t in range(t_max):
        pre = xw[t] + h @ wh
        i = torch.sigmoid(pre[:, :h_dim])
        g = torch.tanh(pre[:, h_dim:2 * h_dim])
        f = torch.sigmoid(pre[:, 2 * h_dim:3 * h_dim] + _FORGET_BIAS)
        o = torch.sigmoid(pre[:, 3 * h_dim:])
        nc = f * c + i * g
        nh = o * torch.tanh(nc)
        m = (t < lengths)[:, None]
        c = torch.where(m, nc, c)
        h = torch.where(m, nh, h)
        out[t] = torch.where(m, nh, torch.zeros_like(nh))
        gates[t] = torch.cat([i, g, f, o], dim=1)
        cc[t] = c
        hc[t] = h
    return out, gates, cc, hc


def lstm_bwd_plain(gates, cc, hc, dhs, wh, lengths):
    """Plain version of the backward kernels: (dxw, dwh)."""
    t_max, bsz, h_dim = cc.shape
    dh = cc.new_zeros((bsz, h_dim))
    dc = cc.new_zeros((bsz, h_dim))
    dwh = torch.zeros_like(wh)
    dxw = torch.empty_like(gates)
    zero = cc.new_zeros((bsz, h_dim))
    for t in range(t_max - 1, -1, -1):
        i, g, f, o = gates[t].split(h_dim, dim=1)
        c_prev = cc[t - 1] if t > 0 else zero
        h_prev = hc[t - 1] if t > 0 else zero
        m = (t < lengths)[:, None].to(cc.dtype)
        tc = torch.tanh(cc[t])
        dh_new = m * (dhs[t] + dh)
        dc_new = m * dc + dh_new * o * (1.0 - tc * tc)
        d_o = dh_new * tc * o * (1.0 - o)
        d_f = dc_new * c_prev * f * (1.0 - f)
        d_i = dc_new * g * i * (1.0 - i)
        d_g = dc_new * i * (1.0 - g * g)
        da = torch.cat([d_i, d_g, d_f, d_o], dim=1)
        dxw[t] = da
        dh = da @ wh.t() + (1.0 - m) * dh
        dc = (1.0 - m) * dc + dc_new * f
        dwh = dwh + h_prev.t() @ da
    return dxw, dwh


def fwd_smem_bytes(h_dim: int, cluster: int) -> int:
    """Dynamic shared memory of one forward block: its slice of wh
    [H4, 4*HS], h of the whole tile twice, its c, the gate pre-activations
    and two xw tiles (H4 = H rounded up to 4, HS = ceil(H / cluster)), plus
    the tile's lengths."""
    hs = -(-h_dim // cluster)
    h4 = -(-h_dim // 4) * 4
    floats = h4 * 4 * hs + 2 * FWD_ROWS * h4 + FWD_ROWS * hs + 3 * FWD_ROWS * 4 * hs
    return 4 * floats + 4 * FWD_ROWS


def fwd_geometry(bsz: int, h_dim: int, sm_count: int = _H100_SMS):
    """(cluster size, rows per tile, dynamic shared-memory bytes per block)
    of the forward kernel for a batch of ``bsz`` rows and ``h_dim`` hidden
    units on a card with ``sm_count`` SMs."""
    tiles = -(-bsz // FWD_ROWS)
    best = None
    for cluster in (1, 2, 4, 8):
        hs = -(-h_dim // cluster)
        smem = fwd_smem_bytes(h_dim, cluster)
        if 4 * hs > _FWD_MAX_COLUMNS or smem > MAX_SHARED_BYTES or cluster > sm_count:
            continue
        waves = -(-tiles // (sm_count // cluster))
        cost = waves * (FWD_ROWS * hs + _FWD_STEP_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, cluster, smem)
    if best is None:
        raise ValueError(f"lstm_fwd_residuals: no cluster of at most 8 blocks holds H={h_dim}")
    return best[1], FWD_ROWS, best[2]


def _check(name, floats, shapes, lengths):
    dev = lengths.device
    dtype = floats[0].dtype
    if dtype not in ((torch.float32,) if dev.type == "cuda" else (torch.float32, torch.float64)):
        raise ValueError(f"{name}: unsupported dtype {dtype} on {dev}")
    for tsr, shape in zip(floats, shapes):
        if tsr.device != dev or tsr.dtype != dtype:
            raise ValueError(f"{name}: every float input must be {dtype} on {dev}")
        if tuple(tsr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(tsr.shape)}, expected {shape}")
        if not tsr.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be contiguous int32")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _cuda_shape_ok(name, t_max, bsz, h_dim):
    if not 1 <= h_dim <= MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {h_dim} outside 1..{MAX_HIDDEN}")
    if t_max < 1 or bsz < 1:
        raise ValueError(f"{name}: empty input [T={t_max}, B={bsz}]")


def lstm_fwd_residuals(xw: torch.Tensor, wh: torch.Tensor, lengths: torch.Tensor):
    """Forward of one LSTM direction, with the residuals for the backward.

    Args:
      xw: [T, B, 4H]; wh: [H, 4H]; lengths: [B] int32.
    Returns:
      (out [T, B, H] zero past each length, gates [T, B, 4H] activated,
      cc [T, B, H] carried c, hc [T, B, H] carried h).
    """
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    dev = _check("lstm_fwd_residuals", (xw, wh), ((t_max, bsz, 4 * h_dim), (h_dim, four_h)),
                 lengths)
    if lengths.shape != (bsz,):
        raise ValueError("lstm_fwd_residuals: lengths must be [B]")
    if dev.type == "cpu":
        return lstm_fwd_residuals_plain(xw, wh, lengths)
    _cuda_shape_ok("lstm_fwd_residuals", t_max, bsz, h_dim)
    out = torch.empty((t_max, bsz, h_dim), dtype=torch.float32, device=dev)
    gates = torch.empty_like(xw)
    cc = torch.empty_like(out)
    hc = torch.empty_like(out)
    cluster, rows, smem = fwd_geometry(
        bsz, h_dim, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = cuda_build.load("lstm_grad")
    rc = lib.lstm_fwd_launch(xw.data_ptr(), wh.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                             gates.data_ptr(), cc.data_ptr(), hc.data_ptr(), t_max, bsz, h_dim,
                             rows, cluster, smem, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "lstm_fwd_residuals")
    launches["lstm_fwd_residuals"] += 1
    return out, gates, cc, hc


def lstm_bwd(gates: torch.Tensor, cc: torch.Tensor, hc: torch.Tensor, dhs: torch.Tensor,
             wh: torch.Tensor, lengths: torch.Tensor):
    """Reverse-time BPTT of one LSTM direction.

    Args:
      gates: [T, B, 4H], cc, hc: [T, B, H] (from ``lstm_fwd_residuals``);
      dhs: [T, B, H] gradient of the output; wh: [H, 4H]; lengths: [B] int32.
    Returns:
      (dxw [T, B, 4H], dwh [H, 4H]).
    """
    t_max, bsz, h_dim = cc.shape
    small = (t_max, bsz, h_dim)
    dev = _check("lstm_bwd", (gates, cc, hc, dhs, wh),
                 ((t_max, bsz, 4 * h_dim), small, small, small, (h_dim, 4 * h_dim)), lengths)
    if lengths.shape != (bsz,):
        raise ValueError("lstm_bwd: lengths must be [B]")
    if dev.type == "cpu":
        return lstm_bwd_plain(gates, cc, hc, dhs, wh, lengths)
    _cuda_shape_ok("lstm_bwd", t_max, bsz, h_dim)
    splits = max(1, min(_MAX_SPLITS, (t_max * bsz) // _ROWS_PER_SPLIT))
    wh_t = wh.t().contiguous()
    dxw = torch.empty_like(gates)
    dwh = torch.empty_like(wh)
    part = torch.empty((splits, h_dim, 4 * h_dim), dtype=torch.float32, device=dev)
    lib = cuda_build.load("lstm_grad")
    rc = lib.lstm_bwd_launch(gates.data_ptr(), cc.data_ptr(), hc.data_ptr(), dhs.data_ptr(),
                             wh_t.data_ptr(), lengths.data_ptr(), dxw.data_ptr(), dwh.data_ptr(),
                             part.data_ptr(), splits, t_max, bsz, h_dim,
                             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "lstm_bwd")
    launches["lstm_bwd"] += 1
    return dxw, dwh


class _LSTMLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, wh, lengths):
        out, gates, cc, hc = lstm_fwd_residuals(xw, wh, lengths)
        ctx.save_for_backward(wh, lengths, gates, cc, hc)
        return out

    @staticmethod
    def backward(ctx, dhs):
        wh, lengths, gates, cc, hc = ctx.saved_tensors
        dxw, dwh = lstm_bwd(gates, cc, hc, dhs.contiguous(), wh, lengths)
        return dxw, dwh, None


def lstm_layer_ad(xw: torch.Tensor, wh: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Differentiable LSTM direction: xw [T, B, 4H], wh [H, 4H], lengths [B]
    int32 -> hs [T, B, H] (zero past each length)."""
    return _LSTMLayer.apply(xw.contiguous(), wh.contiguous(), lengths)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd_launch.argtypes = [vp] * 7 + [ci] * 6 + [vp]
    lib.lstm_fwd_launch.restype = ci
    lib.lstm_bwd_launch.argtypes = [vp] * 9 + [ci] * 4 + [vp]
    lib.lstm_bwd_launch.restype = ci


cuda_build.register("lstm_grad", _declare)
