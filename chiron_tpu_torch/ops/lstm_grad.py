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
padding to 128 lanes), up to ``MAX_HIDDEN`` = 512 on the card.

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

The backward kernel and the inference kernels (``ops/bilstm.py``,
``ops/lstm.py``) keep ``wh`` (``wh^T``) resident the same way, and
``cluster_geometry`` chooses their rows per tile as well as the cluster size.

Where no cluster of at most 8 blocks holds a block's slice of ``wh`` (the
forward above H ~ 360, the inference and backward kernels above H ~ 330),
the geometry functions choose among the kernels' ``wh_global`` variants,
which read each block's slice from device memory; ``wh_slices`` lays it out
there exactly as it would lie in shared memory. ``weights_resident`` tells
which of the two a geometry is.
"""

from __future__ import annotations

import ctypes

import torch

from chiron_tpu_torch.ops import cuda_build

_FORGET_BIAS = 1.0
MAX_HIDDEN = 512
# the dwh pass splits the T*B rows into at most this many fixed ranges (at
# H = 128 its 4 tiles of 128 x 128 x 32 ranges are 128 blocks, one an SM)
_MAX_SPLITS = 32
_ROWS_PER_SPLIT = 1024

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
# the inference and backward kernels (csrc/bilstm.cu, lstm_bwd_kernel): rows
# per tile 1..16, at most 256 gate columns (64 hidden units) a block, and the
# narrowest slice that still gives each scheduler two warps of product
MAX_ROWS = 16
_CLUSTER_COLUMNS = 256
_FULL_SLICE = 64
# a product that reads wh from device memory (L2) instead of shared memory,
# in units of the resident product. The device-memory variant is weighed only
# above H = 256: up to there a cluster always holds wh, and the geometries are
# the resident ones that the kernels were measured and tuned at.
_WH_GLOBAL_COST = 2
_RESIDENT_ONLY_HIDDEN = 256

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


def fwd_smem_bytes(h_dim: int, cluster: int, resident: bool = True) -> int:
    """Dynamic shared memory of one forward block: its slice of wh
    [H4, 4*HS] (when resident), h of the whole tile twice, its c, the gate
    pre-activations and two xw tiles (H4 = H rounded up to 4, HS = ceil(H /
    cluster)), plus the tile's lengths."""
    hs = -(-h_dim // cluster)
    h4 = -(-h_dim // 4) * 4
    floats = (h4 * 4 * hs if resident else 0) + 2 * FWD_ROWS * h4 + FWD_ROWS * hs \
        + 3 * FWD_ROWS * 4 * hs
    return 4 * floats + 4 * FWD_ROWS


def fwd_geometry(bsz: int, h_dim: int, sm_count: int = _H100_SMS):
    """(cluster size, rows per tile, dynamic shared-memory bytes per block)
    of the forward kernel for a batch of ``bsz`` rows and ``h_dim`` hidden
    units on a card with ``sm_count`` SMs."""
    tiles = -(-bsz // FWD_ROWS)
    # wh resident where some cluster holds it, else read from device memory
    for resident in (True, False):
        best = None
        for cluster in (1, 2, 4, 8):
            hs = -(-h_dim // cluster)
            smem = fwd_smem_bytes(h_dim, cluster, resident)
            if 4 * hs > _FWD_MAX_COLUMNS or smem > MAX_SHARED_BYTES or cluster > sm_count:
                continue
            waves = -(-tiles // (sm_count // cluster))
            cost = waves * (FWD_ROWS * hs + _FWD_STEP_OVERHEAD)
            if best is None or cost < best[0]:
                best = (cost, cluster, smem)
        if best is not None:
            return best[1], FWD_ROWS, best[2]
    raise ValueError(f"lstm_fwd_kernel: no cluster of at most 8 blocks of "
                     f"{_FWD_MAX_COLUMNS} threads covers H={h_dim}")


def infer_smem_bytes(h_dim: int, cluster: int, rows: int, resident: bool = True,
                     xw_bytes: int = 4) -> int:
    """Dynamic shared memory of one block of the inference kernel
    (``csrc/bilstm.cu``): its slice of wh [H4, 4*HS] (when resident), h of
    the tile twice and the gate pre-activations in float32, two xw tiles of
    ``xw_bytes`` an element (4 float32, 2 bfloat16), plus each row's window."""
    hs = -(-h_dim // cluster)
    h4 = -(-h_dim // 4) * 4
    floats = (h4 * 4 * hs if resident else 0) + 2 * rows * h4 + rows * 4 * hs
    return 4 * floats + xw_bytes * 2 * rows * 4 * hs + 8 * rows


def bwd_smem_bytes(h_dim: int, cluster: int, rows: int, resident: bool = True) -> int:
    """Dynamic shared memory of one backward block: its slice of wh^T
    [4, H4, HS] (when resident), da of the tile twice [2, rows, 4, H4], the
    partial sums [4, rows, HS], and the gates, two cc tiles and dhs of its
    units, plus the tile's lengths."""
    hs = -(-h_dim // cluster)
    h4 = -(-h_dim // 4) * 4
    floats = (4 * h4 * hs if resident else 0) + 8 * rows * h4 + (4 + 4 + 2 + 1) * rows * hs
    return 4 * floats + 4 * rows


_SMEM_BYTES = {"infer": infer_smem_bytes, "bwd": bwd_smem_bytes}
_KERNEL_NAME = {"infer": "lstm_infer_kernel", "bwd": "lstm_bwd_kernel"}


def _smem_fn(kind: str, xw_bytes: int):
    if kind == "infer":
        return lambda h, c, r, res=True: infer_smem_bytes(h, c, r, res, xw_bytes)
    return _SMEM_BYTES[kind]


def cluster_geometry(kind: str, bsz: int, h_dim: int, dirs: int = 1,
                     sm_count: int = _H100_SMS, xw_bytes: int = 4):
    """(cluster size, rows per tile, dynamic shared-memory bytes per block)
    of the inference (``kind="infer"``) or backward (``"bwd"``) kernel for
    ``dirs`` directions of a batch of ``bsz`` rows and ``h_dim`` hidden units
    on a card with ``sm_count`` SMs.

    Both kernels run 256 threads a block, one block an SM, so a block holds at
    most 64 hidden units (4 x 64 gate columns) and at most 16 rows. The
    candidates are every cluster of 1, 2, 4 or 8 blocks with every row count
    1..16 whose block fits the shared memory; the modelled cost is
    ``waves * (rows * max(units per block, 64) + overhead)``, where a wave is
    what the card's SMs hold at once: a step costs its product, rows x the
    block's units, but a slice narrower than 64 units leaves each scheduler
    fewer than two warps of product, and one warp a scheduler cannot hide the
    shared-memory loads, so such a step takes as long as a 64-unit one. Fewer
    rows per tile shorten the step, so the cheapest candidate is the fewest
    rows that keep the fewest waves. At H = 128 this takes a cluster of 2:
    13 rows for both directions at B = 400 (124 blocks, one wave of an H100's
    132 SMs; 8 rows would need 200 blocks, two waves), 7 rows for one
    direction at B = 400 (116 blocks), 5 at B = 300 (120 blocks). A cluster
    of 4 would hold 32 units a block and needs 25 rows at B = 400 for two
    directions in one wave, more than 16; H = 256 takes a cluster of 8.
    ``xw_bytes`` is the inference kernel's xw element size (2 for its bf16
    instance, whose xw tiles take half the shared memory).
    """
    smem_bytes = _smem_fn(kind, xw_bytes)
    best = None
    for resident in (True,) if h_dim <= _RESIDENT_ONLY_HIDDEN else (True, False):
        for cluster in (1, 2, 4, 8):
            hs = -(-h_dim // cluster)
            if 4 * hs > _CLUSTER_COLUMNS or cluster > sm_count:
                continue
            for rows in range(1, MAX_ROWS + 1):
                smem = smem_bytes(h_dim, cluster, rows, resident)
                if smem > MAX_SHARED_BYTES:
                    break
                waves = -(-(-(-bsz // rows) * dirs) // (sm_count // cluster))
                product = rows * max(hs, _FULL_SLICE) * (1 if resident else _WH_GLOBAL_COST)
                cost = waves * (product + _FWD_STEP_OVERHEAD)
                if best is None or cost < best[0]:
                    best = (cost, cluster, rows, smem)
    if best is not None:
        return best[1], best[2], best[3]
    raise ValueError(f"{_KERNEL_NAME[kind]}: no cluster of at most 8 blocks of "
                     f"{_CLUSTER_COLUMNS} threads covers H={h_dim} (at most "
                     f"{MAX_HIDDEN} hidden units)")


def weights_resident(kind: str, h_dim: int, cluster: int, rows: int, smem: int,
                     xw_bytes: int = 4) -> bool:
    """Whether a geometry of ``fwd_geometry`` (kind "fwd") or
    ``cluster_geometry`` keeps wh in shared memory (else the kernel's
    ``wh_global`` variant reads it from device memory)."""
    if kind == "fwd":
        return smem == fwd_smem_bytes(h_dim, cluster)
    return smem == _smem_fn(kind, xw_bytes)(h_dim, cluster, rows)


def wh_slices(wh: torch.Tensor, cluster: int, transposed: bool = False) -> torch.Tensor:
    """wh [H, 4H] laid out for the kernels' ``wh_global`` variants, one slice
    a block as it would lie in shared memory, zero padded: [cluster, H4, 4,
    HS] (wh[k, gate * H + j * HS + u] for block j) for the forward and
    inference kernels, [cluster, 4, H4, HS] (wh^T) with ``transposed`` for
    the backward (H4 = H rounded up to 4, HS = ceil(H / cluster))."""
    h_dim = wh.shape[0]
    hs = -(-h_dim // cluster)
    h4 = -(-h_dim // 4) * 4
    w = wh.reshape(h_dim, 4, h_dim)  # [k, gate, unit]
    if transposed:
        w = w.permute(1, 2, 0)  # [gate, k, unit] = wh^T[gate * H + k, unit]
        w = torch.nn.functional.pad(w, (0, cluster * hs - h_dim, 0, h4 - h_dim))
        return w.reshape(4, h4, cluster, hs).permute(2, 0, 1, 3).contiguous()
    w = torch.nn.functional.pad(w, (0, cluster * hs - h_dim, 0, 0, 0, h4 - h_dim))
    return w.reshape(h4, 4, cluster, hs).permute(2, 0, 1, 3).contiguous()


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
        raise ValueError(f"{name}: the kernel holds 1..{MAX_HIDDEN} hidden units, got {h_dim}")
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
    resident = weights_resident("fwd", h_dim, cluster, rows, smem)
    wsrc = wh if resident else wh_slices(wh, cluster)
    lib = cuda_build.load("lstm_grad")
    with cuda_build.on_device(dev):
        rc = lib.lstm_fwd_launch(xw.data_ptr(), wsrc.data_ptr(), lengths.data_ptr(),
                                 out.data_ptr(), gates.data_ptr(), cc.data_ptr(), hc.data_ptr(),
                                 t_max, bsz, h_dim, rows, cluster, smem, int(not resident),
                                 torch.cuda.current_stream(dev).cuda_stream)
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
    dxw = torch.empty_like(gates)
    dwh = torch.empty_like(wh)
    part = torch.empty((splits, h_dim, 4 * h_dim), dtype=torch.float32, device=dev)
    cluster, rows, smem = cluster_geometry(
        "bwd", bsz, h_dim, 1, torch.cuda.get_device_properties(dev).multi_processor_count)
    resident = weights_resident("bwd", h_dim, cluster, rows, smem)
    wh_t = wh.t().contiguous() if resident else wh_slices(wh, cluster, transposed=True)
    lib = cuda_build.load("lstm_grad")
    with cuda_build.on_device(dev):
        rc = lib.lstm_bwd_launch(gates.data_ptr(), cc.data_ptr(), hc.data_ptr(), dhs.data_ptr(),
                                 wh_t.data_ptr(), lengths.data_ptr(), dxw.data_ptr(),
                                 dwh.data_ptr(), part.data_ptr(), splits, t_max, bsz, h_dim,
                                 rows, cluster, smem, int(not resident),
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
    lib.lstm_fwd_launch.argtypes = [vp] * 7 + [ci] * 7 + [vp]
    lib.lstm_fwd_launch.restype = ci
    lib.lstm_bwd_launch.argtypes = [vp] * 9 + [ci] * 8 + [vp]
    lib.lstm_bwd_launch.restype = ci


cuda_build.register("lstm_grad", _declare)
