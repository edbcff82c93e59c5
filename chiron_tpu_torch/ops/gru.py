"""GRU layers for inference (CUDA kernel + plain versions) and the
differentiable step loop for training.

Port of ``chiron_tpu/ops/pallas/gru.py``: ``bigru_layer`` (both directions,
``bigru_layer_pallas``) and ``gru_layer`` (one direction,
``gru_layer_pallas``), over the precomputed input projections
``gx = x @ wx_g + b_g`` ([T, B, 2H], columns r then u) and
``cx = x @ wx_c + b_c`` ([T, B, H]) with the recurrent kernels ``whg``
[H, 2H] and ``whc`` [H, H] (tf.nn.rnn_cell.GRUCell):

    [r, u] = sigmoid(gx[t] + h @ whg)
    cand   = tanh(cx[t] + (r * h) @ whc)
    h'     = u * h + (1 - u) * cand

Row b is active on ``starts[b] <= t < starts[b] + lengths[b]``; outside it
the state is frozen and the output zero. The fused layer's backward
direction reads the time-flipped sequence with ``starts = T - lengths``.

The wrappers launch ``csrc/gru.cu`` for CUDA tensors and run the plain
versions for CPU tensors. The kernel runs both products of a step on the
tensor cores (3xTF32 ``mma.sync``, float32-grade), one block per 8 rows of
one direction, no cluster. ``geometry`` chooses, from (B, H, directions)
alone and before the launch, the kernel's instance: the resident instance (a
direction's whg and whc in each block's shared memory) wherever the weights
fit a block (H <= 128), else the streamed instance (the same kernel reading
the weights from device memory, packed by ``pack_weights``).
``gru_scan`` is the plain step loop, written without in-place updates
so that autograd differentiates it: the training path uses it, as the JAX
package trains the GRU through ``lax.scan`` outside any kernel. H is handled
directly (no padding to 128 lanes).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.lstm import check_cuda_size, check_recurrent_inputs

MAX_SHARED_BYTES = 232448
ROWS = 8  # batch rows a block (csrc/gru.cu: R), the n of one MMA tile
INSTANCES = ("resident", "streamed")

# launches of each CUDA entry point (plain-version calls are not counted), and
# of each instance of the kernel
launches = {"bigru": 0, "gru": 0}
instance_launches = {"resident": 0, "streamed": 0}


class Geometry(NamedTuple):
    """How one GRU layer runs on the card: ``instance`` "resident" (the
    weights in each block's shared memory, a warp a tile of 16 hidden units)
    or "streamed" (read from device memory, a warp two tiles); ``blocks``
    blocks (no cluster) of ``threads`` own ROWS batch rows of one direction
    each, with ``smem_bytes`` of dynamic shared memory."""
    instance: str
    blocks: int
    threads: int
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def unit_tiles(resident: bool) -> int:
    """Tiles of 16 hidden units a warp owns (csrc/gru.cu: UPW)."""
    return 1 if resident else 2


def block_threads(h_dim: int, resident: bool) -> int:
    """Threads a block: a warp per unit tile, or per two of them."""
    return 32 * _ceil(_ceil(h_dim, 16), unit_tiles(resident))


def max_threads(resident: bool) -> int:
    """Threads a block may have (csrc/gru.cu:max_threads): up to 256 for the
    resident instance, 512 for the streamed one (128 registers a thread)."""
    return 256 if resident else 512


def k_steps(h_dim: int) -> int:
    """k steps of 8 of the products, rounded up to a multiple of 4
    (csrc/gru.cu:k_steps): the kernel's k loop runs in unrolled groups of 4."""
    return 4 * _ceil(h_dim, 32)


def smem_bytes(h_dim: int, resident: bool) -> int:
    """Dynamic shared memory of one block (csrc/gru.cu:smem_bytes_for): the
    packed weights 3 x ceil(H/16) x k_steps(H) x 32 float4 (resident only), h
    and r * h [ROWS][8 * k_steps(H) + 4] floats each, the windows."""
    utl, ks = _ceil(h_dim, 16), k_steps(h_dim)
    return (3 * utl * ks * 32 * 16 if resident else 0) + 2 * ROWS * (8 * ks + 4) * 4 + 8 * ROWS


def instances(h_dim: int) -> Tuple[str, ...]:
    """The instances that hold ``h_dim`` hidden units: the resident one only
    where a direction's weights fit a block's shared memory (H <= 128)."""
    return INSTANCES if smem_bytes(h_dim, True) <= MAX_SHARED_BYTES else ("streamed",)


def geometry(bsz: int, h_dim: int, dirs: int = 1, instance: Optional[str] = None) -> Geometry:
    """The geometry of one GRU layer of ``dirs`` directions over ``bsz`` rows
    and ``h_dim`` hidden units: the resident instance wherever a direction's
    weights fit a block's shared memory (H <= 128), else the streamed one, or
    ``instance`` when it is given (the probe and the tests force one). Every
    H in 1..512 and every B >= 1 has one; ValueError past those limits, or
    for a resident instance forced where it does not fit."""
    if not 1 <= h_dim <= 512 or bsz < 1 or dirs not in (1, 2):
        raise ValueError(f"gru: no kernel geometry for B={bsz}, H={h_dim}, {dirs} directions "
                         "(the kernel holds 1..512 hidden units and B >= 1)")
    if instance is None:
        instance = instances(h_dim)[0]
    if instance not in instances(h_dim):
        raise ValueError(f"gru: no {instance} instance for H={h_dim}")
    resident = instance == "resident"
    return Geometry(instance, dirs * _ceil(bsz, ROWS), block_threads(h_dim, resident),
                    smem_bytes(h_dim, resident))


# the unit of a 16-unit tile that row m of an A fragment holds
FRAGMENT_UNITS = [2 * (m % 8) + m // 8 for m in range(16)]


def pack_weights(whg: torch.Tensor, whc: torch.Tensor) -> torch.Tensor:
    """One direction's whg [H, 2H] and whc [H, H] as the kernel's A fragments
    (mma.sync m16n8k8 TF32: M = 16 hidden units of one gate, K = 8 k), which
    the streamed instance reads from device memory (the resident one gathers
    the same values into shared memory itself): for gate r, u, candidate,
    unit tile, k step and lane (g = lane // 4, t = lane % 4) the float4
    (W[k0 + t][u0 + 2g], W[k0 + t][u0 + 2g + 1], W[k0 + t + 4][u0 + 2g],
    W[k0 + t + 4][u0 + 2g + 1]): fragment row m holds the tile's unit
    2 * (m % 8) + m // 8, so that a thread's two units lie side by side; zero
    past H; flat, 3 x ceil(H/16) x k_steps(H) x 128 floats."""
    h_dim = whc.shape[0]
    utl, ks = _ceil(h_dim, 16), k_steps(h_dim)
    w3 = torch.stack([whg[:, :h_dim], whg[:, h_dim:], whc])  # [gate, k, unit]
    w3 = torch.nn.functional.pad(w3, (0, 16 * utl - h_dim, 0, 8 * ks - h_dim))
    a = w3.reshape(3, ks, 8, utl, 16).permute(0, 3, 1, 4, 2)  # [gate, tile, step, unit, k]
    a = a[:, :, :, FRAGMENT_UNITS]  # [gate, tile, step, m, k]
    lane = torch.arange(32, device=whc.device)
    g, t = lane // 4, lane % 4
    frag = torch.stack([a[..., g, t], a[..., g + 8, t], a[..., g, t + 4], a[..., g + 8, t + 4]],
                       dim=-1)
    return frag.reshape(-1).contiguous()


def gru_scan(gx, cx, whg, whc, lo, hi):
    """The GRU recurrence as a differentiable step loop. ``lo``/``hi``: [B]
    bounds of each row's active window."""
    t_max, bsz, h_dim = cx.shape
    h = cx.new_zeros((bsz, h_dim))
    zero = cx.new_zeros((bsz, h_dim))
    outs = []
    for t in range(t_max):
        r, u = torch.sigmoid(gx[t] + h @ whg).split(h_dim, dim=1)
        cand = torch.tanh(cx[t] + (r * h) @ whc)
        nh = u * h + (1.0 - u) * cand
        m = ((lo <= t) & (t < hi))[:, None]
        h = torch.where(m, nh, h)
        outs.append(torch.where(m, nh, zero))
    return torch.stack(outs)


def gru_layer_plain(gx, cx, whg, whc, lengths, starts=None):
    """Plain PyTorch version of the one-direction kernel."""
    lo = torch.zeros_like(lengths) if starts is None else starts
    return gru_scan(gx, cx, whg, whc, lo, lo + lengths)


def bigru_layer_plain(gx_fw, cx_fw, gx_bw, cx_bw, wh_fw, wh_bw, lengths, starts_bw):
    """Plain PyTorch version of the fused kernel."""
    return (gru_layer_plain(gx_fw, cx_fw, *wh_fw, lengths),
            gru_layer_plain(gx_bw, cx_bw, *wh_bw, lengths, starts_bw))


def _shapes(t_max, bsz, h_dim):
    return ((t_max, bsz, 2 * h_dim), (t_max, bsz, h_dim), (h_dim, 2 * h_dim), (h_dim, h_dim))


def _ptr(tsr):
    return None if tsr is None else tsr.data_ptr()


def _launch(entry: str, gxs, cxs, whs, lengths: torch.Tensor,
            starts: Optional[torch.Tensor], geom: Optional[Geometry] = None):
    """Launch one layer (1 or 2 directions) at ``geom`` (default: the one
    ``geometry`` chooses); returns the output tensors."""
    t_max, bsz, h_dim = cxs[0].shape
    dev = cxs[0].device
    if geom is None:
        geom = geometry(bsz, h_dim, len(cxs))
    ins = [a.contiguous() for pair in zip(gxs, cxs) for a in pair]
    weights = [w.contiguous() for pair in whs for w in pair]
    # the streamed instance reads the fragments packed; the resident one
    # gathers them from whg and whc itself
    packed = ([pack_weights(whg, whc) for whg, whc in whs] if geom.instance == "streamed"
              else [None] * len(whs))
    lengths = lengths.contiguous()
    starts = None if starts is None else starts.contiguous()
    outs = [torch.empty((t_max, bsz, h_dim), dtype=torch.float32, device=dev) for _ in cxs]
    lib = cuda_build.load("gru")
    with cuda_build.on_device(dev):
        rc = getattr(lib, f"{entry}_launch")(
            *[a.data_ptr() for a in ins + weights], *[_ptr(w) for w in packed],
            lengths.data_ptr(), _ptr(starts), *[o.data_ptr() for o in outs], t_max, bsz,
            h_dim, int(geom.instance == "streamed"), geom.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, f"{entry}_layer ({geom.instance} instance)")
    launches[entry] += 1
    instance_launches[geom.instance] += 1
    return outs


def gru_layer(gx: torch.Tensor, cx: torch.Tensor, whg: torch.Tensor, whc: torch.Tensor,
              lengths: torch.Tensor, starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU direction.

    Args:
      gx: [T, B, 2H], cx: [T, B, H], whg: [H, 2H], whc: [H, H], float32.
      lengths: [B] int32; starts: [B] int32 or None (every window from 0).
    Returns:
      hs [T, B, H] float32, zero outside each row's window.
    """
    t_max, bsz, h_dim = cx.shape
    dev = check_recurrent_inputs("gru_layer", (gx, cx, whg, whc), _shapes(t_max, bsz, h_dim),
                                 (lengths, starts), bsz)
    if dev.type == "cpu":
        return gru_layer_plain(gx, cx, whg, whc, lengths, starts)
    check_cuda_size("gru_layer", t_max, bsz, h_dim)
    return _launch("gru", (gx,), (cx,), ((whg, whc),), lengths, starts)[0]


def bigru_layer(gx_fw: torch.Tensor, cx_fw: torch.Tensor, gx_bw: torch.Tensor,
                cx_bw: torch.Tensor, wh_fw: Tuple[torch.Tensor, torch.Tensor],
                wh_bw: Tuple[torch.Tensor, torch.Tensor], lengths: torch.Tensor,
                starts_bw: torch.Tensor):
    """Both directions of one GRU layer.

    Args:
      gx_*: [T, B, 2H], cx_*: [T, B, H] float32; the backward pair are
        projections of the time-flipped input.
      wh_fw, wh_bw: (whg [H, 2H], whc [H, H]) per direction.
      lengths, starts_bw: [B] int32 (starts_bw = T - lengths).
    Returns:
      (hs_fw, hs_bw) each [T, B, H], zero outside each row's window; hs_bw
      is in flipped time order (the caller flips back).
    """
    t_max, bsz, h_dim = cx_fw.shape
    floats = (gx_fw, cx_fw, *wh_fw, gx_bw, cx_bw, *wh_bw)
    dev = check_recurrent_inputs("bigru_layer", floats, _shapes(t_max, bsz, h_dim) * 2,
                                 (lengths, starts_bw), bsz)
    if dev.type == "cpu":
        return bigru_layer_plain(gx_fw, cx_fw, gx_bw, cx_bw, wh_fw, wh_bw, lengths, starts_bw)
    check_cuda_size("bigru_layer", t_max, bsz, h_dim)
    out_f, out_b = _launch("bigru", (gx_fw, gx_bw), (cx_fw, cx_bw), (wh_fw, wh_bw), lengths,
                           starts_bw)
    return out_f, out_b


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bigru_launch.argtypes = [vp] * 14 + [ci] * 5 + [vp]
    lib.bigru_launch.restype = ci
    lib.gru_launch.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    lib.gru_launch.restype = ci


cuda_build.register("gru", _declare)
