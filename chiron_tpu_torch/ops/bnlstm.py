"""Recurrent-batch-norm LSTM layers (arxiv 1603.09025) for inference (CUDA
kernel + plain versions) and the differentiable step loop for training.

Port of ``chiron_tpu/ops/pallas/bnlstm.py``: ``bibnlstm_layer`` (both
directions, ``bibnlstm_layer_pallas``) and ``bnlstm_layer`` (one direction,
``bnlstm_layer_pallas``), over the raw input projection ``xw = x @ wx``
WITHOUT bias ([T, B, 4H], gate order i, g, f, o, forget bias +1). Per step,
with BN(v) = (v - mean) * rsqrt(var + 1e-5) * scale and the moments taken
per column over the rows still active at that step (``t < lengths[b]``; the
count is at least 1):

    gates = BN_x(xw[t]) + BN_h(h @ wh) + b
    c'    = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
    h'    = sigmoid(o) * tanh(BN_c(c') + offset_c)

A row past its length keeps its state and puts out zero. There are no start
offsets: both directions mask on ``t < len`` and the caller reverses the
backward direction's input within each length (``reverse_sequence``),
because under a flip the moments would cover another set of rows.

The wrappers launch ``csrc/bnlstm.cu`` for CUDA tensors and run the plain
versions for CPU tensors. ``geometry`` chooses, from (B, H) alone and before
the launch, which of the kernel's two instances runs and how: the cluster
instance (one or two thread-block clusters of up to 16 blocks per direction,
each split into row groups x hidden-unit slices, wh resident in shared
memory, the step's moments exchanged through distributed shared memory and,
between the two clusters of a direction, through device memory) wherever the
clusters' shared memory holds the shape, else the cooperative instance (one
block per tile of rows, wh from L2, grid-wide barriers), else it raises.
Among the cluster geometries that fit it takes the cheapest by a cost model
fitted to ``tools/kernel_probe.py bnlstm``'s clocks of every candidate on an
H100. ``bnlstm_scan`` is the plain step loop, written without in-place
updates so that autograd differentiates it: the training path uses it, as
the JAX package trains this cell through ``lax.scan`` outside any kernel. H is
handled directly (no padding to 128 lanes).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.ops.lstm import check_cuda_size, check_recurrent_inputs
from chiron_tpu_torch.parallel.dist import all_sum

_FORGET_BIAS = 1.0
_BN_EPS = 1e-5
MAX_SHARED_BYTES = 232448
_H100_SMS = 132
# the cluster instance: blocks of a cluster (16 is not portable; the wrapper
# asks the card whether it takes 16, else 8), a thread's tile of rows x units,
# and threads a block (csrc/bnlstm.cu:cluster_max_threads)
MAX_CLUSTER = 16
_CLUSTERS = (1, 2, 4, 8, 16)
_THREAD_TILES = ((4, 1), (8, 1), (8, 2))
CLUSTER_THREADS = 512


def cluster_max_threads(rows: int, units: int) -> int:
    """Threads a block of the cluster instance may have at a thread tile of
    rows x units: tiles of 8 or more elements need up to 255 registers a
    thread."""
    return 256 if rows * units >= 8 else CLUSTER_THREADS

# the cooperative instance: batch rows per block, smallest first
_ROW_TILES = (8, 16, 32, 64)
# The cost model of a cluster geometry, in clocks of a step (see
# cluster_step_cost), fitted to kernel_probe.py's clocks of every candidate at
# B = 400, H = 128 on an H100: shared memory hands the lanes ~108 bytes a
# clock; the product issues at ~55% of the FMA rate with at most two warps a
# scheduler, ~80% with more; a stage's instructions per (row, unit) element;
# a cluster barrier; one exchange of moments between the clusters of a
# direction through device memory.
_SMEM_BYTES_PER_CLOCK = 108
_GATE_ISSUE = 150
_H_ISSUE = 180
_STAGE = 1500
_CLUSTER_BARRIER = 1300
_WIDE_SLICING = 500       # the first barrier's wait, per unit slice past 4
_CROSS_EXCHANGE = 3000
# clusters a direction at most (csrc/bnlstm.cu:MAX_SPLIT)
MAX_SPLIT = 2

# launches of each CUDA entry point (plain-version calls are not counted), and
# of each instance of the recurrence
launches = {"bibnlstm": 0, "bnlstm": 0}
instance_launches = {"cluster": 0, "cooperative": 0}


class Geometry(NamedTuple):
    """How one BNLSTM layer runs on the card. ``instance`` "cluster":
    ``split`` clusters of ``cluster`` blocks per direction, each cluster
    ``row_groups`` x ``unit_slices`` of them, a thread's tile ``rows`` batch
    rows x ``units`` hidden units; "cooperative": ``row_groups`` blocks
    (tiles) per direction of ``rows`` batch rows, no cluster (``cluster``,
    ``unit_slices``, ``units`` and ``split`` are 1). ``threads`` per block,
    ``smem_bytes`` of dynamic shared memory per block."""
    instance: str
    cluster: int
    row_groups: int
    unit_slices: int
    rows: int
    units: int
    threads: int
    smem_bytes: int
    split: int = 1

Weights = Tuple[torch.Tensor, ...]  # (wh, b, scale_x, scale_h, scale_c, offset_c)


def _batch_norm_step(x, scale, m, count):
    mean = all_sum((x * m).sum(dim=0, keepdim=True)) / count
    var = all_sum((((x - mean) ** 2) * m).sum(dim=0, keepdim=True)) / count
    return (x - mean) * torch.rsqrt(var + _BN_EPS) * scale


def bnlstm_scan(xw, wh, b, scale_x, scale_h, scale_c, offset_c, lengths):
    """The recurrence as a differentiable step loop (two-pass moments, as
    the JAX package's ``_bnlstm_scan``). Inside
    ``parallel.dist.global_moments`` each step's moments and its count of
    active rows are summed over the ranks: the global batch's."""
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    h = xw.new_zeros((bsz, h_dim))
    c = xw.new_zeros((bsz, h_dim))
    outs = []
    for t in range(t_max):
        m = (t < lengths)[:, None].to(xw.dtype)
        count = all_sum(m.sum()).clamp(min=1.0)
        gates = (_batch_norm_step(xw[t], scale_x, m, count)
                 + _batch_norm_step(h @ wh, scale_h, m, count) + b)
        i, g, f, o = gates.split(h_dim, dim=1)
        nc = torch.sigmoid(f + _FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(g)
        nh = torch.sigmoid(o) * torch.tanh(_batch_norm_step(nc, scale_c, m, count) + offset_c)
        c = m * nc + (1.0 - m) * c
        h = m * nh + (1.0 - m) * h
        outs.append(m * nh)
    return torch.stack(outs)


def bnlstm_layer_plain(xw, wh, b, scale_x, scale_h, scale_c, offset_c, lengths):
    """Plain PyTorch version of the one-direction kernel."""
    return bnlstm_scan(xw, wh, b, scale_x, scale_h, scale_c, offset_c, lengths)


def bibnlstm_layer_plain(xw_fw, xw_bw, fw_weights, bw_weights, lengths):
    """Plain PyTorch version of the fused kernel."""
    return (bnlstm_scan(xw_fw, *fw_weights, lengths), bnlstm_scan(xw_bw, *bw_weights, lengths))


def _shapes(t_max, bsz, h_dim):
    g = 4 * h_dim
    return ((t_max, bsz, g), (h_dim, g), (g,), (g,), (g,), (h_dim,), (h_dim,))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return _ceil(n, 4) * 4


class _Tiles(NamedTuple):
    slice_units: int  # hidden units of a slice
    tile_units: int   # thread tiles along a block's units
    units: int        # a block's units, padded to the thread tile
    row_tiles: int    # thread tiles along a row group's rows
    rows: int         # a row group's rows, padded to the thread tile


def _tiles(bsz, h_dim, row_groups, unit_slices, rows, units, split=1) -> _Tiles:
    hsl = _ceil(h_dim, unit_slices)
    hsu = _ceil(hsl, units)
    nt = _ceil(_ceil(bsz, row_groups * split), rows)
    return _Tiles(hsl, hsu, hsu * units, nt, nt * rows)


def cluster_smem_bytes(bsz: int, h_dim: int, row_groups: int, unit_slices: int, rows: int,
                       units: int, split: int = 1) -> int:
    """Dynamic shared memory of one block of the cluster instance
    (csrc/bnlstm.cu:cluster_layout): its slice of wh [H4, 4*HS], the row
    group's h [H4, RBP], xw[t] [RBP, 4*HS] and its moments, c [RBP, HS], the
    thread tiles' partial sums, the per-column constants and moments, the
    exchange slots of the row groups' moments, its lengths and the mbarrier
    of the bulk copies (H4 = H
    rounded up to 4; HS = ceil(H / unit_slices) rounded up to ``units``; RBP =
    ceil(B / (row_groups * split)) rounded up to ``rows``)."""
    tl = _tiles(bsz, h_dim, row_groups, unit_slices, rows, units, split)
    hs, rbp, nt = tl.units, tl.rows, tl.row_tiles
    lc = 4 * hs
    h4 = _round4(h_dim)
    floats = (h4 * lc + h4 * rbp + rbp * lc + 2 * lc + rbp * hs + nt * (lc + 4) + lc + 4 * lc
              + 3 * lc + 2 * row_groups * lc + _round4(2 * row_groups * hs) + 2 * _round4(2 * hs)
              + _round4(2 * row_groups) + rbp + rbp % 2 + 4)
    return 4 * floats


def coop_smem_bytes(h_dim: int, rows: int) -> int:
    """Dynamic shared memory of one block of the cooperative instance: h, c
    and the gates of its rows, and their lengths."""
    return 4 * rows * (6 * h_dim + 1)


def cluster_step_cost(bsz: int, h_dim: int, row_groups: int, unit_slices: int, rows: int,
                      units: int, split: int = 1) -> int:
    """Modelled clocks of one step of the cluster instance, from the block's
    padded share (rows x units of its thread tiles) and its warps on four
    schedulers. The product takes the longer of the shared memory's delivery
    of h and wh to the lanes ((rows + 4 x units) floats a lane per k for 4 x
    rows x units FMA) and the FMA issue of the busiest scheduler; the gate
    stage and the h' stage their instructions per element; the moments'
    owner passes over the block's columns; two cluster barriers (one row
    group: one, split around the moments), the first waiting longer past 4
    unit slices; and, for a direction split over clusters, two exchanges
    through device memory."""
    tl = _tiles(bsz, h_dim, row_groups, unit_slices, rows, units, split)
    threads = _ceil(tl.tile_units * tl.row_tiles, 32) * 32
    per_sched = _ceil(threads // 32, 4)
    fma = tl.rows * tl.units * 4 * h_dim
    delivered = fma * (rows + 4 * units) / (rows * units) / _SMEM_BYTES_PER_CLOCK
    issue = fma / (128 * (0.55 if per_sched <= 2 else 0.8))
    elements = rows * units
    stages = (_STAGE + per_sched * elements * _GATE_ISSUE) + (_STAGE + elements * _H_ISSUE) \
        + _STAGE * (1 + _ceil(4 * tl.units, threads))
    cluster = row_groups * unit_slices
    barriers = 0 if cluster == 1 else (2 if row_groups > 1 else 1) * _CLUSTER_BARRIER \
        + _WIDE_SLICING * max(0, unit_slices - 4)
    return int(max(delivered, issue) + stages + barriers + 2 * (split - 1) * _CROSS_EXCHANGE)


def cluster_candidates(bsz: int, h_dim: int, max_cluster: int = MAX_CLUSTER,
                       max_split: int = MAX_SPLIT):
    """Every cluster geometry whose block fits: (cost, cluster, row groups,
    unit slices, rows, units, threads, shared bytes, split), cheapest first.
    A geometry whose last row group or unit slice would be empty is left out,
    and a direction is split over clusters only where each has row groups to
    combine."""
    out = []
    for cluster in _CLUSTERS:
        if cluster > max_cluster:
            continue
        for rg in (d for d in _CLUSTERS if cluster % d == 0):
            us = cluster // rg
            hsl = _ceil(h_dim, us)
            for split in range(1, max_split + 1):
                rb = _ceil(bsz, rg * split)
                if (us - 1) * hsl >= h_dim or (rg * split - 1) * rb >= bsz or \
                        (split > 1 and rg < 2):
                    continue
                for rows, units in _THREAD_TILES:
                    tl = _tiles(bsz, h_dim, rg, us, rows, units, split)
                    threads = _ceil(tl.tile_units * tl.row_tiles, 32) * 32
                    smem = cluster_smem_bytes(bsz, h_dim, rg, us, rows, units, split)
                    if threads > cluster_max_threads(rows, units) or smem > MAX_SHARED_BYTES:
                        continue
                    out.append((cluster_step_cost(bsz, h_dim, rg, us, rows, units, split),
                                cluster, rg, us, rows, units, threads, smem, split))
    return sorted(out)


def geometry(bsz: int, h_dim: int, dirs: int = 1, sm_count: int = _H100_SMS,
             max_cluster: int = MAX_CLUSTER, max_split: int = MAX_SPLIT) -> Geometry:
    """The instance and geometry of one BNLSTM layer of ``dirs`` directions
    over a batch of ``bsz`` rows and ``h_dim`` hidden units, on a card with
    ``sm_count`` SMs that launches clusters of up to ``max_cluster`` blocks and
    holds ``max_split`` of them a direction at once.

    The cluster instance wherever some cluster geometry fits: the cheapest
    by ``cluster_step_cost`` (it does not depend on ``dirs``: each direction
    has its own clusters, so the fused layer is two single ones, bit for
    bit).
    At H = 128, B = 400 that is 2 clusters of 16 per direction, each 4 row
    groups of 50 rows x 4 slices of 32 units, 8 rows x 1 unit a thread. Else the cooperative instance at the smallest row
    tile whose grid is co-resident at one block an SM (the launch checks the
    card's own occupancy), else ValueError."""
    cands = cluster_candidates(bsz, h_dim, max_cluster, max_split)
    if cands:
        return Geometry("cluster", *cands[0][1:])
    for rows in _ROW_TILES:
        smem = coop_smem_bytes(h_dim, rows)
        tiles = _ceil(bsz, rows)
        if smem <= MAX_SHARED_BYTES and tiles * dirs <= sm_count:
            return Geometry("cooperative", 1, tiles, 1, rows, 1,
                            min(_ceil(4 * h_dim, 32) * 32, 1024), smem)
    raise ValueError(f"bnlstm: [B={bsz}, H={h_dim}] fits neither a cluster of "
                     f"{max_cluster} blocks nor a co-resident grid of {dirs} x B / "
                     f"{_ROW_TILES[-1]} blocks")


def scratch_floats(t_max: int, h_dim: int, dirs: int, geom: Geometry) -> int:
    """Float32 scratch of one launch: the xw moments, and the cooperative
    instance's per-tile partials."""
    n = dirs * t_max * 8 * h_dim
    if geom.instance == "cooperative":
        n += dirs * geom.row_groups * (10 * h_dim + 2)
    return n


def zeroed_words(dirs: int, h_dim: int, geom: Geometry) -> int:
    """Zeroed uint32 of one launch: the cooperative instance's two barrier
    counters, then, for a direction split over clusters, the tagged 64-bit
    words of their exchange (2 kinds x 2 parities a cluster and unit slice,
    2 * LC + 2 words each)."""
    if geom.split == 1:
        return 2
    lc = 4 * _ceil(_ceil(h_dim, geom.unit_slices), geom.units) * geom.units
    return 2 + 2 * dirs * 4 * geom.split * geom.unit_slices * (2 * lc + 2)


_CARD_LIMITS = {}


def card_limits(dev: torch.device) -> Tuple[int, int]:
    """(max_cluster, max_split) for ``geometry`` on this card, asked once per
    device: clusters of 16 if the card holds one of the cluster instance's
    largest blocks (else 8, a portable size), and a direction split over 2
    clusters if it holds 4 such clusters at once (two directions)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _CARD_LIMITS:
        lib = cuda_build.load("bnlstm")
        count = ctypes.c_int(0)
        with cuda_build.on_device(idx):
            rc = lib.bnlstm_active_clusters(MAX_CLUSTER, 8, 2, 256, MAX_SHARED_BYTES,
                                            ctypes.byref(count))
        cuda_build.check(rc, "bnlstm_active_clusters")
        _CARD_LIMITS[idx] = (MAX_CLUSTER if count.value >= 1 else 8,
                             MAX_SPLIT if count.value >= 2 * MAX_SPLIT else 1)
    return _CARD_LIMITS[idx]


def _launch(entry: str, xws: Sequence[torch.Tensor], weights: Sequence[Weights],
            lengths: torch.Tensor, geom: Geometry = None):
    """Launch one layer (1 or 2 directions) at ``geom`` (default: the one
    ``geometry`` chooses); returns the output tensors."""
    t_max, bsz, four_h = xws[0].shape
    h_dim = four_h // 4
    dev = xws[0].device
    dirs = len(xws)
    if geom is None:
        geom = geometry(bsz, h_dim, dirs, torch.cuda.get_device_properties(dev).multi_processor_count,
                        *card_limits(dev))
    xws = [x.contiguous() for x in xws]
    whs = [w[0].contiguous() for w in weights]
    vecs = [torch.cat([v.reshape(-1) for v in w[1:]]) for w in weights]
    lengths = lengths.contiguous()
    outs = [torch.empty((t_max, bsz, h_dim), dtype=torch.float32, device=dev) for _ in xws]
    scratch = torch.empty(scratch_floats(t_max, h_dim, dirs, geom), dtype=torch.float32,
                          device=dev)
    bar = torch.zeros(zeroed_words(dirs, h_dim, geom), dtype=torch.int32, device=dev)
    lib = cuda_build.load("bnlstm")
    ptrs = [t.data_ptr() for group in (xws, whs, vecs) for t in group]
    with cuda_build.on_device(dev):
        rc = getattr(lib, f"{entry}_launch")(
            *ptrs, lengths.data_ptr(), *[o.data_ptr() for o in outs], scratch.data_ptr(),
            bar.data_ptr(), t_max, bsz, h_dim, int(geom.instance == "cluster"), geom.cluster,
            geom.split, geom.row_groups, geom.rows, geom.units, geom.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, f"{entry}_layer ({geom.instance} instance)")
    launches[entry] += 1
    instance_launches[geom.instance] += 1
    return outs


def bnlstm_layer(xw: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, scale_x: torch.Tensor,
                 scale_h: torch.Tensor, scale_c: torch.Tensor, offset_c: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """One recurrent-BN LSTM direction.

    Args:
      xw: [T, B, 4H] float32, x @ wx without bias; wh: [H, 4H];
      b, scale_x, scale_h: [4H]; scale_c, offset_c: [H]; lengths: [B] int32.
    Returns:
      hs [T, B, H] float32, zero past each length.
    """
    t_max, bsz, four_h = xw.shape
    h_dim = four_h // 4
    weights = (wh, b, scale_x, scale_h, scale_c, offset_c)
    dev = check_recurrent_inputs("bnlstm_layer", (xw, *weights), _shapes(t_max, bsz, h_dim),
                                 (lengths,), bsz)
    if dev.type == "cpu":
        return bnlstm_layer_plain(xw, *weights, lengths)
    check_cuda_size("bnlstm_layer", t_max, bsz, h_dim)
    return _launch("bnlstm", (xw,), (weights,), lengths)[0]


def bibnlstm_layer(xw_fw: torch.Tensor, xw_bw: torch.Tensor, fw_weights: Weights,
                   bw_weights: Weights, lengths: torch.Tensor):
    """Both directions of one recurrent-BN LSTM layer.

    Args:
      xw_fw, xw_bw: [T, B, 4H] float32 raw input projections (no bias), the
        backward one of the input reversed within each length.
      fw_weights, bw_weights: (wh, b, scale_x, scale_h, scale_c, offset_c)
        per direction.
      lengths: [B] int32.
    Returns:
      (hs_fw, hs_bw) each [T, B, H], zero past each length; hs_bw is in
      reversed time order (the caller reverses back).
    """
    t_max, bsz, four_h = xw_fw.shape
    h_dim = four_h // 4
    if len(fw_weights) != 6 or len(bw_weights) != 6:
        raise ValueError("bibnlstm_layer: weights are (wh, b, scale_x, scale_h, scale_c, offset_c)")
    dev = check_recurrent_inputs("bibnlstm_layer", (xw_fw, *fw_weights, xw_bw, *bw_weights),
                                 _shapes(t_max, bsz, h_dim) * 2, (lengths,), bsz)
    if dev.type == "cpu":
        return bibnlstm_layer_plain(xw_fw, xw_bw, fw_weights, bw_weights, lengths)
    check_cuda_size("bibnlstm_layer", t_max, bsz, h_dim)
    out_f, out_b = _launch("bibnlstm", (xw_fw, xw_bw), (fw_weights, bw_weights), lengths)
    return out_f, out_b


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bibnlstm_launch.argtypes = [vp] * 11 + [ci] * 10 + [vp]
    lib.bibnlstm_launch.restype = ci
    lib.bnlstm_launch.argtypes = [vp] * 7 + [ci] * 10 + [vp]
    lib.bnlstm_launch.restype = ci
    lib.bnlstm_active_clusters.argtypes = [ci] * 5 + [vp]
    lib.bnlstm_active_clusters.restype = ci


cuda_build.register("bnlstm", _declare)
