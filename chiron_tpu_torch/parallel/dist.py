"""Distributed basecalling and training: batch-sharded decode, file-hash
sharding, batch-norm moments across ranks, and rank start-up.

Port of ``chiron_tpu/parallel/dist.py``:

1. **Within a host**: ``make_sharded_decode_step`` splits each padded batch
   into contiguous shards, one per device, and runs the whole decode step
   (conv_bn, BiLSTM, beam search and traceback kernels) on each shard on its
   device, as the JAX package's ``jax.shard_map`` does. Each conv's batch norm
   therefore takes its moments over its shard only: a BN model's decodes
   depend on the number of shards, in both packages.
2. **Across processes**: ``shard_files`` gives each process a disjoint,
   stable subset of the input files (the same md5 rule as the JAX package's).

Training is the global-batch program, as the JAX package's GSPMD step is:
inside ``global_moments`` every batch-norm moment (``models/layers.py``
``global_bn`` and the fused conv's affine, ``ops/bnlstm.py``'s per-step
moments) is summed over the ranks of the group with a differentiable
all-reduce, so the gradients keep the cross-rank terms of the moments.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def shard_files(file_list: List[str], num_shards: int, shard_index: int) -> List[str]:
    """Deterministic disjoint file sharding by stable content-independent hash."""
    out = []
    for name in file_list:
        h = int.from_bytes(hashlib.md5(name.encode()).digest()[:4], "big")
        if h % num_shards == shard_index:
            out.append(name)
    return out


def process_info():
    """(rank, world size) of the initialised process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _model_device(model) -> torch.device:
    return next(iter(model.parameters())).device


def _indexed(device) -> torch.device:
    # a bare "cuda" is the current GPU: compared with a model's cuda:0 it
    # would not be equal, and the model would be copied needlessly
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_sharded_decode_step(step_fn: Callable, devices: Sequence):
    """Wrap a ``(model, x, seq_len) -> buffer`` decode step to run
    data-parallel over ``devices``.

    The returned step splits x and seq_len into ``len(devices)`` contiguous
    shards; shard i runs ``step_fn`` on ``devices[i]`` with a replica of the
    model there (copied at the model's first step on that device: a decode
    step's weights do not change), and the per-shard buffers
    are concatenated in batch order on ``devices[0]``. Nothing waits on the
    host between shards: each shard's copies and kernels are enqueued on its
    device's stream. Every output of ``step_fn`` must have a leading batch
    axis.
    """
    from chiron_tpu_torch.params import from_jax_params, to_numpy_tree

    devices = [_indexed(d) for d in devices]
    held = {"model": None, "replicas": {}}  # one model's replicas, by device

    def replica(model, dev):
        if _model_device(model) == dev:
            return model
        if held["model"] is not model:
            held["model"], held["replicas"] = model, {}
        if dev not in held["replicas"]:
            held["replicas"][dev] = from_jax_params(to_numpy_tree(model), model.config, dev)
        return held["replicas"][dev]

    def sharded(model, x: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % len(devices):
            raise ValueError(f"batch of {n} windows does not split into {len(devices)} "
                             "equal shards")
        rows = n // len(devices)
        outs = []
        for i, dev in enumerate(devices):
            part = slice(i * rows, (i + 1) * rows)
            outs.append(step_fn(replica(model, dev), x[part].to(dev, non_blocking=True),
                                seq_len[part].to(dev, non_blocking=True)))
        return torch.cat([o.to(devices[0], non_blocking=True) for o in outs])

    return sharded


# ---- batch-norm moments across the ranks of a training group -----------------

_MOMENT_GROUP: contextvars.ContextVar = contextvars.ContextVar("moment_group", default=None)


class _AllSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: the gradient of a rank's input is
    the sum over the ranks of the output's gradient (every rank's loss reads
    the summed moments). ``torch.distributed.nn.functional.all_reduce`` is
    this function, deprecated in torch 2.13."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


@contextlib.contextmanager
def global_moments(group=None):
    """Within this context (in this thread) every batch-norm moment is taken
    over the global batch of the ranks of ``group`` (default: the whole
    initialised group), as the JAX package's global-batch train and eval
    steps take them."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("global_moments needs an initialised process group")
    token = _MOMENT_GROUP.set((group,))  # a tuple: None is the default group
    try:
        yield
    finally:
        _MOMENT_GROUP.reset(token)


def moments_are_global() -> bool:
    """Whether batch-norm moments are summed across ranks here."""
    return _MOMENT_GROUP.get() is not None


def all_sum(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the ranks inside ``global_moments``
    (differentiably), else ``tensor`` itself."""
    state = _MOMENT_GROUP.get()
    if state is None:
        return tensor
    return _AllSum.apply(tensor, state[0])


def global_rows(rows: int) -> int:
    """Inside ``global_moments``: the rows of the ranks' global batch when
    this rank holds ``rows``. Every rank of a data-parallel step holds an
    equal share (``mesh.shard_batch``; ``train``'s B / W rows a rank), so it
    is ``rows`` times the group's size: a host number, which keeps the
    moments' division the one-process step's and needs no collective."""
    group = _MOMENT_GROUP.get()[0]
    return rows * dist.get_world_size(group)


def average_gradients(params) -> None:
    """Every gradient replaced by its mean over the ranks (one all-reduce of
    the gradients flattened into one buffer). Each rank's loss is the mean
    over its equal share of the batch, so the mean of the ranks' gradients is
    the global batch's."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_mean(value: torch.Tensor) -> torch.Tensor:
    """A scalar's mean over the ranks."""
    out = value.detach().clone()
    dist.all_reduce(out)
    return out / dist.get_world_size()


# ---- starting ranks ----------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, init_method, backend, device, threads, args, results):
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn: Callable, devices: Sequence, args=(), backend=None, threads: int = 1,
              timeout: Optional[float] = 600.0) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``len(devices)`` spawned
    processes, rank r on ``devices[r]`` (made current for CUDA) with
    ``threads`` torch threads, all in one process group on 127.0.0.1
    (``backend``: NCCL for CUDA devices, gloo for the CPU, by default).
    Returns the ranks' results in rank order. Raises, with the rank's
    traceback, when a rank fails, and after ``timeout`` seconds (None: no
    limit); every rank is stopped before it returns. ``fn`` and ``args`` are
    pickled (``fn`` by its import path)."""
    devices = [str(torch.device(d)) for d in devices]
    world = len(devices)
    if backend is None:
        backend = "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, args=(fn, rank, world, init_method, backend,
                                                    devices[rank], threads, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = None if timeout is None else time.time() + timeout
        while len(out) < world:
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f"run_ranks: {world - len(out)} of {world} ranks did not "
                                   f"finish within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    # a rank that died without reporting (killed, crashed)
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(f"run_ranks: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    return [out[r] for r in range(world)]

