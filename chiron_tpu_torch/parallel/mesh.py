"""Devices and data-parallel sharding helpers.

Port of ``chiron_tpu/parallel/mesh.py``. The JAX package shards the batch
on a 1-D ``jax.sharding.Mesh`` and lets GSPMD insert the collectives; the
port is PyTorch's data parallelism instead: one process (rank) per GPU in a
``torch.distributed`` group, parameters replicated by a broadcast from rank
0, each rank feeding its contiguous rows of the global batch. The "mesh" is
an ordered list of ``torch.device``s.

One difference from the JAX package: ``make_mesh`` raises when more CUDA
devices are asked for than are visible; JAX's silently takes fewer.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

def make_mesh(n_devices: int = 0, devices: Optional[Sequence] = None,
              device="cuda") -> List[torch.device]:
    """The first ``n_devices`` (0: all) of ``devices``, by default every
    visible device of ``device``'s type: ``cuda:0 .. cuda:N-1``; the CPU is
    one device, which a mesh of n lists n times."""
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        elif kind == "cpu":
            devices = [torch.device("cpu")] * max(int(n_devices or 0), 1)
        else:
            raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    devices = [torch.device(d) for d in devices]
    if n_devices and n_devices > len(devices):
        raise RuntimeError(f"{n_devices} devices requested but {len(devices)} available "
                           f"(torch.cuda.device_count() is {torch.cuda.device_count()})")
    if n_devices and n_devices > 0:
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError(f"no {device} device is visible")
    return devices


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of a global batch (a dict of arrays or
    tensors with a leading batch axis), of ``world`` equal shares."""
    out = {}
    for key, value in batch.items():
        n = value.shape[0]
        if n % world:
            raise ValueError(f"batch of {n} rows does not split into {world} equal shards")
        rows = n // world
        out[key] = value[rank * rows:(rank + 1) * rows]
    return out


def local_rows(shards) -> np.ndarray:
    """A tensor, or per-device shards in batch order, as one host array: the
    inverse of ``shard_batch`` for reading results back."""
    if isinstance(shards, torch.Tensor):
        shards = [shards]
    return np.concatenate([s.detach().cpu().numpy() for s in shards], axis=0)


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0 of the
    initialised process group (in place); a no-op without a group."""
    if dist.is_available() and dist.is_initialized():
        with torch.no_grad():
            for tensor in list(module.parameters()) + list(module.buffers()):
                # NCCL broadcasts contiguous tensors only (a checkpoint's
                # Fortran-ordered leaf keeps its strides)
                buf = tensor.data.contiguous()
                dist.broadcast(buf, src=0)
                if buf.data_ptr() != tensor.data.data_ptr():
                    tensor.data.copy_(buf)
    return module


def pad_to_multiple(batch_arrays, multiple: int):
    """Pad leading axis to a multiple of the mesh size (static shapes)."""
    n = batch_arrays[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch_arrays, n
    out = []
    for arr in batch_arrays:
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        out.append(np.pad(arr, widths, mode="wrap"))
    return out, n


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda") -> None:
    """Join the multi-process group: one process per GPU (NCCL), or per CPU
    worker with ``device="cpu"`` (gloo).

    ``coordinator_address`` is ``host:port`` of rank 0; without it the
    ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) names the group. A CUDA process first makes its GPU
    current: ``LOCAL_RANK``, else its rank modulo the visible GPUs. A failed
    NCCL set-up raises; nothing falls back to gloo or to the CPU.
    """
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("initialize_distributed(device='cuda'): no CUDA device is "
                               "visible (torch.cuda.device_count() is 0)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id % count)))
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init_method,
                            world_size=num_processes, rank=process_id)
