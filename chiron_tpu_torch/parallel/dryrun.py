"""A data-parallel dry run, and the train steps of one rank.

``dryrun_multichip`` is the port's counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip``: one data-parallel train step over n
ranks (one per device) and the sharded decode at beam 0 and beam 4 over the
same devices, asserting a finite loss and full batches. ``data_parallel_steps``
is a rank's part of such a run; the tests and ``chip_smoke.py`` hold it
against the JAX package's mesh step and against the one-process step.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from chiron_tpu_torch import config as C
from chiron_tpu_torch.models.model import init_model, model_ratio
from chiron_tpu_torch.ops import lstm_grad
from chiron_tpu_torch.parallel.dist import make_sharded_decode_step, run_ranks
from chiron_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from chiron_tpu_torch.params import from_jax_params, to_numpy_tree


def data_parallel_steps(rank: int, world: int, device, config: Dict[str, Any], tree,
                        batches: Sequence[Dict[str, np.ndarray]], opt_name: str = "SGD",
                        lr: float = 1e-3, fl_gamma: float = 0.0,
                        max_steps: int = 100) -> Dict[str, Any]:
    """Train steps from ``tree`` on the global ``batches`` (numpy, seq_len in
    samples), this rank feeding its rows of each: the global-batch step of
    ``train/loop.py`` when a process group is initialised, else the
    one-process step on the whole batch. Returns the losses (the ranks'
    mean), the first step's gradients (averaged over the ranks), the final
    params as a JAX-layout tree, each step's host seconds (batch upload not
    included), the inference logits of this rank's rows of the last batch
    with the final params (a validation step's), and the training LSTM's
    launches."""
    from chiron_tpu_torch.train import loop

    data_parallel = dist.is_available() and dist.is_initialized()
    model = replicate(from_jax_params(tree, config, device)).requires_grad_(True)
    ema = from_jax_params(to_numpy_tree(model), config, device)
    opt = loop.make_optimizer(opt_name, lr, max_steps, model.parameters())
    step = loop.make_train_step(config, fl_gamma, data_parallel)
    launches = dict(lstm_grad.launches)
    losses, grads, seconds = [], None, []
    for i, batch in enumerate(batches):
        ratio = model_ratio(config, batch["signal"].shape[1])
        rows = loop.batch_to_device(shard_batch(batch, rank, world) if data_parallel else batch,
                                    ratio, device)
        t = time.time()
        losses.append(float(step(model, ema, opt, rows, i)))  # float() waits for the step
        seconds.append(time.time() - t)
        if grads is None:
            grads = {k: p.grad.cpu().numpy() for k, p in model.flat.items()
                     if p.grad is not None}
    # the inference logits of this rank's rows of the last batch, as a
    # validation step takes them (moments over the global batch)
    with torch.no_grad(), loop._moments(data_parallel):
        logits = model(rows["signal"], rows["seq_len"]).cpu().numpy()
    return {"losses": losses, "grads": grads, "params": to_numpy_tree(model),
            "seconds": seconds, "logits": logits,
            "launches": {k: n - launches[k] for k, n in lstm_grad.launches.items()}}


def data_parallel_jobs(rank: int, world: int, device, jobs: List[Dict[str, Any]]):
    """Several ``data_parallel_steps`` runs in one rank, one per job (its
    keyword arguments)."""
    return [data_parallel_steps(rank, world, device, **job) for job in jobs]


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """One data-parallel train step over ``n_devices`` ranks, then the
    sharded decode at beam 0 and 4; returns the step's loss."""
    from chiron_tpu_torch.eval.pipeline import decode_step, unpack_step_outputs

    devices = make_mesh(n_devices, device=device)
    if len(devices) != n_devices:
        raise RuntimeError(f"dryrun_multichip: {len(devices)} devices, expected {n_devices}")
    config = C.default_config()
    config["rnn"]["hidden_num"] = 16  # tiny shapes for the dry run
    tree = init_model(torch.Generator().manual_seed(0), config)
    rng = np.random.RandomState(0)
    batch_size = 2 * n_devices
    batch = {"signal": rng.randn(batch_size, 64).astype(np.float32),
             "seq_len": np.full(batch_size, 64, np.int32),
             "label": rng.randint(0, 4, (batch_size, 8)).astype(np.int32),
             "label_len": np.full(batch_size, 8, np.int32)}
    result = run_ranks(data_parallel_steps, devices,
                       args=(config, tree, [batch], "Adam", 1e-3, 2.0))[0]
    loss = result["losses"][0]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    model = from_jax_params(result["params"], config, devices[0])
    x = torch.from_numpy(batch["signal"]).to(devices[0])
    sl = torch.from_numpy(batch["seq_len"]).to(devices[0])
    for beam in (0, 4):
        step = make_sharded_decode_step(functools.partial(decode_step, beam=beam), devices)
        decoded = unpack_step_outputs(step(model, x, sl).cpu().numpy())[0]
        if decoded.shape[0] != batch_size:
            raise AssertionError(f"beam {beam}: {decoded.shape[0]} rows decoded, "
                                 f"expected {batch_size}")
    print(f"dryrun_multichip({n_devices}): loss={loss:.4f} OK")
    return loss
