"""The trainer, one GPU or data-parallel: port of ``chiron_tpu/train/loop.py``.

Optimisation parity with the JAX package (chiron/chiron_model.py:20-99):

- piecewise-constant LR at 66% / 83% of max_steps x {1, 0.1, 0.01},
  evaluated, as optax does, at the count of updates already applied;
- Adam / SGD / RMSProp / Momentum (Nesterov 0.9) with optax's constants:
  Adam, SGD and Nesterov momentum are ``torch.optim`` set up as optax sets
  them; RMSProp is written here, because optax's (decay 0.9, eps inside the
  square root) is not ``torch.optim.RMSprop``'s (alpha 0.99, eps outside);
- optional clipping by the global gradient norm;
- an exponential moving average of the weights (decay 0.9999) with
  tf.train.ExponentialMovingAverage's ``num_updates`` ramp;
- the CTC loss with focal modulation (``fl_gamma``).

A train step runs ``apply_model(..., training=True)``: the CNN as torch ops
and each LSTM direction through the ``ops/lstm_grad.py`` kernels. The eval
step runs inference ``apply_model`` (the fused kernels) and greedy decode.
Checkpoints are the JAX package's ``.npz`` files, so either package resumes
the other's runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from chiron_tpu_torch import config as C
from chiron_tpu_torch.io.binfmt import read_bin_folder
from chiron_tpu_torch.io.cache import cached_dataset
from chiron_tpu_torch.io.labels import read_raw_data_sets
from chiron_tpu_torch.io.tfrecord import read_tfrecord_data_sets
from chiron_tpu_torch.models.model import init_model, model_ratio
from chiron_tpu_torch.ops.ctc_greedy import greedy_decode
from chiron_tpu_torch.ops.ctc_loss import ctc_focal_loss
from chiron_tpu_torch.ops import cuda_build
from chiron_tpu_torch.parallel.dist import (all_mean, average_gradients, global_moments,
                                            process_info, run_ranks)
from chiron_tpu_torch.parallel.mesh import local_rows, make_mesh, replicate, shard_batch
from chiron_tpu_torch.params import Basecaller, from_jax_params, to_numpy_tree
from chiron_tpu_torch.train.checkpoint import restore_latest, save_checkpoint
from chiron_tpu_torch.utils.device import float32_strict, resolve_device
from chiron_tpu_torch.utils.timing import profiled, span

MOVING_AVERAGE_DECAY = 0.9999
LR_BOUNDARY = [0.66, 0.83]
LR_DECAY = [1e-1, 1e-2]
MOMENTUM = 0.9


def make_lr_schedule(init_rate: float, max_steps: int):
    """count -> learning rate (optax.piecewise_constant_schedule: the scale
    of a boundary applies from ``count >= boundary`` on)."""
    boundaries = {
        int(max_steps * LR_BOUNDARY[0]): LR_DECAY[0],
        int(max_steps * LR_BOUNDARY[1]): LR_DECAY[1] / LR_DECAY[0],
    }

    def schedule(count: int) -> float:
        v = init_rate
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                v *= scale
        return v

    return schedule


class _RMSProp(torch.optim.Optimizer):
    """optax.rmsprop: nu = decay * nu + (1 - decay) * g^2 from nu = 0, and
    p -= lr * g * rsqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.addcmul_(p.grad, torch.rsqrt(nu + group["eps"]), value=-group["lr"])


_OPTIMIZERS = {
    "Adam": lambda ps: torch.optim.Adam(ps, lr=0.0, betas=(0.9, 0.999), eps=1e-8),
    "SGD": lambda ps: torch.optim.SGD(ps, lr=0.0),
    "RMSProp": lambda ps: _RMSProp(ps, lr=0.0),
    "Momentum": lambda ps: torch.optim.SGD(ps, lr=0.0, momentum=MOMENTUM, nesterov=True),
}


class Optimizer:
    """optax's chain (clip_by_global_norm?, optimizer, scheduled LR) over
    ``params``; ``count`` is the number of updates applied."""

    def __init__(self, opt_name: str, init_rate: float, max_steps: int, params,
                 clip_norm: Optional[float] = None):
        if opt_name not in _OPTIMIZERS:
            raise ValueError(f"Unknown optimizer {opt_name}")
        self.params = list(params)
        self.opt = _OPTIMIZERS[opt_name](self.params)
        self.schedule = make_lr_schedule(init_rate, max_steps)
        self.clip_norm = clip_norm
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.clip_norm and grads:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            for g in grads:
                g.mul_(scale)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1


def make_optimizer(opt_name: str, init_rate: float, max_steps: int, params,
                   clip_norm: Optional[float] = None) -> Optimizer:
    return Optimizer(opt_name, init_rate, max_steps, params, clip_norm)


@torch.no_grad()
def ema_update(ema: Basecaller, model: Basecaller, n_updates: float) -> None:
    """ema = decay * ema + (1 - decay) * params, decay = min(0.9999,
    (1 + n) / (10 + n)) in float32 (the num_updates ramp: without it a short
    or warm-started run's EMA is dominated by its first steps)."""
    n = np.float32(n_updates)
    decay = float(np.minimum(np.float32(MOVING_AVERAGE_DECAY),
                             (np.float32(1.0) + n) / (np.float32(10.0) + n)))
    for key, p in model.flat.items():
        ema.flat[key].mul_(decay).add_(p, alpha=1.0 - decay)


def _moments(data_parallel: bool):
    return global_moments() if data_parallel else contextlib.nullcontext()


def refuse_crf(config: Dict[str, Any]) -> None:
    """Raise for a CRF model: the port trains CTC models only (a CRF model
    needs Bonito's CTC-CRF loss, which the port does not have)."""
    if C.is_crf(config):
        raise ValueError("train: this model.json names a CRF decoder (Bonito's CTC-CRF "
                         "head); the port trains CTC models only, and has no CTC-CRF loss. "
                         "A CRF model can be basecalled with `call`.")


def make_train_step(config: Dict[str, Any], fl_gamma: float, data_parallel: bool = False):
    """step(model, ema, opt, batch, n_updates) -> loss: value and grad of
    the focal CTC loss, one optimizer update, one EMA update.

    ``data_parallel``: each rank of the initialised process group feeds its
    rows of the global batch; the step is the global batch's, as the JAX
    package's GSPMD step over a mesh: batch-norm moments over the ranks
    (``parallel.dist.global_moments``), gradients averaged over the ranks
    before the update, and the returned loss the ranks' mean.

    The step runs in full float32: TF32 is turned off for matmuls and cuDNN
    here (``utils/device.py:float32_strict``).

    Under a profiler each step records a ``train.step`` span tagged with
    ``n_updates`` (``utils/timing.py``), holding ``train.forward``,
    ``train.loss`` (the loss's forward), ``train.backward``, ``train.update``
    (twice: ``zero_grad``, then the gradients' all-reduce and the optimizer
    step) and ``train.ema``; the loss's own backward records
    ``train.loss_backward`` in the thread autograd runs it in."""
    refuse_crf(config)
    float32_strict()

    def step(model: Basecaller, ema: Basecaller, opt: Optimizer, batch, n_updates):
        with span("train.step", step=int(n_updates)):
            with _moments(data_parallel):
                with span("train.forward"):
                    logits = model(batch["signal"], batch["seq_len"], training=True)
                with span("train.loss"):
                    loss = ctc_focal_loss(logits, batch["seq_len"], batch["label"],
                                          batch["label_len"], fl_gamma=fl_gamma)
                with span("train.update"):
                    opt.zero_grad()
                with span("train.backward"):
                    loss.backward()
            with span("train.update"):
                if data_parallel:
                    average_gradients(opt.params)
                    loss = all_mean(loss)
                opt.step()
            with span("train.ema"):
                ema_update(ema, model, n_updates)
            return loss.detach()

    return step


def make_eval_step(model: Basecaller, data_parallel: bool = False):
    """batch -> greedy decode (decoded, lengths, neg_sum) of inference logits
    (``data_parallel``: batch-norm moments over the ranks' global batch, as
    the JAX package's eval step over a mesh)."""

    def step(batch):
        with torch.no_grad(), _moments(data_parallel):
            logits = model(batch["signal"], batch["seq_len"])
            return greedy_decode(logits, batch["seq_len"])

    return step


def edit_distance(a, b) -> int:
    """Levenshtein distance between two int sequences."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (np.asarray(b) != ca)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])


def batched_edit_distance(hyps, hyp_lens, refs, ref_lens) -> np.ndarray:
    """Levenshtein distance for a batch of padded int sequences: one DP
    wavefront over the whole batch, the in-row insertion recurrence resolved
    as a min-plus prefix scan."""
    hyps = np.asarray(hyps)
    refs = np.asarray(refs)
    hyp_lens = np.asarray(hyp_lens, np.int64)
    ref_lens = np.asarray(ref_lens, np.int64)
    b = len(hyp_lens)
    max_h = int(hyp_lens.max(initial=0))
    max_r = int(ref_lens.max(initial=0))
    cols = np.arange(max_r + 1)
    prev = np.broadcast_to(cols, (b, max_r + 1)).copy()
    out = np.where(hyp_lens == 0, ref_lens, 0)
    ref_mat = refs[:, :max_r] if refs.size else refs.reshape(b, 0)
    for i in range(1, max_h + 1):
        ca = hyps[:, i - 1:i]
        sub = prev[:, :-1] + (ref_mat != ca)
        cand = np.minimum(prev[:, 1:] + 1, sub)
        e = np.concatenate([np.full((b, 1), i, np.int64), cand], axis=1) - cols
        cur = np.minimum.accumulate(e, axis=1) + cols
        done = hyp_lens == i
        if done.any():
            out[done] = cur[done, ref_lens[done]]
        prev = cur
    return out


def mean_edit_distance(decoded, dec_lens, labels, label_lens) -> float:
    """Mean normalized edit distance (chiron/chiron_model.py:124-130)."""
    if len(decoded) == 0:
        return 0.0
    label_lens = np.asarray(label_lens, np.int64)
    d = batched_edit_distance(np.asarray(decoded), np.asarray(dec_lens, np.int64),
                              np.asarray(labels), label_lens)
    return float(np.mean(d / np.maximum(label_lens, 1)))


class Dataset:
    """Shuffled epoch batcher over dense training arrays."""

    def __init__(self, events, event_lens, labels, label_lens, seed=0):
        self.events = events
        self.event_lens = event_lens
        self.labels = labels
        self.label_lens = label_lens
        self.n = len(events)
        self.rng = np.random.RandomState(seed)
        self._perm = self.rng.permutation(self.n)
        self._pos = 0
        self.epochs_completed = 0

    def next_batch(self, batch_size: int, shuffle: bool = True):
        idx = []
        while len(idx) < batch_size:
            take = min(batch_size - len(idx), self.n - self._pos)
            idx.extend(self._perm[self._pos:self._pos + take])
            self._pos += take
            if self._pos >= self.n:
                self.epochs_completed += 1
                self._pos = 0
                if shuffle:
                    self._perm = self.rng.permutation(self.n)
        idx = np.asarray(idx)
        return {"signal": self.events[idx], "seq_len": self.event_lens[idx],
                "label": self.labels[idx], "label_len": self.label_lens[idx]}


def load_dataset(data_dir, seq_len, k_mer=1, max_segments=None, skip_start=10,
                 sig_norm=None, tfrecord=None, cache_dir=None, file_shard=None):
    """Training segments from .signal/.label pairs, a .bin folder, a TFRecord
    file or the out-of-core window cache, in the JAX package's order.

    ``cache_dir`` selects the window cache (``io/cache.py``: windows stream
    to disk and batches are served by positioned reads). A ``.tfrecord(s)``
    file given as ``data_dir``, or ``tfrecord`` (joined to ``data_dir``
    unless absolute), selects the reference's TFRecord layout
    (chiron_input.py:318). A folder with a ``data.meta`` descriptor is the
    fixed-record .bin layout (file_batch output, chiron_queue_input's
    source). Anything else is walked for .signal/.label pairs.

    ``file_shard=(index, count)`` keeps one process's share of a
    multi-process run: the files of its hash shard, or, for the .bin and
    TFRecord sources, whose read is the whole corpus, every count-th row
    (the TFRecord's after ``max_segments``, the .bin's before it).
    """
    if cache_dir:
        return cached_dataset(data_dir, cache_dir, seq_len, k_mer=k_mer, skip_start=skip_start,
                              sig_norm=sig_norm, max_segments=max_segments,
                              file_shard=file_shard)
    if not tfrecord and os.path.isfile(data_dir) and data_dir.endswith(
            (".tfrecord", ".tfrecords")):
        # a tfrecord FILE given directly (the reference's --validation takes
        # a validation tfrecord, entry.py:115)
        tfrecord = os.path.abspath(data_dir)
    if tfrecord:
        path = tfrecord if os.path.isabs(tfrecord) else os.path.join(data_dir, tfrecord)
        arrays = read_tfrecord_data_sets(path, seq_length=seq_len, k_mer=k_mer,
                                         max_segments_num=max_segments, skip_start=skip_start,
                                         sig_norm=sig_norm)
        if file_shard is not None:
            idx, count = file_shard
            arrays = tuple(a[idx::count] for a in arrays)
        return Dataset(*arrays)
    if os.path.exists(os.path.join(data_dir, "data.meta")):
        arrays = read_bin_folder(data_dir)
        if arrays[0].shape[1] != seq_len:
            raise ValueError(f".bin records have signal_length {arrays[0].shape[1]}; "
                             f"--sequence_len {seq_len} must match")
        if file_shard is not None:
            idx, count = file_shard
            arrays = tuple(a[idx::count] for a in arrays)
        if max_segments:
            arrays = tuple(a[:max_segments] for a in arrays)
        return Dataset(*arrays)
    return Dataset(*read_raw_data_sets(data_dir, seq_length=seq_len, k_mer=k_mer,
                                       max_segments_num=max_segments, skip_start=skip_start,
                                       sig_norm=sig_norm, file_shard=file_shard))


def batch_to_device(batch, ratio: float, device: torch.device):
    """A Dataset batch as tensors on ``device``; seq_len becomes logit frames
    (round(len / ratio), chiron/chiron_eval.py:337)."""
    with span("train.upload"):
        seq_len = np.round(batch["seq_len"] / ratio).astype(np.int32)
        return {"signal": torch.from_numpy(
                    np.ascontiguousarray(batch["signal"], np.float32)).to(device),
                "seq_len": torch.from_numpy(seq_len).to(device),
                "label": torch.from_numpy(
                    np.ascontiguousarray(batch["label"], np.int32)).to(device),
                "label_len": torch.from_numpy(
                    np.ascontiguousarray(batch["label_len"], np.int32)).to(device)}


def train(hparams) -> Dict[str, Any]:
    """Main training loop (parity: chiron/chiron_rcnn_train.py:66-136).

    Data parallel as the JAX package's trainer over a mesh, one rank per GPU:

    - No process group initialised: ``--n_devices k`` > 1 starts k ranks on
      this host, rank r on ``cuda:r`` (NCCL; gloo with ``--device cpu``),
      after building the kernels once; fewer than k visible GPUs raise. Each
      rank loads the whole corpus, draws the same global batches in the same
      order and feeds its rows [r B/k, (r+1) B/k): the JAX package's
      one-process mesh. ``--n_devices`` 0 or 1: one process on ``--device``
      (the JAX package's 0 takes every device).
    - Inside an initialised group of W ranks (``parallel.mesh.
      initialize_distributed``, e.g. under ``torchrun``): each rank loads its
      file shard and draws B/W rows, the JAX package's multi-process rule,
      its caches under ``<cache>/shard<rank>``.

    Either way the batch size is rounded up to a multiple of the ranks, each
    step is the global batch's (``make_train_step(data_parallel=True)``), and
    only rank 0 writes model.json, train_config, checkpoints and metrics.
    """
    device = resolve_device(getattr(hparams, "device", "cuda"))
    n_devices = int(getattr(hparams, "n_devices", 0) or 0)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices > 1 and n_devices != world:
            raise ValueError(f"--n_devices {n_devices} inside a process group of {world} "
                             "ranks: one rank drives one device")
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return _train(hparams, device, one_host=False, data_parallel=True)
    if n_devices <= 1:
        return _train(hparams, device, one_host=False, data_parallel=False)
    devices = make_mesh(n_devices, device=device)
    if device.type == "cuda":
        cuda_build.build_all()  # once here, not in k parallel nvcc runs
    threads = max(1, torch.get_num_threads() // len(devices))
    return run_ranks(_train_rank, devices, args=(hparams,), threads=threads, timeout=None)[0]


def _train_rank(rank: int, world: int, device: torch.device, hparams):
    """One rank of a one-host data-parallel run; rank 0 returns the result."""
    result = _train(hparams, device, one_host=True, data_parallel=True)
    return result if rank == 0 else None


def _train(hparams, device: torch.device, one_host: bool, data_parallel: bool):
    """One process's run; with ``hparams.profile`` rank 0 runs it under a
    profiler and writes <log_dir>/<model_name>/profile/trace.json and its
    spans, spans.json (``utils/timing.py:profiled``)."""
    profile_dir = None
    if getattr(hparams, "profile", False) and process_info()[0] == 0:
        profile_dir = os.path.join(hparams.log_dir, hparams.model_name, "profile")
    with profiled(profile_dir):
        return _train_run(hparams, device, one_host, data_parallel)


def _train_run(hparams, device: torch.device, one_host: bool, data_parallel: bool):
    rank, world = process_info()
    writer = rank == 0
    model_dir = os.path.join(hparams.log_dir, hparams.model_name)
    os.makedirs(model_dir, exist_ok=True)
    config_path = os.path.join(model_dir, "model.json")
    if getattr(hparams, "retrain", False) and os.path.exists(config_path):
        config = C.read_config(config_path)
    else:
        config = C.read_config(getattr(hparams, "configure", None))
    refuse_crf(config)
    if data_parallel:
        dist.barrier()  # every rank has read model.json before rank 0 writes it
    if writer:
        C.save_config(config_path, config)
        # the run flags beside the model (chiron_rcnn_train.py:77-81)
        with open(os.path.join(model_dir, "train_config"), "w") as f:
            json.dump({k: str(v) for k, v in vars(hparams).items()}, f, indent=2)

    batch_size = hparams.batch_size
    if batch_size % world:
        batch_size += world - batch_size % world
        print(f"Rounded batch size up to {batch_size} for {world} ranks")
    # one host: every rank draws the global batch and keeps its rows; a
    # multi-process group: each rank draws its own rows from its file shard
    local_batch = batch_size if one_host else batch_size // world
    file_shard = (rank, world) if world > 1 and not one_host else None

    def rows(batch):
        return shard_batch(batch, rank, world) if one_host else batch

    def shard_cache(cache_dir):
        # each process's cache holds only its file shard, in a directory of its own
        if cache_dir and file_shard is not None:
            return os.path.join(cache_dir, f"shard{rank}")
        return cache_dir

    def rank0_first(cache_dir, load):
        # one host: the ranks share a cache directory, which rank 0 builds first
        shared = one_host and bool(cache_dir)
        if shared and rank > 0:
            dist.barrier()
        out = load()
        if shared and rank == 0:
            dist.barrier()
        return out

    seq_len = hparams.sequence_len
    ratio = model_ratio(config, seq_len)
    sig_norm = getattr(hparams, "sig_norm", None)
    k_mer = int(getattr(hparams, "k_mer", 1))
    max_segments = getattr(hparams, "segments_num", None)
    tfrecord = getattr(hparams, "tfrecord", None)
    train_cache = shard_cache(getattr(hparams, "train_cache", None))
    dataset = rank0_first(train_cache, lambda: load_dataset(
        hparams.data_dir, seq_len, k_mer=k_mer, max_segments=max_segments, sig_norm=sig_norm,
        tfrecord=tfrecord, cache_dir=train_cache, file_shard=file_shard))
    if dataset.n == 0:
        raise ValueError(f"No training segments found under {hparams.data_dir}")
    print(f"Loaded {dataset.n} training segments")
    valid = None
    if getattr(hparams, "validation", None):
        valid_cache = shard_cache(getattr(hparams, "valid_cache", None))
        valid = rank0_first(valid_cache, lambda: load_dataset(
            hparams.validation, seq_len, sig_norm=sig_norm, cache_dir=valid_cache,
            file_shard=file_shard))

    tree, start_step = (None, None)
    if getattr(hparams, "retrain", False):
        tree, start_step = restore_latest(model_dir)
    if tree is None:
        tree = init_model(torch.Generator().manual_seed(0), config)
        start_step = 0
    start_step = start_step or 0
    model = replicate(from_jax_params(tree, config, device)).requires_grad_(True)
    ema = from_jax_params(to_numpy_tree(model), config, device)

    opt = make_optimizer(config.get("opt_method", "Adam"), hparams.step_rate, hparams.max_steps,
                         model.parameters())
    step_fn = make_train_step(config, float(config.get("fl_gamma", 0)), data_parallel)
    eval_fn = make_eval_step(model, data_parallel)

    # Host-RSS guard: when the process's peak RSS crosses the limit the loop
    # checkpoints (params and EMA) and returns restart=True, so a wrapper can
    # relaunch with --retrain instead of the run dying mid-schedule. Under a
    # group the ranks stop together.
    max_rss_gb = float(getattr(hparams, "max_rss_gb", 0) or 64.0)

    def over_rss() -> bool:
        import resource

        over = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6 > max_rss_gb
        if data_parallel:
            flag = torch.tensor([float(over)], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            over = bool(flag.item())
        return over

    metrics_path = os.path.join(model_dir, "metrics.jsonl")
    lr_schedule = make_lr_schedule(hparams.step_rate, hparams.max_steps)
    save_every = int(getattr(hparams, "save_every", 10))
    # rolling EMA side snapshots (pointer untouched), so a run stopped
    # mid-schedule still leaves an installable ema-<step>.npz
    ema_save_every = int(getattr(hparams, "ema_save_every", 2000) or 0)
    resample_every = int(getattr(hparams, "resample_after_epoch", 0) or 0)
    offset_inc = int(getattr(hparams, "offset_increment", 3))
    skip_start = 10
    losses = []
    t0 = time.time()
    last_loss = None
    for i in range(start_step, hparams.max_steps):
        if (resample_every > 0 and dataset.epochs_completed > 0
                and dataset.epochs_completed % resample_every == 0 and dataset._pos == 0):
            skip_start += offset_inc
            if hasattr(dataset, "close"):
                dataset.close()
            dataset = rank0_first(train_cache, lambda: load_dataset(
                hparams.data_dir, seq_len, k_mer=k_mer, max_segments=max_segments,
                skip_start=skip_start, sig_norm=sig_norm, tfrecord=tfrecord,
                cache_dir=train_cache, file_shard=file_shard))
        batch = batch_to_device(rows(dataset.next_batch(local_batch)), ratio, device)
        loss = step_fn(model, ema, opt, batch, i - start_step)  # EMA updates since (re)init
        if (i + 1) % save_every == 0 or (i + 1) == hparams.max_steps:
            last_loss = float(loss)
            losses.append(last_loss)
            err = None
            if valid is not None:
                vbatch = rows(valid.next_batch(local_batch))
                dec, dlens, _ = eval_fn(batch_to_device(vbatch, ratio, device))
                err = mean_edit_distance(local_rows(dec), local_rows(dlens), vbatch["label"],
                                         vbatch["label_len"])
                if one_host:  # the global batch's mean, as the JAX package's one-process mesh
                    err = float(all_mean(torch.tensor(err, dtype=torch.float64, device=device)))
            if writer:
                save_checkpoint(model_dir, to_numpy_tree(model), i + 1)
            dt = time.time() - t0
            msg = f"step {i + 1} loss {last_loss:.4f} {dt / save_every:.3f}s/step"
            if err is not None:
                msg += f" valid_edit_dist {err:.4f}"
            print(msg)
            if writer:
                with open(metrics_path, "a") as mf:
                    mf.write(json.dumps({
                        "step": i + 1,
                        "loss": last_loss,
                        "learning_rate": float(lr_schedule(i + 1)),
                        "valid_edit_distance": err,
                        "seconds_per_step": dt / save_every,
                    }) + "\n")
            t0 = time.time()
            if writer and ema_save_every and (i + 1) % ema_save_every == 0 \
                    and (i + 1) != hparams.max_steps:
                save_checkpoint(model_dir, to_numpy_tree(ema), i + 1, prefix="ema",
                                update_state=False, max_to_keep=2)
            if max_rss_gb and over_rss():
                # update_state=False: a restart resumes from the raw
                # model-<step> params saved above, not from this EMA snapshot
                if writer:
                    save_checkpoint(model_dir, to_numpy_tree(ema), i + 1, prefix="rss-ema",
                                    update_state=False)
                print(f"RSS over the {max_rss_gb} GB limit at step {i + 1}; "
                      f"exiting for --retrain restart")
                return {"final_loss": last_loss, "losses": losses, "model_dir": model_dir,
                        "restart": True, "step": i + 1}
    # the EMA first, as a side snapshot: the pointer must name the raw final
    # params even if the process dies between the two saves
    if writer:
        save_checkpoint(model_dir, to_numpy_tree(ema), hparams.max_steps, prefix="ema",
                        update_state=False)
        save_checkpoint(model_dir, to_numpy_tree(model), hparams.max_steps, prefix="final")
    return {"final_loss": last_loss, "losses": losses, "model_dir": model_dir}
