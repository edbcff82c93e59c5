"""Regenerate the bundled DNA/RNA models end-to-end (the training recipe).

The reference ships pretrained TF checkpoints; this framework's bundled
models are trained from scratch on simulated nanopore signal because the
reference mount's checkpoint blobs are absent (.MISSING_LARGE_BLOBS).
This script IS the provenance of chiron_tpu/model/{DNA,RNA}_default:

  1. DNA pore model: EM-estimated from the reference's committed example
     reads + its golden fastq (tools/pore_estimate.py) — the only
     real-signal information that flows into the bundled DNA model.
     RNA uses the synthetic structured 6-mer model (no real RNA data).
  2. Training corpora: tools/simulate.py with domain randomization over
     dwell/noise/drift (held-out seeds 991/992 and the validation seeds
     are reserved by accuracy.py — never reuse them here).
  3. Training: the standard trainer through the out-of-core window cache.
  4. Install: checkpoints + model.json + pore_model.tsv into
     chiron_tpu/model/.

The port of ``chiron_tpu/tools/make_bundled_models.py``: the same stages,
seeds, variants and hyperparameters, training through the port's trainer on
the card (``--device``, default cuda; a missing GPU raises, ``--device cpu``
trains on the CPU). It reads nothing outside the checkout: the reference's
example reads come only from ``--reference DIR`` (its ``example_data/DNA``),
which ``--stage realdata`` needs, and ``--stage data`` needs unless
``<work>/dna_pore_model.tsv`` exists (an existing table skips the EM
estimate). Bundled model configs and warm starts are read from
``cli.MODEL_ROOT``, where ``stage_install`` also writes (``model_root``);
the work directory defaults to ``chiron_tpu_torch/_build/bundled_models``.

Run stages separately, one process on the card at a time:
    python -m chiron_tpu_torch.tools.make_bundled_models --stage data --reference DIR
    python -m chiron_tpu_torch.tools.make_bundled_models --stage train --mode dna
    python -m chiron_tpu_torch.tools.make_bundled_models --stage train --mode rna
    python -m chiron_tpu_torch.tools.make_bundled_models --stage install
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import types

from chiron_tpu_torch.cli import MODEL_ROOT

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_WORK = os.path.join(REPO, "chiron_tpu_torch", "_build", "bundled_models")

# corpus seeds — disjoint from accuracy.py's holdouts (991/992)
DNA_SEEDS = (100, 101, 102, 103, 104, 105, 106, 107)
DNA_VALID_SEED = 555
RNA_SEEDS = (200, 201, 202)
RNA_VALID_SEED = 556

DNA_VARIANTS = (
    dict(mean_dwell=8.0, noise=0.9),
    dict(mean_dwell=9.0, noise=1.0),
    dict(mean_dwell=10.0, noise=1.15),
    dict(mean_dwell=9.0, noise=1.0, drift_walk=0.006, drift_sine_amp=0.2),
    # autocorrelated (flicker-like) level noise: real pore noise is
    # low-pass; white-only training over-calls insertions on real signal
    dict(mean_dwell=9.0, noise=1.0, noise_ar=0.7),
    # slow-translocation variants: the reference's real example reads run
    # at 22-26 samples/base (signal_len / golden_fastq_len, all 5 reads);
    # a model trained only at 8-10 samples/base reads every real dwell as
    # ~2.5 bases -> the measured 0.9/base insertion storm on real_dna.
    # Slow reads are ~2.6x longer, so these variants also dominate the
    # window mix, matching the real-signal target domain.
    dict(mean_dwell=20.0, max_dwell=120, noise=1.0, noise_ar=0.7, n_reads=300),
    dict(mean_dwell=24.0, max_dwell=140, noise=1.0, noise_ar=0.7, n_reads=300),
    dict(mean_dwell=28.0, max_dwell=160, noise=1.1, n_reads=300),
)
_RNA_BASE = dict(mean_dwell=43.0, max_dwell=300, drift_sine_period=200_000.0)
RNA_VARIANTS = (
    dict(),
    dict(mean_dwell=38.0),
    dict(mean_dwell=48.0, noise=1.15),
)


def stage_data(work: str, dna_reads: int = 450, rna_reads: int = 120,
               reference: str = None) -> None:
    from chiron_tpu_torch.tools.pore_estimate import estimate_kmer_model
    from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_corpus

    pore_path = os.path.join(work, "dna_pore_model.tsv")
    if not os.path.exists(pore_path):
        import numpy as np

        if reference is None:
            raise ValueError(f"{pore_path} is absent: the EM pore-model estimate needs the "
                             "reference's example reads (--reference DIR)")

        from chiron_tpu_torch.tools.assess import _read_fastx

        seqs = {}
        golden = os.path.join(reference, "output", "result")
        for fn in sorted(os.listdir(golden)):
            seqs.update(_read_fastx(os.path.join(golden, fn)))
        raw = os.path.join(reference, "output", "raw")
        pairs = [
            (np.loadtxt(os.path.join(raw, n + ".signal"), dtype=np.float32).ravel(),
             seqs[n])
            for n in sorted(seqs)
        ]
        model = estimate_kmer_model(pairs, k=5, iters=4, verbose=True)
        # EM stdvs include segmentation/alignment error on top of the true
        # level noise; uncorrected they put the simulator at SNR ~3 (median
        # stdv 0.34 from the 5 example reads) where training plateaus at
        # ~0.40 edit distance. Shrink toward the R9.4-typical 0.15-0.25
        # band (measured: the plateau breaks immediately).
        model.stdvs = np.maximum(model.stdvs * 0.6, 0.12).astype(np.float32)
        os.makedirs(work, exist_ok=True)
        model.save(pore_path)
        print(f"pore model -> {pore_path}")

    dna = KmerModel.load(pore_path)
    for i, (kw, seed) in enumerate(zip(DNA_VARIANTS, DNA_SEEDS)):
        kw = dict(kw)
        n = kw.pop("n_reads", dna_reads)
        simulate_corpus(os.path.join(work, "train_dna", f"v{i}"), n,
                        4000, seed=seed, model=dna, cfg=SimConfig(**kw))
    simulate_corpus(os.path.join(work, "valid_dna"), 40, 4000,
                    seed=DNA_VALID_SEED, model=dna, cfg=SimConfig())

    rna = KmerModel.synthetic()
    for i, (kw, seed) in enumerate(zip(RNA_VARIANTS, RNA_SEEDS)):
        cfg = SimConfig(**{**_RNA_BASE, **kw})
        simulate_corpus(os.path.join(work, "train_rna", f"v{i}"), rna_reads,
                        2500, seed=seed, model=rna, cfg=cfg)
    simulate_corpus(os.path.join(work, "valid_rna"), 10, 2500,
                    seed=RNA_VALID_SEED, model=rna, cfg=SimConfig(**_RNA_BASE))
    print(f"corpora -> {work}/train_dna train_rna valid_dna valid_rna")


# DNA_slow corpus: the slow-translocation regime (the reference's real
# example reads measure 22-26 samples/base). Long 2000-sample windows give
# the model ~83 bases of context; domain randomization over dwell 18-32
# with AR(1) level noise (real pore noise is low-pass).
SLOW_SEEDS = (400, 401, 402, 403, 404, 405)
SLOW_VALID_SEED = 558
SLOW_VARIANTS = (
    dict(mean_dwell=18.0, max_dwell=110, noise=1.0, noise_ar=0.7),
    dict(mean_dwell=21.0, max_dwell=130, noise=1.1, noise_ar=0.7),
    dict(mean_dwell=24.0, max_dwell=140, noise=1.0, noise_ar=0.7),
    dict(mean_dwell=24.0, max_dwell=140, noise=1.0),  # white-noise variant
    dict(mean_dwell=27.0, max_dwell=150, noise=1.0, noise_ar=0.7,
         drift_walk=0.006, drift_sine_amp=0.2),
    dict(mean_dwell=32.0, max_dwell=170, noise=1.15, noise_ar=0.7),
)


def stage_data_slow(work: str, reads_per_variant: int = 180) -> None:
    from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_corpus

    pore_path = os.path.join(work, "dna_pore_model.tsv")
    if not os.path.exists(pore_path):
        bundled = os.path.join(MODEL_ROOT, "DNA_default", "pore_model.tsv")
        shutil.copy2(bundled, pore_path)
    dna = KmerModel.load(pore_path)
    for i, (kw, seed) in enumerate(zip(SLOW_VARIANTS, SLOW_SEEDS)):
        simulate_corpus(os.path.join(work, "train_dna_slow", f"v{i}"),
                        reads_per_variant, 4000, seed=seed, model=dna,
                        cfg=SimConfig(**kw))
        print(f"slow variant {i} done: {kw}")
    simulate_corpus(
        os.path.join(work, "valid_dna_slow"), 24, 4000, seed=SLOW_VALID_SEED,
        model=dna, cfg=SimConfig(mean_dwell=24.0, max_dwell=140, noise_ar=0.7),
    )
    print(f"slow corpus -> {work}/train_dna_slow (+ valid_dna_slow)")


REAL_SEED_SLOW = 300
REAL_SEED_FAST = 301
REAL_VALID_SEED = 557


def _read_logits(params, cfg, signal, batch: int = 400, device: str = "cuda"):
    """Whole-read log-softmax logits from non-overlapping 400-sample
    windows (per-read sig_norm=1 normalization, pure-real batches — the
    batch-stat BN regime the labels will be trained under). ``params``: a
    parameter tree with numpy leaves; the forward runs on ``device``."""
    import numpy as np
    import torch

    from chiron_tpu_torch.io.signal import normalize_signal
    from chiron_tpu_torch.params import from_jax_params
    from chiron_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = from_jax_params(params, cfg, dev)
    x = normalize_signal(np.asarray(signal, np.float32), 1)
    n = len(x)
    t = 400
    pad = (-n) % t
    xw = np.pad(x, (0, pad)).reshape(-1, t)
    sl = np.full(len(xw), t, np.int32)
    outs = []
    for i in range(0, len(xw), batch):
        lg = model(torch.from_numpy(xw[i:i + batch]).to(dev),
                   torch.from_numpy(sl[i:i + batch]).to(dev))
        outs.append(lg.float().cpu().numpy())
    lp = np.concatenate(outs).reshape(-1, outs[0].shape[-1])[:n]
    m = lp.max(1, keepdims=True)
    return lp - (m + np.log(np.exp(lp - m).sum(1, keepdims=True)))


def stage_realdata(work: str, repeats: int = 8,
                   align_model: str = None,
                   rep_stride_labels: int = 3,
                   exclude_read: str = None, reference: str = None,
                   device: str = "cuda") -> None:
    """Bootstrap-label the reference's real DNA reads and build a mixed
    fine-tuning corpus (the round-3 real-signal adaptation stage).

    This is the reference's own label-generation pipeline
    (chiron/chiron_label.py:255-277 resquiggle -> chiron export) applied to
    its example reads, with the committed golden basecalls
    (example_data/DNA/output/result) standing in for an aligned reference
    sequence: raw signal is DTW-resquiggled against the golden sequence
    using the bundled EM pore model, and the per-base segmentation is
    written as .signal/.label training pairs. The real windows are
    oversampled ``repeats`` x and mixed with freshly-seeded synthetic
    corpora at the real (slow, AR-noise) and fast translocation regimes so
    fine-tuning adapts to real signal without forgetting the synthetic
    domain (tests/test_accuracy_smoke.py floors that axis).

    ``align_model``: checkpoint dir of a real-signal-adapted model; when
    given, the coarse DTW segmentation is refined by CTC forced alignment
    of the golden sequence through that model's own logits
    (ops/ctc_align.py) — the bootstrap round that lifts label quality past
    what the pore-model DTW alone can do.

    ``exclude_read``: leave-one-read-out protocol (VERDICT r4 #5a — the
    memorisation-proof version of the round-4 real-signal experiment):
    the named read contributes NO training windows; fine-tune on the
    remaining reads and evaluate real_dna skill ONLY on the held-out read
    (accuracy.py real_dna reports per-read identity, and assess_dir can be
    pointed at a single basecalled read).

    ``reference``: the reference Chiron's ``example_data/DNA`` directory
    (required). ``device``: where ``align_model``'s forward runs.
    """
    import numpy as np

    if reference is None:
        raise ValueError("stage realdata labels the reference's example reads: pass "
                         "--reference DIR (its example_data/DNA)")

    from chiron_tpu_torch.tools.assess import _read_fastx
    from chiron_tpu_torch.tools.resquiggle import PoreModel, resquiggle_signal
    from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_corpus

    align_params, align_cfg = None, None
    if align_model:
        from chiron_tpu_torch import config as C
        from chiron_tpu_torch.models import model_ratio
        from chiron_tpu_torch.train.checkpoint import restore_latest

        align_cfg = C.read_config(os.path.join(align_model, "model.json"))
        if model_ratio(align_cfg, 400) != 1:
            # _read_logits assumes one logit frame per signal sample and
            # chunked_forced_align anchors on sample-coordinate starts; a
            # strided align model would silently misplace every label
            raise ValueError(
                "--align_model must be a stride-1 model (one logit per "
                f"sample); {align_model} has ratio "
                f"{model_ratio(align_cfg, 400)}"
            )
        align_params, _ = restore_latest(align_model)
        if align_params is None:
            raise FileNotFoundError(f"no parameter checkpoint found in {align_model!r}")

    pore_path = os.path.join(MODEL_ROOT, "DNA_default", "pore_model.tsv")
    pm = PoreModel.load(pore_path)
    golden = os.path.join(reference, "output", "result")
    raw = os.path.join(reference, "output", "raw")
    seqs = {}
    for fn in sorted(os.listdir(golden)):
        seqs.update(_read_fastx(os.path.join(golden, fn)))
    real_dir = os.path.join(work, "train_realmix", "real")
    os.makedirs(real_dir, exist_ok=True)
    if exclude_read is not None and exclude_read not in seqs:
        raise ValueError(f"--exclude_read {exclude_read!r} not in "
                         f"{sorted(seqs)}")
    for name in sorted(seqs):
        if name == exclude_read:
            print(f"{name}: HELD OUT (leave-one-read-out)")
            continue
        sig = np.loadtxt(os.path.join(raw, name + ".signal"),
                         dtype=np.float32).ravel()
        seq = seqs[name]
        starts = resquiggle_signal(sig, seq, pore_model=pm, radius=50)
        if align_params is not None:
            from chiron_tpu_torch.io.labels import base2ind
            from chiron_tpu_torch.ops.ctc_align import chunked_forced_align

            lp = _read_logits(align_params, align_cfg, sig, device=device)
            ids = np.asarray([base2ind(b) for b in seq], np.int64)
            starts = chunked_forced_align(lp, ids, starts).astype(np.int32)
        sig_text = "\n".join(str(int(v)) for v in sig)
        row_list = [
            f"{int(starts[k])} {int(starts[k + 1])} {b}"
            for k, b in enumerate(seq)
        ]
        for r in range(repeats):
            # each rep drops r*rep_stride_labels leading labels so its
            # windows are cut at
            # DIFFERENT phases: identical copies let the trainer memorise
            # one fixed window set of the tiny real corpus instead of
            # learning translation-invariant structure (the same idea as
            # the reference's per-epoch offset re-windowing,
            # chiron_rcnn_train.py:100-103, paid once at data-gen time)
            prefix = os.path.join(real_dir, f"{name}_rep{r}")
            with open(prefix + ".signal", "w") as f:
                f.write(sig_text + "\n")
            with open(prefix + ".label", "w") as f:
                f.write("\n".join(row_list[r * rep_stride_labels:])
                        + "\n")
        print(f"{name}: {len(sig)} samples, {len(seq)} bases, "
              f"dwell {len(sig) / len(seq):.1f}, x{repeats}")

    dna = KmerModel.load(pore_path)
    slow = SimConfig(mean_dwell=24.0, max_dwell=140, noise_ar=0.7)
    simulate_corpus(os.path.join(work, "train_realmix", "slow"), 100, 4000,
                    seed=REAL_SEED_SLOW, model=dna, cfg=slow)
    simulate_corpus(os.path.join(work, "train_realmix", "fast"), 100, 4000,
                    seed=REAL_SEED_FAST, model=dna, cfg=SimConfig())
    simulate_corpus(os.path.join(work, "valid_realmix"), 12, 4000,
                    seed=REAL_VALID_SEED, model=dna, cfg=slow)
    print(f"realmix corpus -> {work}/train_realmix (+ valid_realmix)")


def _train(work: str, mode: str, max_steps: int, retrain: bool = False,
           step_rate: float = 4e-3, train_sub: str = None,
           valid_sub: str = None, configure: str = None,
           model_name: str = None, device: str = "cuda"):
    """Train ``mode``'s model on its corpora under ``work`` on ``device``.
    Returns the trainer's result, or None once a restarted process ran the
    schedule to its end."""
    from chiron_tpu_torch.train.loop import train

    if mode == "dna":
        tsub = train_sub or "train_dna"
        vsub = valid_sub or "valid_dna"
        h = types.SimpleNamespace(
            data_dir=os.path.join(work, tsub),
            log_dir=os.path.join(work, "models"), model_name="DNA_retrain",
            validation=os.path.join(work, vsub),
            train_cache=os.path.join(work, f"cache_{tsub}"),
            valid_cache=os.path.join(work, f"cache_{vsub}"),
            sequence_len=400, batch_size=400, step_rate=step_rate,
            max_steps=max_steps, sig_norm=1, retrain=retrain,
        )
    elif mode == "dna_slow":
        tsub = train_sub or "train_dna_slow"
        vsub = valid_sub or "valid_dna_slow"
        h = types.SimpleNamespace(
            data_dir=os.path.join(work, tsub),
            log_dir=os.path.join(work, "models"),
            model_name="DNA_SLOW_retrain",
            validation=os.path.join(work, vsub),
            train_cache=os.path.join(work, f"cache_{tsub}"),
            valid_cache=os.path.join(work, f"cache_{vsub}"),
            sequence_len=2000, batch_size=320, step_rate=step_rate,
            max_steps=max_steps, sig_norm=1, retrain=retrain,
            configure=os.path.join(MODEL_ROOT, "DNA_slow", "model.json"),
        )
    else:
        h = types.SimpleNamespace(
            data_dir=os.path.join(work, "train_rna"),
            log_dir=os.path.join(work, "models"), model_name="RNA_retrain",
            validation=os.path.join(work, "valid_rna"),
            train_cache=os.path.join(work, "cache_rna"),
            valid_cache=os.path.join(work, "cache_valid_rna"),
            sequence_len=2000, batch_size=100, step_rate=step_rate,
            max_steps=max_steps, sig_norm=1, retrain=retrain,
            configure=os.path.join(MODEL_ROOT, "RNA_default", "model.json"),
        )
    if configure:
        h.configure = configure
    if model_name:
        h.model_name = model_name
    h.device = device
    result = train(h)
    # When the loop bails at its host-RSS limit (train/loop.py max_rss_gb)
    # after a checkpoint, continue the schedule in FRESH processes until done.
    if result.get("restart"):
        import subprocess

        cmd = [sys.executable, "-m", "chiron_tpu_torch.tools.make_bundled_models",
               "--stage", "train", "--mode", mode, "--work", work,
               "--max_steps", str(max_steps), "--step_rate", str(step_rate),
               "--retrain", "--device", device]
        if train_sub:
            cmd += ["--train_sub", train_sub]
        if valid_sub:
            cmd += ["--valid_sub", valid_sub]
        if configure:
            cmd += ["--configure", configure]
        if model_name:
            cmd += ["--model_name", model_name]
        print(f"restarting at step {result['step']}: {' '.join(cmd[2:])}")
        code = subprocess.call(cmd)
        if code != 0:
            raise RuntimeError(f"restarted trainer exited {code}")
        return None  # the child (chain) ran to completion
    return result


def stage_finetune(work: str, mode: str, max_steps: int,
                   step_rate: float = 2e-3, train_sub: str = None,
                   valid_sub: str = None, warm_start: str = None,
                   device: str = "cuda"):
    """Warm-start from the bundled model and continue on the current corpora.

    Seeds work/models/{MODE}_retrain with the bundled EMA weights as
    model-0.npz (start_step 0, so the EMA num_updates ramp and the LR
    piecewise schedule both restart), then trains with --retrain semantics.
    ``warm_start`` overrides the source checkpoint dir (e.g. a previous
    fine-tune's output for bootstrap rounds).
    """
    name = {"dna": "DNA_default", "rna": "RNA_default",
            "dna_slow": "DNA_slow"}[mode]
    src = warm_start or os.path.join(MODEL_ROOT, name)
    dst = os.path.join(work, "models", f"{mode.upper()}_retrain")
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(src, "checkpoint")) as f:
        ckpt = f.read().strip()
    shutil.copy2(os.path.join(src, ckpt), os.path.join(dst, "model-0.npz"))
    shutil.copy2(os.path.join(src, "model.json"), os.path.join(dst, "model.json"))
    with open(os.path.join(dst, "checkpoint"), "w") as f:
        f.write("model-0.npz\n")
    print(f"warm start {dst} <- {src}/{ckpt}")
    return _train(work, mode, max_steps, retrain=True, step_rate=step_rate,
                  train_sub=train_sub, valid_sub=valid_sub, device=device)


def stage_install(work: str, model_root: str = MODEL_ROOT) -> None:
    """Copy trained checkpoints into the bundled model folders under
    ``model_root`` (where the port reads them from)."""
    for mode, name in (("dna", "DNA_default"), ("rna", "RNA_default"),
                       ("dna_slow", "DNA_slow")):
        src = os.path.join(work, "models", f"{mode.upper()}_retrain")
        dst = os.path.join(model_root, name)
        if not os.path.isdir(src):
            print(f"skip {name}: {src} absent")
            continue
        ckpts = sorted(
            f for f in os.listdir(src)
            if f.startswith(("ema-", "final-")) and f.endswith(".npz")
        )
        if not ckpts:
            print(f"skip {name}: no final checkpoints in {src}")
            continue
        for old in os.listdir(dst):
            if old.endswith(".npz"):
                os.remove(os.path.join(dst, old))
        for f in ckpts:
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
        # the architecture may have changed between rounds (e.g. a
        # net2wide capacity jump): the config must travel with the weights
        shutil.copy2(os.path.join(src, "model.json"),
                     os.path.join(dst, "model.json"))
        step = ckpts[-1].split("-")[-1].split(".")[0]
        # the checkpoint-state file is a plain filename (train/checkpoint.py)
        with open(os.path.join(dst, "checkpoint"), "w") as fh:
            fh.write(f"ema-{step}.npz\n")
        if mode in ("dna", "dna_slow"):
            shutil.copy2(os.path.join(work, "dna_pore_model.tsv"),
                         os.path.join(dst, "pore_model.tsv"))
        print(f"installed {name} <- {src} ({', '.join(ckpts)})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", required=True,
                   choices=["data", "data_slow", "realdata", "train", "finetune", "install"])
    p.add_argument("--mode", default="dna", choices=["dna", "rna", "dna_slow"])
    p.add_argument("--work", default=DEFAULT_WORK)
    p.add_argument("--max_steps", type=int, default=16000)
    p.add_argument("--step_rate", type=float, default=None)
    p.add_argument("--train_sub", default=None,
                   help="train corpus subdir under --work (e.g. train_realmix)")
    p.add_argument("--valid_sub", default=None,
                   help="validation corpus subdir under --work")
    p.add_argument("--configure", default=None,
                   help="train: model config json overriding the mode default")
    p.add_argument("--model_name", default=None,
                   help="train: output dir name under <work>/models")
    p.add_argument("--retrain", action="store_true",
                   help="train: resume from the latest rolling checkpoint "
                        "(e.g. after an interrupted run)")
    p.add_argument("--rep_stride_labels", type=int, default=3,
                   help="realdata: leading labels dropped per oversampling "
                        "rep (phase-shifted window cuts); use ~10 for "
                        "seg-2000 training so the shifts span the window")
    p.add_argument("--align_model", default=None,
                   help="realdata: refine DTW labels by CTC forced "
                        "alignment through this checkpoint dir's model")
    p.add_argument("--exclude_read", default=None,
                   help="realdata: hold this read entirely out of the "
                        "training corpus (leave-one-read-out evaluation)")
    p.add_argument("--warm_start", default=None,
                   help="finetune: source checkpoint dir (default: the "
                        "bundled model)")
    p.add_argument("--reference", default=None,
                   help="data / realdata: the reference Chiron's example_data/DNA "
                        "directory (its example reads and golden fastq)")
    p.add_argument("--device", default="cuda",
                   help="train / finetune / realdata: cuda (default) or cpu; cuda "
                        "without a GPU is an error")
    args = p.parse_args(argv)
    if args.stage == "data":
        stage_data(args.work, reference=args.reference)
    elif args.stage == "data_slow":
        stage_data_slow(args.work)
    elif args.stage == "realdata":
        stage_realdata(args.work, align_model=args.align_model,
                       rep_stride_labels=args.rep_stride_labels,
                       exclude_read=args.exclude_read, reference=args.reference,
                       device=args.device)
    elif args.stage == "train":
        _train(args.work, args.mode, args.max_steps,
               retrain=args.retrain,
               step_rate=args.step_rate or 4e-3,
               train_sub=args.train_sub, valid_sub=args.valid_sub,
               configure=args.configure, model_name=args.model_name,
               device=args.device)
    elif args.stage == "finetune":
        stage_finetune(args.work, args.mode, args.max_steps,
                       step_rate=args.step_rate or 2e-3,
                       train_sub=args.train_sub, valid_sub=args.valid_sub,
                       warm_start=args.warm_start, device=args.device)
    else:
        stage_install(args.work)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
