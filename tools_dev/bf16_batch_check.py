"""Does a bf16 decode depend on the batch size in the JAX package too?

Runs DNA_default's bf16 inference step (``config["bf16"] = True``, beam 30,
the model's length bonus) once at B = 2,000 and once as five B = 400 steps on
the same windows, and counts the windows that decode identically. Two
framings of "the same windows", both from the first windows of the bench's
default corpus (``chiron_tpu_torch.bench.simulated_input``, byte-identical to
the JAX simulator's):

- ``permuted``: the first 400-window batch and four seeded permutations of
  it (seeds 1-4), concatenated: every step normalises by the moments of the
  same 400 windows, so a flip is a rounding residue of the batch size alone.
  This is the framing of ``chip_smoke.py`` phase 6, which gave 1,775 / 2,000
  on the card and 1,730 on the port's plain CPU path.
- ``distinct``: the first 2,000 windows, and the five 400-window batches that
  partition them; the BN populations differ as well.

For each framing it runs, in both modes, and prints one JSON line a run:

- ``jax``: the JAX package's own step on the CPU (``make_decode_step``: the
  unfused conv, the LSTM scan, float32 two-pass BN moments);
- ``jax_fused_cnn``: the same step with JAX's inference CNN as it runs on a
  TPU: ``fused_cnn`` on and ``conv_bn_pallas`` in interpret mode (one-pass
  moments, float32 sums accumulated block by block), the LSTM scan and the
  beam search as on the CPU;
- ``jax_fused``: JAX's TPU inference step but the beam search: the fused CNN
  as above and ``bilstm_layer_pallas`` in interpret mode (bf16 xw and h in
  bf16 mode), the path the port follows;
- ``torch``: the port's step (``chiron_tpu_torch`` on the CPU: the fused
  conv's plain version, one-pass moments from float64 column sums).

Usage (CPU only, ~10-60 min and a few GiB):

    JAX_PLATFORMS=cpu python tools_dev/bf16_batch_check.py \
        [--framing permuted distinct] [--package jax jax_fused_cnn jax_fused torch]
"""

import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODEL = os.path.join(REPO, "chiron_tpu", "model", "DNA_default")
BATCH, BIG, BEAM, SEG, JUMP = 400, 2000, 30, 400, 390
# package -> the JAX path it runs (None: the JAX package's own CPU step)
PACKAGES = {"jax": None, "jax_fused_cnn": "cnn", "jax_fused": "lstm", "torch": None}


def windows(n):
    """The first n windows (float32 [n, 400], lengths in samples) of the
    bench's default corpus, as the port's call pipeline cuts them."""
    from chiron_tpu_torch.bench import simulated_input
    from chiron_tpu_torch.eval import pipeline

    fl = type("F", (), dict(batch_size=n, segment_len=SEG, jump=JUMP, start=0, sig_norm=1,
                            reverse_fast5=False))()
    with tempfile.TemporaryDirectory() as work:
        data, _, _ = simulated_input(work)
        file_dir, files = pipeline.list_input_files(data)
        x, sl, _, _, _ = next(iter(pipeline._batch_stream(file_dir, files, fl, 1.0)))
    if len(x) != n or (sl < 0).any():
        raise SystemExit(f"the corpus has fewer than {n} windows")
    return x, sl


@contextlib.contextmanager
def jax_tpu_path(lstm):
    """JAX's TPU inference path on the CPU, each Pallas kernel in interpret
    mode: every conv that ``_fused_conv_ok`` admits goes through
    ``conv_bn_pallas``, and with ``lstm`` the BiLSTM through
    ``bilstm_layer_pallas`` (its bf16 xw and h); without it the recurrence
    stays the scan. The beam search stays the CPU's: ``make_decode_step``
    chooses it before this runs. The model functions import these names at
    trace time, so patching the modules reaches them."""
    from chiron_tpu.models import layers as JL
    from chiron_tpu.models import rnn as JR
    from chiron_tpu.ops.pallas import convbn as jconvbn
    from chiron_tpu.ops.pallas import lstm as jlstm

    kernels = [(jconvbn, "conv_bn_pallas")] + ([(jlstm, "bilstm_layer_pallas")] if lstm else [])
    saved = [(mod, name, getattr(mod, name)) for mod, name in
             kernels + [(JL, "fused_cnn"), (JR, "_use_pallas")]]
    for mod, name in kernels:
        setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    if lstm:
        JR._use_pallas = lambda: True
    else:
        fused = JL.fused_cnn
        JL.fused_cnn = lambda enabled=True: fused(True)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def jax_runner(config, bf16, path=None):
    import jax.numpy as jnp

    from chiron_tpu.eval import pipeline as jp

    cfg = dict(config, bf16=bf16)
    params = jp.load_params(MODEL, cfg)
    # make_decode_step memoises its jitted step by config: a step traced on
    # another JAX path in this process would be reused as it is
    jp._DECODE_STEP_CACHE.clear()
    lb = float(config.get("length_bonus", 0.0))
    steps = {}

    def run(x, sl):
        b = len(x)
        if b not in steps:
            steps[b] = jp.make_decode_step(cfg, SEG, BEAM, b, length_bonus=lb)
        xin = jnp.asarray(x, dtype=jnp.bfloat16 if bf16 else jnp.float32)
        with jax_tpu_path(path == "lstm") if path else contextlib.nullcontext():
            buf = np.asarray(steps[b](params, xin, jnp.asarray(sl)))
        return jp.unpack_step_outputs(buf)[:2]

    return run


def torch_runner(config, bf16):
    import torch

    from chiron_tpu_torch.eval import pipeline as tp

    model = tp.load_model(MODEL, config, "cpu")
    lb = float(config.get("length_bonus", 0.0))

    def run(x, sl):
        xt = torch.from_numpy(x)
        buf = tp.decode_step(model, xt.to(torch.bfloat16) if bf16 else xt,
                             torch.from_numpy(sl), BEAM, lb, bf16).numpy()
        return tp.unpack_step_outputs(buf)[:2]

    return run


def same(a, b):
    """Windows whose (tokens, length) decode to the same bases."""
    return int(sum(bool(a[1][i] == b[1][i] and (a[0][i, :a[1][i]] == b[0][i, :b[1][i]]).all())
                   for i in range(len(a[1]))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--framing", nargs="+", default=["permuted", "distinct"],
                    choices=["permuted", "distinct"])
    ap.add_argument("--package", nargs="+", default=list(PACKAGES), choices=list(PACKAGES))
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.models.model import model_ratio

    config = C.read_config(os.path.join(MODEL, "model.json"))
    ratio = model_ratio(config, SEG)
    x_all, sl_all = windows(BIG)
    frames = np.round(sl_all / ratio).astype(np.int32)
    for framing in args.framing:
        if framing == "permuted":
            perms = [np.arange(BATCH)] + [
                torch.randperm(BATCH, generator=torch.Generator().manual_seed(k)).numpy()
                for k in range(1, 5)]
            parts = [(x_all[:BATCH][p], frames[:BATCH][p]) for p in perms]
        else:
            parts = [(x_all[k * BATCH:(k + 1) * BATCH], frames[k * BATCH:(k + 1) * BATCH])
                     for k in range(5)]
        big_x = np.ascontiguousarray(np.concatenate([p[0] for p in parts]))
        big_sl = np.concatenate([p[1] for p in parts])
        for package in args.package:
            for mode in ("bfloat16", "float32"):
                bf16 = mode == "bfloat16"
                run = (torch_runner(config, bf16) if package == "torch"
                       else jax_runner(config, bf16, PACKAGES[package]))
                t0 = time.time()
                small = [run(np.ascontiguousarray(x), sl) for x, sl in parts]
                big = run(big_x, big_sl)
                n = sum(same(tuple(a[k * BATCH:(k + 1) * BATCH] for a in big), small[k])
                        for k in range(5))
                print(json.dumps({"framing": framing, "package": package, "mode": mode,
                                  "identical_decodes": n, "windows": BIG,
                                  "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
