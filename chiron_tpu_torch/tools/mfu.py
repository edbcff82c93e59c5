"""Model FLOPs a sample and their share of the card's peak, for the bundled
models.

The port of ``tools_dev/mfu.py``. The JAX tool takes its count from XLA's
cost analysis; the port has no XLA, so the count here is analytic, from the
model's shapes. Each product is counted once, as two FLOPs a multiply-add,
whatever route its kernel takes (a 3xTF32 product counts once):

- conv: 2·k·C_in·C_out a conv's output frame. The front's training path
  runs on torch's ``meta`` device (shapes only, no data, no arithmetic)
  under ``torch.utils.flop_counter.FlopCounterMode``; the port's convs are
  one product a tap over the output frames (``ops/conv_bn.py:conv1d``), so
  the counter sees exactly that sum;
- projection: 2·C_in·G a frame, direction and layer (each ``wx*`` matrix:
  G = 4H for the LSTM and BNLSTM, 2H + H for the GRU);
- recurrence: 2·H·G a step, direction and layer (each ``wh*`` matrix);
- head: the direction mix 2·2H and the class product 2·H·class_n a frame,
  or the CNN-only head's 2·C·class_n.

Elementwise work, batch norm, the gates, the log-softmax and the CTC decode
are not counted. The JAX tool's XLA count misses the recurrence (it counts
the scan body once, not once a step), so the two agree only without it.

The shares are against NVIDIA's data sheet for the H100 SXM at 700 W:
989 TFLOP/s bf16 and 67 float32 (the JAX tool's two peaks); the card's name
and power limit are printed beside every share.

Usage: python -m chiron_tpu_torch.tools.mfu [--samples_per_s_fast N
       --samples_per_s_slow N] [--device cpu]
Without a rate the tool measures it on the card with the bench's device
step (``bench.device_throughput``); ``--device cpu`` prints the counts only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

PEAK_BF16 = 989e12
PEAK_F32 = 67e12

# (model, window samples, the bench's device batch)
BUNDLED = (("DNA_default", 400, 2000), ("DNA_slow", 2000, 400), ("RNA_default", 2000, None))


def _to_meta(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v) for v in tree]
    return tree.to("meta") if isinstance(tree, torch.Tensor) else tree


def _matrices(tree, prefix):
    """Every 2-D leaf of ``tree`` whose key starts with ``prefix``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k.startswith(prefix) and getattr(v, "ndim", 0) == 2:
                yield v
            else:
                yield from _matrices(v, prefix)
    elif isinstance(tree, list):
        for v in tree:
            yield from _matrices(v, prefix)


def flop_terms(config: Dict, seg: int) -> Dict[str, float]:
    """FLOPs of one window of ``seg`` samples, by term: conv, projection,
    recurrence, head (see the module docstring)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from chiron_tpu_torch.models.model import _front, init_model, output_len

    params = _to_meta(init_model(torch.Generator().manual_seed(0), config))
    _, apply_fn = _front(config)
    with FlopCounterMode(display=False) as counter:
        apply_fn(params["cnn"], torch.zeros(1, seg, 1, device="meta"), config["cnn"],
                 training=True)
    frames = output_len(config, seg)
    terms = {"conv": float(counter.get_total_flops())}
    if config["rnn"]["layer_num"] == 0:
        terms["head"] = 2.0 * frames * params["cnn_logit"]["w"].numel()
        return terms
    stack, head = params["rnn"]["stack"], params["rnn"]["head"]
    terms["projection"] = 2.0 * frames * sum(w.numel() for w in _matrices(stack, "wx"))
    terms["recurrence"] = 2.0 * frames * sum(w.numel() for w in _matrices(stack, "wh"))
    terms["head"] = 2.0 * frames * (head["w_dir"].numel() + head["w_class"].numel())
    return terms


def flops_per_sample(model_dir: str, seg: int) -> float:
    """Model FLOPs a signal sample of ``model_dir``'s model at window ``seg``."""
    from chiron_tpu_torch import config as C

    config = C.read_config(os.path.join(model_dir, "model.json"))
    return sum(flop_terms(config, seg).values()) / seg


def shares(flops: float, samples_per_s: float) -> Dict[str, float]:
    """Achieved FLOP/s at ``samples_per_s`` and its share of each peak."""
    eff = flops * samples_per_s
    return {"device_samples_per_s": samples_per_s, "effective_tflops": eff / 1e12,
            "share_of_bf16_peak": eff / PEAK_BF16, "share_of_f32_peak": eff / PEAK_F32}


def main(argv=None) -> int:
    from chiron_tpu_torch.cli import MODEL_ROOT

    p = argparse.ArgumentParser(description="Model FLOPs a sample and the share of peak")
    p.add_argument("--samples_per_s_fast", type=float, default=None,
                   help="device samples/s of DNA_default at window 400 (default: the "
                        "bench's device step, measured on the card)")
    p.add_argument("--samples_per_s_slow", type=float, default=None,
                   help="device samples/s of DNA_slow at window 2000 (default: measured)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; without a GPU an error) or cpu: counts only")
    args = p.parse_args(argv)
    from chiron_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    given = {"DNA_default": args.samples_per_s_fast, "DNA_slow": args.samples_per_s_slow}
    card = None
    if dev.type == "cuda":
        from chiron_tpu_torch import bench

        card = bench.card_name()
    for name, seg, batch in BUNDLED:
        mdir = os.path.join(MODEL_ROOT, name)
        f = flops_per_sample(mdir, seg)
        row = {"model": name, "window": seg, "flops_per_sample": f}
        sps = given.get(name)
        if sps is None and batch and card:
            sps = bench.device_throughput(mdir, batch=batch, seg=seg, device=str(dev))
        if sps and card:
            row.update(shares(f, sps), card=card)
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
