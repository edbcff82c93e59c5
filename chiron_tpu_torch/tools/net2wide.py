"""Function-preserving LSTM widening (Net2WiderNet) for bundled models.

Round-5 finding: continuing the fast flagship on its own corpus is FLAT
(valid edit 0.272 +- 0.001 over 6.6k steps at 1e-3) — the rounds-2-4 gains
came from data-distribution shifts, not schedule length, so the remaining
lever for the model-to-oracle gap is CAPACITY (VERDICT r4 #2's second
lever). Rather than paying a from-scratch schedule, this tool widens every
BiLSTM layer of a trained checkpoint 100 -> 128 (or any width) with the
Net2WiderNet construction (Chen, Goodfellow, Shlens, ICLR'16): duplicated
units copy their incoming weights, outgoing weights are split 1/(use
count), so the widened model computes the IDENTICAL function at init (test:
tests/test_net2wide.py pins logits equality to fp tolerance) and training
resumes from 65k steps of knowledge instead of zero.

Layout facts this construction depends on (models/rnn.py):
  * gates are 4 blocks of ``hidden`` ([i|g|f|o], rnn.py:124,155);
  * 'normal' stacks feed concat([fw, bw]) to the next layer (rnn.py:492);
  * the head mixes directions PER-UNIT (einsum btdh,dh; rnn.py:517) so the
    same duplication map must be used for fw and bw of the last layer —
    this tool uses one map for every direction and layer.

Symmetry breaking: exact duplicates receive identical gradients forever;
a small noise (1e-2 x column std) is added to the duplicated units'
INCOMING columns only, trading exactness ~1e-3 in logits for trainability
(the standard Net2Net recipe).

The port of ``chiron_tpu/tools/net2wide.py`` (numpy only, on the port's
checkpoints): ``widen_params`` gives the JAX package's trees byte for byte.

Usage:
    python -m chiron_tpu_torch.tools.net2wide --model chiron_tpu/model/DNA_default \
        --out <dir> --hidden 128
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np


def _widen_cols(w: np.ndarray, h_old: int, h_new: int, mapping, noise_rng,
                noise: float) -> np.ndarray:
    """Widen the gate axis (last, 4*h blocks): duplicate target units."""
    n_gates = w.shape[-1] // h_old
    blocks = []
    for g in range(n_gates):
        blk = w[..., g * h_old:(g + 1) * h_old]
        nb = blk[..., mapping]
        if noise > 0:
            dup = nb[..., h_old:]
            sd = dup.std() if dup.size else 0.0
            nb = np.concatenate(
                [nb[..., :h_old],
                 dup + noise_rng.randn(*dup.shape).astype(nb.dtype)
                 * (noise * (sd + 1e-8))], axis=-1)
        blocks.append(nb)
    return np.concatenate(blocks, axis=-1)


def _split_rows(w: np.ndarray, h_old: int, mapping, counts) -> np.ndarray:
    """Widen an h-indexed input axis (first): rows copied and split 1/count."""
    return (w[mapping] / counts[mapping][(...,) + (None,) * (w.ndim - 1)])


def widen_params(params: dict, h_old: int, h_new: int, seed: int = 0,
                 noise: float = 1e-2) -> dict:
    rng = np.random.RandomState(seed)
    noise_rng = np.random.RandomState(seed + 1)
    extra = rng.choice(h_old, size=h_new - h_old, replace=h_new - h_old > h_old)
    mapping = np.concatenate([np.arange(h_old), extra])
    counts = np.bincount(mapping, minlength=h_old).astype(np.float64)

    out = copy.deepcopy(params)
    layers = out["rnn"]["stack"]["layers"]
    for li, layer in enumerate(layers):
        for d in ("fw", "bw"):
            cell = layer[d]
            wx = np.asarray(cell["wx"])
            wh = np.asarray(cell["wh"])
            b = np.asarray(cell["b"])
            if li > 0:
                # input is concat([fw, bw]) of the previous layer: widen
                # both direction blocks of the input axis with the SAME map
                wx = np.concatenate(
                    [_split_rows(wx[:h_old], h_old, mapping, counts),
                     _split_rows(wx[h_old:], h_old, mapping, counts)], axis=0)
            wx = _widen_cols(wx, h_old, h_new, mapping, noise_rng, noise)
            wh = _split_rows(wh, h_old, mapping, counts)
            wh = _widen_cols(wh, h_old, h_new, mapping, noise_rng, noise)
            b = _widen_cols(b, h_old, h_new, mapping, noise_rng, 0.0)
            cell["wx"] = wx.astype(np.float32)
            cell["wh"] = wh.astype(np.float32)
            cell["b"] = b.astype(np.float32)
    head = out["rnn"]["head"]
    head["w_dir"] = np.asarray(head["w_dir"])[:, mapping].astype(np.float32)
    head["b_dir"] = np.asarray(head["b_dir"])[mapping].astype(np.float32)
    head["w_class"] = _split_rows(
        np.asarray(head["w_class"]), h_old, mapping, counts).astype(np.float32)
    return out


def widen_model_dir(model_dir: str, out_dir: str, h_new: int,
                    seed: int = 0, noise: float = 1e-2) -> None:
    from chiron_tpu_torch import config as C
    from chiron_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    cfg = C.read_config(os.path.join(model_dir, "model.json"))
    if (cfg["rnn"].get("cell_type", "LSTM") != "LSTM"
            or cfg["rnn"].get("layer_type", "normal") != "normal"):
        raise NotImplementedError(
            "net2wide supports LSTM cells with the 'normal' stacking order "
            "(all bundled models); 'rna' stacks feed H not 2H between "
            "layers and would need a different input-axis map")
    h_old = int(cfg["rnn"]["hidden_num"])
    with open(os.path.join(model_dir, "checkpoint")) as f:
        ckpt = f.read().strip().splitlines()[0]
    params = load_checkpoint(os.path.join(model_dir, ckpt))
    wide = widen_params(params, h_old, h_new, seed=seed, noise=noise)
    os.makedirs(out_dir, exist_ok=True)
    cfg = dict(cfg)
    cfg["rnn"] = dict(cfg["rnn"], hidden_num=h_new)
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(cfg, f)
    save_checkpoint(out_dir, wide, 0, prefix="model")
    print(f"widened {model_dir} ({h_old}) -> {out_dir} ({h_new})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise", type=float, default=1e-2)
    args = p.parse_args(argv)
    widen_model_dir(args.model, args.out, args.hidden, seed=args.seed,
                    noise=args.noise)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
