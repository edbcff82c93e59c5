"""Model-architecture grid search: generate configs, optionally train+rank.

Completes what the reference left as a stub (chiron/grid_search.py:1-26,
an unfinished TODO): the cartesian product of dynamic_net CNN stacks and
RNN widths is materialised as model.json files, and — given training data —
each candidate is trained for a short budget and ranked by validation CTC
loss.

The port of ``chiron_tpu/tools/grid_search.py``: the same grid, configs and
ranking, each candidate trained by the port's trainer on ``device`` (default
cuda; a missing GPU raises). A candidate whose config fails records an
infinite loss and its error, as in the JAX package; a fault of the card or
of the kernels (a CUDA error, a kernel that does not build, a failed
launch) ends the sweep instead of being recorded against the candidate.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import types
from typing import Dict, List, Optional

DEFAULT_GRID = {
    "cnn_layers": [["res"] * 3],
    "hidden_num": [[128] * 3, [256] * 3],
    "kernels": [[5, 5, 5], [15, 3, 3]],
    "strides": [[2, 2, 2], [5, 1, 1]],
    "rnn_hidden": [100, 200],
}


def generate_configs(grid: Optional[Dict] = None) -> List[Dict]:
    grid = grid or DEFAULT_GRID
    configs = []
    for tp, hu, kw, st, rnn_hu in itertools.product(
        grid["cnn_layers"],
        grid["hidden_num"],
        grid["kernels"],
        grid["strides"],
        grid["rnn_hidden"],
    ):
        if not (len(tp) == len(hu) == len(kw) == len(st)):
            continue
        configs.append(
            {
                "cnn": {
                    "model": "dynamic_net",
                    "tp": tp,
                    "hu": hu,
                    "kw": kw,
                    "st": st,
                    "pd": ["SAME"] * len(tp),
                },
                "rnn": {
                    "layer_num": 3,
                    "hidden_num": rnn_hu,
                    "cell_type": "LSTM",
                    "layer_type": "normal",
                },
                "opt_method": "Momentum",
                "fl_gamma": 2,
            }
        )
    return configs


def write_configs(out_dir: str, configs: List[Dict]) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, cfg in enumerate(configs):
        path = os.path.join(out_dir, f"config_{i:03d}.json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
        paths.append(path)
    return paths


def device_fault(e: BaseException) -> bool:
    """Whether a candidate's exception is the card's or the kernels' rather
    than its config's: those end the sweep."""
    import torch

    from chiron_tpu_torch.ops.cuda_build import KernelError

    return isinstance(e, (KernelError, torch.AcceleratorError, torch.cuda.OutOfMemoryError))


def search(
    data_dir: str,
    out_dir: str,
    max_steps: int = 200,
    batch_size: int = 64,
    sequence_len: int = 300,
    grid: Optional[Dict] = None,
    device: str = "cuda",
) -> List[Dict]:
    """Train every candidate briefly on ``device``; return configs ranked by
    final loss."""
    from chiron_tpu_torch.train import loop
    from chiron_tpu_torch.utils.device import resolve_device

    resolve_device(device)  # no GPU: fail before the first candidate
    configs = generate_configs(grid)
    paths = write_configs(out_dir, configs)
    results = []
    for i, path in enumerate(paths):
        h = types.SimpleNamespace(
            data_dir=data_dir,
            log_dir=os.path.join(out_dir, "runs"),
            model_name=f"cand_{i:03d}",
            validation=None,
            sequence_len=sequence_len,
            batch_size=batch_size,
            step_rate=4e-3,
            max_steps=max_steps,
            segments_num=None,
            configure=path,
            k_mer=1,
            retrain=False,
            resample_after_epoch=0,
            offset_increment=3,
            n_devices=1,
            save_every=max(max_steps // 2, 1),
            device=device,
        )
        try:
            r = loop.train(h)
            results.append(
                {"config": path, "final_loss": r["final_loss"], "index": i}
            )
        except Exception as e:  # a bad candidate must not kill the sweep
            if device_fault(e):
                raise
            results.append({"config": path, "final_loss": float("inf"),
                            "index": i, "error": str(e)})
    results.sort(key=lambda r: r["final_loss"])
    with open(os.path.join(out_dir, "ranking.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="Architecture grid search.")
    parser.add_argument("-i", "--data_dir", default=None,
                        help="training data dir; omit to only generate configs")
    parser.add_argument("-o", "--out_dir", required=True)
    parser.add_argument("-x", "--max_steps", type=int, default=200)
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("-s", "--sequence_len", type=int, default=300)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a GPU is an error")
    args = parser.parse_args(argv)
    if args.data_dir:
        results = search(args.data_dir, args.out_dir, args.max_steps,
                         args.batch_size, args.sequence_len, device=args.device)
        for r in results[:5]:
            print(f"{r['final_loss']:.4f}  {r['config']}")
    else:
        paths = write_configs(args.out_dir, generate_configs())
        print(f"Wrote {len(paths)} candidate configs to {args.out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
