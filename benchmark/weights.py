"""The weights a configuration is run with, written as the model directory
that the program's ``-m`` and the reference both read.

A configuration's ``weights`` names a checkpoint directory of the repo (read
as a data file) and how it is brought to the configuration's widths:

- ``"narrow": {"hidden_from": H1, "map_seed": s}``: the checkpoint is a
  BiLSTM stack widened from the configuration's ``lstm.hidden`` H0 to H1 by
  Net2WiderNet (Chen, Goodfellow and Shlens, ICLR 2016), whose units H0..H1-1
  copy the units ``RandomState(s).choice(H0, H1 - H0, replace=False)``.
  The construction is undone: a unit's incoming gate columns (and its bias,
  and its head mixing ``w_dir`` / ``b_dir``) are the mean over its copies,
  and its outgoing rows (``wh``, the next layer's ``wx``, ``w_class``) the
  sum over its copies. Where the widened model was not trained further this
  gives back the narrow model exactly; after training it is the nearest
  narrow model, and it decodes as a trained basecaller does.

The directory holds ``model.json`` (the configuration's ``model``), the flat
npz of the leaves and the ``checkpoint`` file naming it, as the program's
checkpoints are laid out. The CNN front's leaves are the checkpoint's own.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Tuple

import numpy as np

CHECKPOINT = "weights-0.npz"


def _load(model_dir: str) -> Dict[str, np.ndarray]:
    with open(os.path.join(model_dir, "checkpoint")) as f:
        name = f.read().strip().splitlines()[0]
    with np.load(os.path.join(model_dir, name)) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def _narrow(flat: Dict[str, np.ndarray], h0: int, h1: int, seed: int) -> Dict[str, np.ndarray]:
    mapping = np.concatenate([np.arange(h0),
                              np.random.RandomState(seed).choice(h0, h1 - h0, replace=False)])
    groups = [np.flatnonzero(mapping == u) for u in range(h0)]

    def units_mean(v):  # [..., h1] -> [..., h0]
        return np.stack([v[..., g].mean(-1) for g in groups], -1)

    def gate_cols(v):  # [..., 4 * h1] -> [..., 4 * h0], gate by gate
        return np.concatenate([units_mean(b) for b in np.split(v, v.shape[-1] // h1, -1)], -1)

    def rows(v):  # [h1, ...] -> [h0, ...]
        return np.stack([v[g].sum(0) for g in groups], 0)

    out = {}
    for key, v in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if key.startswith("rnn/stack/"):
            if leaf == "wh":
                v = gate_cols(rows(v))
            elif leaf == "wx":
                if "/layers/[0]/" not in key:  # rows: the layer below's two directions
                    v = np.concatenate([rows(v[:h1]), rows(v[h1:])], 0)
                v = gate_cols(v)
            elif leaf == "b":
                v = gate_cols(v)
        elif key in ("rnn/head/w_dir", "rnn/head/b_dir"):
            v = units_mean(v)
        elif key == "rnn/head/w_class":
            v = rows(v)
        out[key] = np.ascontiguousarray(v, np.float32)
    return out


@functools.lru_cache(maxsize=4)
def _leaves(source: str, h0: int, h1: int, seed: int) -> Tuple[Tuple[str, np.ndarray], ...]:
    return tuple(_narrow(_load(source), h0, h1, seed).items())


def leaves(config: Dict) -> Dict[str, np.ndarray]:
    """key -> float32 array of every leaf the configuration runs with."""
    from benchmark.harness import ROOT

    spec = config["weights"]
    source = os.path.join(ROOT, spec["checkpoint"])
    narrow = spec["narrow"]
    return dict(_leaves(source, int(config["lstm"]["hidden"]), int(narrow["hidden_from"]),
                        int(narrow["map_seed"])))


def shapes(config: Dict) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in leaves(config).items()}


def write_model_dir(config: Dict, out_dir: str) -> str:
    """The configuration's model directory under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, CHECKPOINT), **leaves(config))
    with open(os.path.join(out_dir, "checkpoint"), "w") as f:
        f.write(CHECKPOINT + "\n")
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(config["model"], f)
    return out_dir
