"""The read generator that every traffic mix of simulated reads drives.

A mix's file gives the parameters; the generator makes the reads from
``--seed`` with the frozen simulator and the frozen pore model:

- ``n_reads`` read lengths in bases, the quantiles (i + 0.5) / n of a
  log-normal with median ``median_bases`` and shape ``sigma``, clipped to
  [``min_bases``, ``max_bases``]. Every seed gets the same lengths, so every
  seed gets the same work; the seed picks which read has which length and
  what it holds.
- the signal of each at the ``sim`` knobs of ``SimConfig`` (dwell, noise),
  rounded to the integers a ``.signal`` file holds, and written once as
  ``<name>.signal`` (or kept in memory with its bases, for training).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

from benchmark.frozen import simulate

_HERE = os.path.dirname(os.path.abspath(__file__))
PORE_MODEL = os.path.join(_HERE, "frozen", "pore_model.tsv")


@dataclass
class Read:
    name: str      # file stem
    bases: int     # truth bases
    samples: int   # signal samples written


def rng_for(seed: int, stream: int) -> np.random.RandomState:
    """A RandomState for one use of the seed (any non-negative int, also
    past 2**32)."""
    return np.random.RandomState(np.random.MT19937(np.random.SeedSequence([int(seed), stream])))


def read_lengths(p: Dict) -> List[int]:
    n = int(p["n_reads"])
    dist = NormalDist(np.log(p["median_bases"]), p["sigma"])
    out = [int(round(np.exp(dist.inv_cdf((i + 0.5) / n)))) for i in range(n)]
    return [min(max(v, int(p["min_bases"])), int(p["max_bases"])) for v in out]


def simulate_reads(p: Dict, seed: int) -> Iterator[Tuple[str, str, np.ndarray, np.ndarray,
                                                        np.ndarray]]:
    """(name, bases, base starts, dwells, signal as the files hold it) of each
    read, in name order."""
    rng = rng_for(seed, 0)
    lengths = read_lengths(p)
    order = rng.permutation(len(lengths))
    model = simulate.KmerModel.load(PORE_MODEL)
    cfg = simulate.SimConfig(**p.get("sim", {}))
    for i, j in enumerate(order):
        seq, starts, dwell, signal = simulate.simulate_read(rng, model, lengths[j], cfg)
        yield f"read{i:03d}", seq, starts, dwell, np.asarray(np.rint(signal), np.int64)


def generate(p: Dict, seed: int, out_dir: str) -> List[Read]:
    """Write the mix's reads under ``out_dir`` as ``.signal`` files; returns
    them in name order."""
    os.makedirs(out_dir, exist_ok=True)
    reads = []
    for name, seq, _, _, sig_int in simulate_reads(p, seed):
        with open(os.path.join(out_dir, name + ".signal"), "w") as f:
            f.write(" ".join(map(str, sig_int.tolist())))
        reads.append(Read(name, len(seq), len(sig_int)))
    return reads
