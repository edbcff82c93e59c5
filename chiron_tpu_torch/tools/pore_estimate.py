"""Estimate a k-mer pore model from (signal, sequence) read pairs by EM.

Bootstraps basecaller training when no ONT pore-model table is available
(this mount ships none, and the reference's pretrained weights are absent):
given raw reads plus any trusted sequence for each (e.g. another
basecaller's output used as pseudo-labels), the estimator

  1. detects level-shift events in each signal (two-window jump statistic,
     the classic ONT event detector's shape)
  2. EM at the event level: DTW-align event means to per-base expected
     levels under the current k-mer model (native aligner,
     tools/resquiggle.py), re-estimate per-k-mer level means/stdvs from
     the matched events, ramping k up across iterations
  3. refines at the sample level: dwell-expanded DTW of the raw signal
     against the converged model, boundary-trimmed segment means

Event-level bootstrap is what makes this converge: aligning ~1 event per
base keeps the DTW diagonal's slope near 1 even when the model is still
poor, so early misalignments don't get baked in (measured: mean boundary
error 8 samples at bootstrap vs 400+ from a uniform-segmentation start).

The result is a KmerModel usable by tools/simulate.py (training-scale
synthetic data matching real signal statistics) and tools/labeler.py
(resquiggling real reads into training labels). No reference counterpart:
the reference delegates this to the vendored cwDTW binary's built-in pore
model (chiron/chiron_label.py).

A copy of ``chiron_tpu/tools/pore_estimate.py`` (numpy only) on the port's
resquiggle, whose alignments are the JAX package's numpy fallback; the
tests hold the two estimates to the same levels and stdvs.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from chiron_tpu_torch.tools.resquiggle import resquiggle_signal, znorm
from chiron_tpu_torch.tools.simulate import KmerModel, seq_to_ids


# ---------------------------------------------------------------------------
# event detection
# ---------------------------------------------------------------------------

def detect_events(signal: np.ndarray, w: int = 3, min_len: int = 2):
    """Segment a signal at level shifts.

    Two-window mean-difference score, greedy non-maximum suppression with a
    ``min_len`` exclusion zone. Returns (starts [E+1], event means [E]).
    """
    x = np.asarray(signal, np.float64)
    n = len(x)
    if n < 4 * w:
        return np.array([0, n], np.int64), np.array([x.mean()], np.float64)
    cs = np.concatenate([[0.0], np.cumsum(x)])
    t = np.arange(w, n - w)
    score = np.abs((cs[t + w] - cs[t]) - (cs[t] - cs[t - w])) / w
    cand = np.where((score[1:-1] >= score[:-2]) & (score[1:-1] > score[2:]))[0] + 1
    cand = cand[np.argsort(-score[cand])]
    taken = np.zeros(n, bool)
    bounds = []
    for c in cand:
        pos = int(t[c])
        if not taken[max(0, pos - min_len):pos + min_len + 1].any():
            bounds.append(pos)
            taken[pos] = True
    starts = np.concatenate([[0], np.sort(np.asarray(bounds, np.int64)), [n]])
    lengths = np.diff(starts)
    means = np.add.reduceat(x, starts[:-1]) / lengths
    return starts, means


# ---------------------------------------------------------------------------
# M-step
# ---------------------------------------------------------------------------

def _mstep(
    per_read: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], k: int
) -> KmerModel:
    """per_read: (ids, per-base means, valid mask) triples -> KmerModel."""
    n_kmers = 4 ** k
    sums = np.zeros(n_kmers, np.float64)
    sqs = np.zeros(n_kmers, np.float64)
    counts = np.zeros(n_kmers, np.int64)
    probe = KmerModel(np.zeros(n_kmers, np.float32), k=k)
    for ids, means, valid in per_read:
        codes = probe.kmer_codes(ids)[valid]
        m = means[valid]
        sums += np.bincount(codes, weights=m, minlength=n_kmers)
        sqs += np.bincount(codes, weights=m * m, minlength=n_kmers)
        counts += np.bincount(codes, minlength=n_kmers)
    seen = counts > 0
    level = np.zeros(n_kmers, np.float64)
    level[seen] = sums[seen] / counts[seen]
    var = np.zeros(n_kmers, np.float64)
    var[seen] = np.maximum(sqs[seen] / counts[seen] - level[seen] ** 2, 1e-6)
    # unseen k-mers: back off to the mean of k-mers sharing the central base
    if (~seen).any():
        half = (k - 1) // 2
        central = (np.arange(n_kmers) // (4 ** (k - 1 - half))) % 4
        for b in range(4):
            mask = central == b
            have = mask & seen
            fill = level[have].mean() if have.any() else level[seen].mean()
            level[mask & ~seen] = fill
            var[mask & ~seen] = var[seen].mean() if seen.any() else 0.05
    return KmerModel(level.astype(np.float32), np.sqrt(var).astype(np.float32), k)


def _base_means_from_events(event_means, align):
    """Per-base mean event level given base -> first-event offsets [n+1]."""
    counts = np.diff(align)
    valid = counts > 0
    padded = np.concatenate([event_means, [0.0]])
    sums = np.add.reduceat(padded, np.minimum(align[:-1], len(event_means) - 1))
    means = np.where(valid, sums / np.maximum(counts, 1), 0.0)
    return means, valid


def _trimmed_segment_means(signal, starts, trim_frac=0.25):
    """Per-base mean of the central (1 - 2*trim_frac) of each segment."""
    lengths = np.diff(starts).astype(np.int64)
    trim = (lengths * trim_frac).astype(np.int64)
    s = starts[:-1] + trim
    e = starts[1:] - trim
    valid = e > s
    cs = np.concatenate([[0.0], np.cumsum(signal, dtype=np.float64)])
    sums = cs[np.minimum(e, len(signal))] - cs[np.minimum(s, len(signal))]
    means = np.where(valid, sums / np.maximum(e - s, 1), 0.0)
    return means, valid


# ---------------------------------------------------------------------------
# EM driver
# ---------------------------------------------------------------------------

def estimate_kmer_model(
    pairs: Sequence[Tuple[np.ndarray, str]],
    k: int = 5,
    iters: int = 3,
    radius: int = 50,
    verbose: bool = False,
) -> KmerModel:
    """EM-estimate a k-mer model from (raw signal, sequence) pairs.

    ``iters`` counts the extra full-k event iterations after the k ramp,
    plus a final sample-level refinement pass.
    """
    reads = [(znorm(sig), seq_to_ids(seq)) for sig, seq in pairs if len(seq) >= k]
    if not reads:
        raise ValueError("no usable (signal, sequence) pairs")
    events = [detect_events(sig) for sig, _ in reads]

    # ramp k up, then polish at full k
    k_schedule = [min(j, k) for j in range(1, k)] + [k] * max(iters, 1)
    # init: proportional event -> base mapping
    aligns = [
        np.linspace(0, len(em), len(ids) + 1).astype(np.int64)
        for (es, em), (_, ids) in zip(events, reads)
    ]
    model: Optional[KmerModel] = None
    for it, k_it in enumerate(k_schedule):
        per_read = []
        for (es, em), (_, ids), al in zip(events, reads, aligns):
            means, valid = _base_means_from_events(em, al)
            per_read.append((ids, means, valid))
        model = _mstep(per_read, k_it)
        if verbose:
            print(f"EM event iter {it}: k={k_it} spread {np.std(model.means):.3f}")
        if it == len(k_schedule) - 1:
            break
        # E-step: align event means to per-base expected levels
        aligns = []
        for (es, em), (sig, ids) in zip(events, reads):
            levels = model.per_base(ids)[0]
            al = resquiggle_signal(
                znorm(em), "A" * len(ids), pore_model=_RawLevels(levels),
                radius=max(radius, 100), expand=1,
            )
            aligns.append(al.astype(np.int64))

    # sample-level refinement with the converged model
    for it in range(2):
        pm = model.to_pore_model()
        per_read = []
        for sig, ids in reads:
            seq = "".join("ACGT"[i] for i in ids)
            starts = resquiggle_signal(sig, seq, pore_model=pm, radius=radius)
            means, valid = _trimmed_segment_means(sig, starts.astype(np.int64))
            per_read.append((ids, means, valid))
        model = _mstep(per_read, k)
        if verbose:
            print(f"EM sample iter {it}: spread {np.std(model.means):.3f}")
    return model


class _RawLevels:
    """PoreModel-shaped adapter that returns a precomputed level array."""

    def __init__(self, levels: np.ndarray):
        self._levels = np.asarray(levels, np.float32)

    def expected_signal(self, _sequence: str) -> np.ndarray:
        return self._levels


def final_alignments(
    pairs: Sequence[Tuple[np.ndarray, str]], model: KmerModel, radius: int = 50
) -> List[np.ndarray]:
    """Resquiggle each pair with the final model (label generation)."""
    pm = model.to_pore_model()
    return [
        resquiggle_signal(znorm(sig), seq, pore_model=pm, radius=radius)
        for sig, seq in pairs
    ]


# ---------------------------------------------------------------------------
# CLI: signal dir + fastx of sequences -> model TSV (+ optional .label files)
# ---------------------------------------------------------------------------

def _load_pairs(signal_dir: str, fastx: str):
    from chiron_tpu_torch.tools.assess import _read_fastx

    seqs = _read_fastx(fastx)
    pairs, names = [], []
    for fn in sorted(os.listdir(signal_dir)):
        if not fn.endswith(".signal"):
            continue
        name = fn[: -len(".signal")]
        if name not in seqs:
            continue
        sig = np.loadtxt(os.path.join(signal_dir, fn), dtype=np.float32).ravel()
        pairs.append((sig, seqs[name]))
        names.append(name)
    return names, pairs


def main(argv=None):
    p = argparse.ArgumentParser(description="EM-estimate a k-mer pore model.")
    p.add_argument("-i", "--input", required=True,
                   help="directory of <name>.signal files")
    p.add_argument("-r", "--reads", required=True,
                   help="fasta/fastq of per-read sequences keyed by <name>")
    p.add_argument("-o", "--output", required=True, help="model TSV out path")
    p.add_argument("-k", type=int, default=5)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--radius", type=int, default=50)
    p.add_argument("--labels", default=None,
                   help="also write <name>.signal/.label training pairs here")
    args = p.parse_args(argv)
    names, pairs = _load_pairs(args.input, args.reads)
    if not pairs:
        print("No (signal, sequence) pairs found", file=sys.stderr)
        return 1
    model = estimate_kmer_model(pairs, k=args.k, iters=args.iters,
                                radius=args.radius, verbose=True)
    model.save(args.output)
    print(f"Saved {args.k}-mer model ({len(pairs)} reads) to {args.output}")
    if args.labels:
        os.makedirs(args.labels, exist_ok=True)
        aligns = final_alignments(pairs, model, radius=args.radius)
        for name, (sig, seq), starts in zip(names, pairs, aligns):
            with open(os.path.join(args.labels, name + ".signal"), "w") as f:
                f.write(" ".join(str(int(round(float(x)))) for x in sig))
            with open(os.path.join(args.labels, name + ".label"), "w") as f:
                for j, b in enumerate(seq):
                    s, e = int(starts[j]), int(starts[j + 1])
                    # the windower requires events to end strictly before
                    # the signal's last sample (io/labels.py read_raw)
                    e = min(e, len(sig) - 1)
                    if e > s:
                        f.write(f"{s} {e} {b}\n")
        print(f"Wrote labels for {len(names)} reads to {args.labels}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
