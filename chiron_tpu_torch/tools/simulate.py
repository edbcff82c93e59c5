"""Nanopore signal simulator: k-mer pore model -> realistic raw signal.

A copy of ``chiron_tpu/tools/simulate.py`` (numpy only), so that the port's
accuracy and benchmark entry points import nothing of the JAX package;
the tests hold the two copies to the same outputs.

Training-scale generator for the framework's bundled models and accuracy
holdouts. The reference has no simulator (its only synthetic data is the
per-base dummy generator in chiron/chiron_input.py:732-817, which this
framework mirrors in tests/synth.py); real nanopore signal is k-mer
context dependent with heavy-tailed dwell times, per-read scale/offset
and slow baseline drift, so models trained on per-base levels cannot
transfer. This simulator adds each of those effects:

  * k-mer dependent current levels (synthetic position-weighted model,
    a loaded ONT-style TSV table, or a model estimated from real reads
    by tools/pore_estimate.py)
  * geometric dwell times (mean ~= sampling_rate / translocation speed)
  * Gaussian level noise, optionally k-mer dependent
  * low-frequency baseline drift (random walk + slow sine)
  * per-read scale/offset jitter (removed downstream by MEAN/MEDIAN
    read normalisation, as at training/eval time)

Everything is vectorised: one read is a repeat() of per-base levels plus
noise fields; a million-window corpus generates in minutes on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Tuple

import numpy as np

BASES = "ACGT"
_BASE_IDX = np.full(128, -1, np.int8)
for _i, _b in enumerate(BASES):
    _BASE_IDX[ord(_b)] = _i
    _BASE_IDX[ord(_b.lower())] = _i
_BASE_IDX[ord("U")] = 3
_BASE_IDX[ord("u")] = 3


def seq_to_ids(seq: str) -> np.ndarray:
    ids = _BASE_IDX[np.frombuffer(seq.encode(), np.uint8)]
    if (ids < 0).any():
        raise ValueError("sequence contains non-ACGT(U) characters")
    return ids.astype(np.int64)


def ids_to_seq(ids: np.ndarray) -> str:
    return "".join(BASES[i] for i in ids)


class KmerModel:
    """k-mer -> (level mean, level stdv) table over the 4^k index space.

    The index of a k-mer is its base-4 code, first base most significant.
    """

    def __init__(self, means: np.ndarray, stdvs: Optional[np.ndarray] = None,
                 k: Optional[int] = None):
        self.means = np.asarray(means, np.float32)
        self.k = int(k if k is not None else round(np.log(len(self.means)) / np.log(4)))
        if len(self.means) != 4 ** self.k:
            raise ValueError("means must have 4^k entries")
        if stdvs is None:
            stdvs = np.full_like(self.means, float(np.std(self.means)) * 0.25)
        self.stdvs = np.asarray(stdvs, np.float32)

    # -- constructors -------------------------------------------------------
    @classmethod
    def synthetic(cls, k: int = 6, seed: int = 1234) -> "KmerModel":
        """A structured random pore model.

        Per-position base effects (central positions dominating, as in real
        pores) plus a small idiosyncratic per-k-mer term — learnable context
        dependence rather than iid noise.
        """
        rng = np.random.RandomState(seed)
        weights = np.exp(-0.5 * ((np.arange(k) - (k - 1) / 2) / (k / 4.0)) ** 2)
        weights /= weights.sum()
        base_effect = rng.randn(k, 4).astype(np.float32)
        codes = np.arange(4 ** k)
        means = np.zeros(4 ** k, np.float32)
        for pos in range(k):
            digit = (codes // (4 ** (k - 1 - pos))) % 4
            means += weights[pos] * base_effect[pos, digit]
        means += 0.15 * rng.randn(4 ** k).astype(np.float32)
        means = (means - means.mean()) / means.std()
        stdvs = np.full(4 ** k, 0.22, np.float32) + 0.08 * rng.rand(4 ** k).astype(
            np.float32
        )
        return cls(means, stdvs, k)

    @classmethod
    def load(cls, path: str) -> "KmerModel":
        """ONT-style TSV: kmer<TAB>level_mean[<TAB>level_stdv...]."""
        kmers, means, stdvs = [], [], []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or line.lower().startswith("kmer"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    kmers.append(parts[0])
                    means.append(float(parts[1]))
                    stdvs.append(float(parts[2]) if len(parts) >= 3 else np.nan)
        k = len(kmers[0])
        mean_arr = np.zeros(4 ** k, np.float32)
        stdv_arr = np.full(4 ** k, np.nan, np.float32)
        for km, mu, sd in zip(kmers, means, stdvs):
            code = int(np.sum(seq_to_ids(km) * 4 ** np.arange(k - 1, -1, -1)))
            mean_arr[code] = mu
            stdv_arr[code] = sd
        if np.isnan(stdv_arr).all():
            stdv_arr = None
        else:
            stdv_arr = np.nan_to_num(stdv_arr, nan=float(np.nanmean(stdv_arr)))
        return cls(mean_arr, stdv_arr, k)

    def save(self, path: str) -> None:
        k = self.k
        with open(path, "w") as f:
            f.write("kmer\tlevel_mean\tlevel_stdv\n")
            for code in range(4 ** k):
                digits = [(code // (4 ** (k - 1 - p))) % 4 for p in range(k)]
                f.write(
                    "".join(BASES[d] for d in digits)
                    + f"\t{self.means[code]:.6f}\t{self.stdvs[code]:.6f}\n"
                )

    # -- lookup -------------------------------------------------------------
    def kmer_codes(self, ids: np.ndarray) -> np.ndarray:
        """Centered k-mer code per base (edges clamp to the nearest full
        k-mer, matching PoreModel.expected_signal's edge handling)."""
        n = len(ids)
        k = self.k
        if n < k:
            ids = np.pad(ids, (0, k - n), mode="edge")
            n_pad = len(ids)
        else:
            n_pad = n
        # rolling base-4 code over windows [i, i+k)
        pows = 4 ** np.arange(k - 1, -1, -1)
        win = np.lib.stride_tricks.sliding_window_view(ids[:n_pad], k)
        codes_full = win @ pows  # [n_pad - k + 1]
        half = (k - 1) // 2
        idx = np.clip(np.arange(n) - half, 0, len(codes_full) - 1)
        return codes_full[idx]

    def per_base(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        codes = self.kmer_codes(ids)
        return self.means[codes], self.stdvs[codes]

    def to_pore_model(self) -> "_KmerPoreModel":
        """Adapter for tools/resquiggle.py's DTW aligner (duck-typed: the
        aligner only calls expected_signal)."""
        return _KmerPoreModel(self)


class _KmerPoreModel:
    """PoreModel-compatible adapter backed by a KmerModel array table."""

    def __init__(self, km: KmerModel):
        self._km = km
        self.k = km.k

    def expected_signal(self, sequence: str) -> np.ndarray:
        ids = seq_to_ids(sequence.upper().replace("U", "T"))
        return self._km.per_base(ids)[0].astype(np.float32)


class SimConfig:
    """Signal-generation knobs (defaults ~ R9.4 DNA at 4 kHz / 450 b/s)."""

    def __init__(
        self,
        mean_dwell: float = 9.0,
        min_dwell: int = 2,
        max_dwell: int = 60,
        noise: float = 1.0,           # scales the model's per-kmer stdv
        noise_ar: float = 0.0,        # AR(1) coefficient of the level noise
        drift_walk: float = 0.0035,   # random-walk step as fraction of level sd
        drift_sine_amp: float = 0.12,
        drift_sine_period: float = 60_000.0,
        scale_jitter: float = 0.08,
        offset_jitter: float = 0.25,
        level_scale: float = 12.0,    # DAC units per model sd
        level_offset: float = 450.0,  # DAC baseline
    ):
        self.mean_dwell = mean_dwell
        self.min_dwell = min_dwell
        self.max_dwell = max_dwell
        self.noise = noise
        self.noise_ar = noise_ar
        self.drift_walk = drift_walk
        self.drift_sine_amp = drift_sine_amp
        self.drift_sine_period = drift_sine_period
        self.scale_jitter = scale_jitter
        self.offset_jitter = offset_jitter
        self.level_scale = level_scale
        self.level_offset = level_offset

    @classmethod
    def rna(cls) -> "SimConfig":
        # RNA translocates ~70 b/s at 3 kHz -> ~43 samples/base
        return cls(mean_dwell=43.0, max_dwell=300, drift_sine_period=200_000.0)


def simulate_read(
    rng: np.random.RandomState,
    model: KmerModel,
    n_bases: int = 2000,
    cfg: Optional[SimConfig] = None,
) -> Tuple[str, np.ndarray, np.ndarray, np.ndarray]:
    """One read: returns (sequence, starts, lengths, signal float32)."""
    cfg = cfg or SimConfig()
    ids = rng.randint(0, 4, n_bases)
    means, stdvs = model.per_base(ids)

    p = 1.0 / max(cfg.mean_dwell - cfg.min_dwell + 1, 1.0)
    dwell = cfg.min_dwell + rng.geometric(p, n_bases) - 1
    dwell = np.minimum(dwell, cfg.max_dwell)
    starts = np.zeros(n_bases, np.int64)
    np.cumsum(dwell[:-1], out=starts[1:])
    total = int(starts[-1] + dwell[-1])

    level = np.repeat(means, dwell)
    sigma = np.repeat(stdvs, dwell) * cfg.noise
    eps = rng.randn(total).astype(np.float32)
    if cfg.noise_ar > 0:
        # AR(1) low-pass noise: real pore noise is autocorrelated (flicker),
        # and a model trained only on white noise reads real noise wobbles
        # as base transitions (insertion errors). lfilter-free recurrence
        # via the exact FFT-less scan: e[t] = rho*e[t-1] + sqrt(1-rho^2)*w[t]
        rho = float(cfg.noise_ar)
        innov = np.sqrt(1.0 - rho * rho)
        # truncated MA form of the AR(1): e = innov * sum_k rho^k w[t-k];
        # the tail past K is < 1e-6 of the variance for rho <= 0.9
        k_taps = max(1, int(np.ceil(np.log(1e-6) / np.log(max(rho, 1e-9)))))
        kernel = (innov * rho ** np.arange(k_taps)).astype(np.float32)
        eps = np.convolve(eps, kernel)[:total].astype(np.float32)
    signal = level + sigma * eps
    # slow baseline drift: random walk + sine
    if cfg.drift_walk > 0:
        signal += np.cumsum(rng.randn(total).astype(np.float32)) * cfg.drift_walk
    if cfg.drift_sine_amp > 0:
        phase = rng.rand() * 2 * np.pi
        t = np.arange(total, dtype=np.float32)
        signal += cfg.drift_sine_amp * np.sin(
            2 * np.pi * t / cfg.drift_sine_period + phase
        )
    scale = cfg.level_scale * (1.0 + cfg.scale_jitter * rng.randn())
    offset = cfg.level_offset + cfg.level_scale * cfg.offset_jitter * rng.randn()
    signal = (signal * scale + offset).astype(np.float32)
    # trailing samples so windowing never touches the signal end
    tail = np.full(8, signal[-1], np.float32) + rng.randn(8).astype(np.float32)
    signal = np.concatenate([signal, tail])
    return ids_to_seq(ids), starts, dwell.astype(np.int64), signal


def write_signal_label(out_dir: str, name: str, seq: str, starts: np.ndarray,
                       lengths: np.ndarray, signal: np.ndarray) -> None:
    """Write the extraction layout (.signal/.label) a trainer consumes."""
    os.makedirs(out_dir, exist_ok=True)
    sig_int = np.asarray(np.rint(signal), np.int64)
    with open(os.path.join(out_dir, name + ".signal"), "w") as f:
        f.write(" ".join(str(int(x)) for x in sig_int))
    with open(os.path.join(out_dir, name + ".label"), "w") as f:
        ends = starts + lengths
        for s, e, b in zip(starts, ends, seq):
            f.write(f"{s} {e} {b}\n")


def simulate_corpus(
    out_dir: str,
    n_reads: int,
    n_bases: int = 2000,
    seed: int = 0,
    model: Optional[KmerModel] = None,
    cfg: Optional[SimConfig] = None,
    fasta: Optional[str] = None,
) -> None:
    """Write n_reads simulated reads as .signal/.label pairs (+ truth fasta)."""
    model = model or KmerModel.synthetic()
    rng = np.random.RandomState(seed)
    fa = open(fasta, "w") if fasta else None
    for i in range(n_reads):
        seq, starts, lengths, signal = simulate_read(rng, model, n_bases, cfg)
        write_signal_label(out_dir, f"sim{i:05d}", seq, starts, lengths, signal)
        if fa:
            fa.write(f">sim{i:05d}\n{seq}\n")
    if fa:
        fa.close()


def main(argv=None):
    p = argparse.ArgumentParser(description="Simulate nanopore training reads.")
    p.add_argument("-o", "--output", required=True, help="output directory")
    p.add_argument("-n", "--n_reads", type=int, default=100)
    p.add_argument("-b", "--n_bases", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", choices=["dna", "rna"], default="dna")
    p.add_argument("--pore_model", default=None,
                   help="k-mer model TSV (default: synthetic 6-mer model)")
    p.add_argument("--fasta", default=None, help="also write true sequences here")
    args = p.parse_args(argv)
    model = KmerModel.load(args.pore_model) if args.pore_model else KmerModel.synthetic()
    cfg = SimConfig.rna() if args.mode == "rna" else SimConfig()
    simulate_corpus(args.output, args.n_reads, args.n_bases, args.seed, model,
                    cfg, args.fasta)
    print(f"Wrote {args.n_reads} reads to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
