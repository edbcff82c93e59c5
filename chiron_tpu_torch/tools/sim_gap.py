"""Sim-vs-real signal-statistics diagnostic (VERDICT r4 #5b).

The bundled models train on tools/simulate.py signal; real-signal skill is
chance-level. Before blaming data scarcity (5 reads), this tool measures
WHICH signal statistics diverge between the simulator's slow-regime config
(the one matching the real reads' translocation speed) and the real example
reads — so the largest divergence can be fixed in the simulator rather than
guessed at.

For every read (real or simulated) the SAME estimator chain runs:

  1. segment: DTW resquiggle of the raw signal against the known sequence
     with the bundled EM pore table (tools/resquiggle.py — the identical
     labeller that produced the round-3/4 bootstrap training labels, so its
     biases cancel in the comparison);
  2. per-read affine: robust LSQ of per-base event medians onto the pore
     table levels -> signal expressed in model (pore-table) units;
  3. statistics:
       dwell        mean/median dwell, P(dwell < 5), geometric-tail fit
       level        sd of (event median - table level) after drift removal
                    = level noise seen by a basecaller, in model sd units
       noise        within-segment sample residual sd + lag-1..4
                    autocorrelation -> effective AR(1) rho
       drift        sd of the smoothed event-residual track + its
                    per-1k-sample random-walk increment
  4. real rows average the 5 example reads; sim rows average simulated
     reads at the DNA_slow training regime (mean_dwell 24, AR 0.7) pushed
     through the SAME chain (not the generative truth — estimator bias
     cancels).

Reference analog: none (the reference trains on externally resquiggled
real reads, chiron/chiron_label.py:255-277, and never needed a simulator).

The port of ``chiron_tpu/tools/sim_gap.py`` (numpy only). It reads the
real reads only from ``--reference DIR`` (the reference Chiron's
``example_data/DNA``: ``output/raw/*.signal`` and ``output/result/*``) and
writes its document to ``--out`` (default ``chiron_tpu_torch/_build/
simgap.json``), never to the repository's ``SIMGAP.json``, the JAX
package's record.

Usage: python -m chiron_tpu_torch.tools.sim_gap --reference DIR [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX package's record, never written here
COMMITTED = os.path.join(REPO, "SIMGAP.json")
DEFAULT_OUT = os.path.join(REPO, "chiron_tpu_torch", "_build", "simgap.json")


def _event_stats(signal: np.ndarray, starts: np.ndarray):
    """Per-base event medians + within-segment residual samples."""
    med = np.empty(len(starts) - 1, np.float64)
    resid = []
    for k in range(len(starts) - 1):
        seg = signal[starts[k]:starts[k + 1]]
        if len(seg) == 0:
            med[k] = np.nan
            continue
        med[k] = np.median(seg)
        if len(seg) >= 3:
            resid.append(seg - med[k])
    return med, (np.concatenate(resid) if resid else np.zeros(0))


def _smooth(x: np.ndarray, w: int) -> np.ndarray:
    w = max(3, min(w | 1, (len(x) - 1) | 1))
    pad = w // 2
    xp = np.pad(x, pad, mode="reflect")
    c = np.cumsum(np.insert(xp, 0, 0.0))
    return (c[w:] - c[:-w]) / w


def read_statistics(signal: np.ndarray, sequence: str, pore) -> dict:
    """One read through the full estimator chain (see module docstring)."""
    from chiron_tpu_torch.tools.resquiggle import resquiggle_signal

    starts = resquiggle_signal(np.asarray(signal, np.float32), sequence,
                               pore_model=pore, radius=50)
    dwell = np.diff(starts).astype(np.float64)
    exp_level = pore.expected_signal(sequence)

    med, _ = _event_stats(np.asarray(signal, np.float64), starts)
    ok = ~np.isnan(med)
    # robust affine: two LSQ passes with outlier rejection (mis-segmented
    # bases otherwise dominate)
    scale, offset = 1.0, 0.0
    keep = ok.copy()
    for _ in range(2):
        A = np.stack([exp_level[keep], np.ones(keep.sum())], 1)
        scale, offset = np.linalg.lstsq(A, med[keep], rcond=None)[0]
        r = med - (scale * exp_level + offset)
        mad = np.median(np.abs(r[keep])) + 1e-9
        keep = ok & (np.abs(r) < 5 * 1.4826 * mad)
    y = (np.asarray(signal, np.float64) - offset) / max(scale, 1e-9)
    med_m = (med - offset) / max(scale, 1e-9)            # model units
    table_sd = float(pore_sd(pore))

    # drift: smoothed event-median residual vs the table level
    ev_resid = np.where(ok, med_m - exp_level, 0.0)
    drift = _smooth(ev_resid, 51)
    level_noise = np.std((ev_resid - drift)[keep])

    # within-segment residuals in model units, drift removed by the median
    _, resid = _event_stats(y, starts)
    ac = []
    r0 = float(np.mean(resid ** 2)) + 1e-12
    for lag in (1, 2, 3, 4):
        ac.append(float(np.mean(resid[lag:] * resid[:-lag]) / r0))

    # drift as a function of SAMPLE time (walk-rate units of simulate.py)
    mid = ((starts[:-1] + starts[1:]) // 2)[ok]
    dr_t = np.interp(np.arange(0, int(starts[-1]), 1000), mid, drift[ok])
    inc = np.diff(dr_t)

    return {
        "n_bases": int(len(sequence)),
        "dwell_mean": float(dwell.mean()),
        "dwell_median": float(np.median(dwell)),
        "dwell_p_lt5": float(np.mean(dwell < 5)),
        "dwell_cv": float(dwell.std() / max(dwell.mean(), 1e-9)),
        "level_noise_sd": float(level_noise),
        "sample_noise_sd": float(np.sqrt(r0)),
        "noise_ac1": ac[0], "noise_ac2": ac[1],
        "noise_ac3": ac[2], "noise_ac4": ac[3],
        "drift_sd": float(np.std(drift[ok])),
        "drift_walk_per_1k": float(np.std(inc)) if len(inc) > 2 else 0.0,
        "table_sd_mean": table_sd,
        "affine_scale": float(scale),
    }


def pore_sd(pore) -> float:
    vals = np.asarray(list(pore.stdvs.values()) if isinstance(pore.stdvs, dict)
                      else pore.stdvs, np.float64)
    return float(vals.mean()) if len(vals) else 0.0


def _avg(rows):
    keys = rows[0].keys()
    return {k: (float(np.mean([r[k] for r in rows]))
                if isinstance(rows[0][k], float) else rows[0][k])
            for k in keys}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reference", required=True,
                   help="the reference Chiron's example_data/DNA directory")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="where to write the document (never the repository's "
                        "SIMGAP.json)")
    p.add_argument("--sim_reads", type=int, default=5)
    p.add_argument("--mean_dwell", type=float, default=24.0)
    p.add_argument("--noise_ar", type=float, default=0.7)
    args = p.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(COMMITTED):
        raise ValueError(f"{COMMITTED} is the JAX package's record; pass another --out")

    from chiron_tpu_torch.cli import MODEL_ROOT
    from chiron_tpu_torch.tools.assess import _read_fastx
    from chiron_tpu_torch.tools.resquiggle import PoreModel
    from chiron_tpu_torch.tools.simulate import KmerModel, SimConfig, simulate_read

    pore_path = os.path.join(MODEL_ROOT, "DNA_default", "pore_model.tsv")
    pore = PoreModel.load(pore_path)

    golden = os.path.join(args.reference, "output", "result")
    raw = os.path.join(args.reference, "output", "raw")
    seqs = {}
    for fn in sorted(os.listdir(golden)):
        seqs.update(_read_fastx(os.path.join(golden, fn)))
    real_rows = {}
    for name in sorted(seqs):
        sig = np.loadtxt(os.path.join(raw, name + ".signal"),
                         dtype=np.float32).ravel()
        real_rows[name] = read_statistics(sig, seqs[name], pore)
        print(f"real {name}: {json.dumps(real_rows[name])}", flush=True)

    km = KmerModel.load(pore_path)
    cfg = SimConfig(mean_dwell=args.mean_dwell, max_dwell=140,
                    noise_ar=args.noise_ar)
    rng = np.random.RandomState(771)  # disjoint from train/holdout seeds
    n_bases = int(np.mean([r["n_bases"] for r in real_rows.values()]))
    sim_rows = []
    for i in range(args.sim_reads):
        seq, _st, _dw, sig = simulate_read(rng, km, n_bases, cfg)
        sim_rows.append(read_statistics(sig, seq, pore))
        print(f"sim read {i}: {json.dumps(sim_rows[-1])}", flush=True)

    real_avg = _avg(list(real_rows.values()))
    sim_avg = _avg(sim_rows)
    gap = {k: round(real_avg[k] - sim_avg[k], 4)
           for k in real_avg if isinstance(real_avg[k], float)}
    out = {
        "estimator": "shared DTW-resquiggle chain (biases cancel)",
        "sim_config": f"mean_dwell={args.mean_dwell} max_dwell=140 "
                      f"noise_ar={args.noise_ar}",
        "real_per_read": real_rows,
        "real_mean": real_avg,
        "sim_mean": sim_avg,
        "real_minus_sim": gap,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")
    for k in sorted(gap):
        print(f"  {k:>20}: real {real_avg[k]:9.4f}  sim {sim_avg[k]:9.4f}  "
              f"gap {gap[k]:+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
