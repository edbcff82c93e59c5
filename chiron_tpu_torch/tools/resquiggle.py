"""Signal<->sequence resquiggling (training-label generation).

The port of ``chiron_tpu/tools/resquiggle.py``: the framework's equivalent
of the reference's vendored cwDTW_nano binary pipeline
(chiron/chiron_label.py:255-277):

  basecalled/reference sequence --pore model--> expected signal levels
  raw signal --z-normalise--> normalised signal
  DTW align --> per-base signal intervals --> Corrected_000 events in fast5

The alignment is the native coarse-to-fine banded DTW of the host library
(``native/dtw.cc``, built by ``ops/host_build.py``) where it builds, else
the numpy implementation of the same pyramid algorithm (``_py_fast_dtw``,
``_py_banded``). The tests hold both to the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chiron_tpu_torch.ops import host_build


# --------------------------------------------------------------------------
# pore model: k-mer -> expected current level
# --------------------------------------------------------------------------

class PoreModel:
    """k-mer level table. Loadable from the standard ONT tsv layout
    (kmer<TAB>level_mean<TAB>level_stdv...), or a synthetic 1-mer default."""

    def __init__(self, levels: dict, k: int, stdvs: Optional[dict] = None):
        self.levels = levels
        self.k = k
        self.stdvs = stdvs

    @classmethod
    def load(cls, path: str) -> "PoreModel":
        levels = {}
        stdvs = {}
        k = 1
        with open(path) as f:
            for line in f:
                if line.startswith("#") or line.startswith("kmer"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    levels[parts[0]] = float(parts[1])
                    k = len(parts[0])
                if len(parts) >= 3:
                    try:
                        stdvs[parts[0]] = float(parts[2])
                    except ValueError:
                        pass
        return cls(levels, k, stdvs or None)

    @classmethod
    def default(cls) -> "PoreModel":
        # synthetic single-base model (z-normalised downstream, so only the
        # relative ordering matters); real runs should load an ONT table
        return cls({"A": 100.0, "C": 200.0, "G": 300.0, "T": 400.0}, 1)

    def _per_base(self, sequence: str, table: dict, default: float):
        n = len(sequence)
        seq = sequence.upper().replace("U", "T")
        out = np.zeros(n, np.float32)
        half = self.k // 2
        for i in range(n):
            kmer = seq[max(0, i - half):max(0, i - half) + self.k]
            if len(kmer) < self.k:
                kmer = (seq[:self.k] if i < half else seq[-self.k:])
            out[i] = table.get(kmer, default)
        return out

    def expected_signal(self, sequence: str) -> np.ndarray:
        """Per-base expected level (centred k-mer window)."""
        return self._per_base(
            sequence, self.levels, float(np.mean(list(self.levels.values())))
        )

    def expected_stdv(self, sequence: str) -> np.ndarray:
        """Per-base level stdv (1.0 when the table has no stdv column)."""
        if not self.stdvs:
            return np.ones(len(sequence), np.float32)
        return self._per_base(
            sequence, self.stdvs, float(np.mean(list(self.stdvs.values())))
        )


def znorm(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    std = np.std(x)
    return (x - np.mean(x)) / (std if std > 0 else 1.0)


# --------------------------------------------------------------------------
# alignment
# --------------------------------------------------------------------------

def _py_fast_dtw(a: np.ndarray, b: np.ndarray, radius: int, min_size: int = 64):
    """Pyramid DTW (the JAX package's numpy fallback of its native DTW).
    Returns (cost, path)."""
    n, m = len(a), len(b)
    if n <= min_size or m <= min_size:
        return _py_banded(a, b, np.zeros(n, np.int64), np.full(n, m, np.int64))
    a2 = 0.5 * (a[: n // 2 * 2:2] + a[1: n // 2 * 2:2])
    b2 = 0.5 * (b[: m // 2 * 2:2] + b[1: m // 2 * 2:2])
    _, coarse = _py_fast_dtw(a2, b2, radius, min_size)
    lo = np.full(n, m, np.int64)
    hi = np.zeros(n, np.int64)
    for ci, cj in coarse:
        for i in (2 * ci, 2 * ci + 1):
            if i < n:
                lo[i] = min(lo[i], max(0, 2 * cj - radius))
                hi[i] = max(hi[i], min(m, 2 * cj + radius + 2))
    last_lo, last_hi = 0, 1
    for i in range(n):
        if lo[i] > hi[i]:
            lo[i], hi[i] = last_lo, last_hi
        lo[i] = min(lo[i], last_hi)
        last_lo, last_hi = lo[i], hi[i]
    hi[n - 1] = m
    lo[n - 1] = min(lo[n - 1], m - 1)
    return _py_banded(a, b, lo, hi)


def _py_banded(a, b, lo, hi):
    n, m = len(a), len(b)
    INF = np.inf
    cost = [dict() for _ in range(n)]
    move = [dict() for _ in range(n)]
    for i in range(n):
        ai = a[i]
        for j in range(lo[i], hi[i]):
            d = (ai - b[j]) ** 2
            if i == 0 and j == 0:
                cost[i][j] = d
                move[i][j] = 0
                continue
            best, mv = INF, 0
            if i > 0 and (j - 1) in cost[i - 1] and cost[i - 1][j - 1] < best:
                best, mv = cost[i - 1][j - 1], 0
            if i > 0 and j in cost[i - 1] and cost[i - 1][j] < best:
                best, mv = cost[i - 1][j], 1
            if (j - 1) in cost[i] and cost[i][j - 1] < best:
                best, mv = cost[i][j - 1], 2
            if best < INF:
                cost[i][j] = best + d
                move[i][j] = mv
    if (m - 1) not in cost[n - 1]:
        return -1.0, []
    path = []
    i, j = n - 1, m - 1
    total = cost[i][j]
    while True:
        path.append((i, j))
        if i == 0 and j == 0:
            break
        mv = move[i][j]
        if mv == 0:
            i, j = i - 1, j - 1
        elif mv == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return total, path


def dtw_distance(a: np.ndarray, b: np.ndarray, radius: int = 50) -> float:
    """Pyramid-DTW cost of aligning two series (``chiron_dtw_distance``
    where the native library runs; -1.0 when no path is found). The numpy
    path sums its path's squared float32 differences in float64, in path
    order, as the native code does."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if len(a) == 0 or len(b) == 0:
        return -1.0
    lib = host_build.load()
    if lib is not None:
        return float(lib.chiron_dtw_distance(a, len(a), b, len(b), radius))
    cost, path = _py_fast_dtw(a, b, radius)
    if cost < 0:
        return -1.0
    i, j = np.asarray(path).T
    return float(np.cumsum(np.square((a[i] - b[j]).astype(np.float64)))[-1])


def resquiggle_signal(
    raw_signal: np.ndarray,
    sequence: str,
    pore_model: Optional[PoreModel] = None,
    radius: int = 50,
    expand: Optional[int] = None,
) -> np.ndarray:
    """Align a raw signal to a base sequence.

    Returns starts [len(sequence)+1]: starts[k] is the first signal sample
    of base k; starts[-1] == len(signal).

    ``expand`` repeats each base's expected level that many times before
    aligning (default: the read's mean dwell, ~len(signal)/len(sequence)),
    so the DTW diagonal has slope ~1 instead of ~dwell — the same
    conditioning trick cwDTW gets from aligning two continuous curves.
    Base k's start is then the start of its first expanded entry.
    """
    pm = pore_model or PoreModel.default()
    levels = pm.expected_signal(sequence)
    signal = znorm(raw_signal)
    m = len(sequence)
    if expand is None:
        expand = int(np.clip(round(len(signal) / max(m, 1)), 1, 50))
    expected = znorm(np.repeat(levels, expand))
    me = m * expand
    lib = host_build.load()
    starts_exp = None
    if lib is not None:
        starts_exp = np.zeros(me + 1, np.int32)
        cost = lib.chiron_resquiggle(np.ascontiguousarray(signal, np.float32), len(signal),
                                     np.ascontiguousarray(expected, np.float32), me, radius,
                                     starts_exp)
        if cost < 0:
            starts_exp = None
    if starts_exp is None:  # numpy path
        _, path = _py_fast_dtw(signal, expected, radius)
        starts_exp = np.full(me + 1, -1, np.int64)
        for i, j in path:
            if starts_exp[j] < 0:
                starts_exp[j] = i
        starts_exp[me] = len(signal)
        for k in range(me - 1, -1, -1):
            if starts_exp[k] < 0:
                starts_exp[k] = starts_exp[k + 1]
        starts_exp[0] = 0
    starts = starts_exp[::expand].astype(np.int32)
    starts[m] = len(signal)
    return starts


def resquiggle_events(
    raw_signal: np.ndarray,
    sequence: str,
    pore_model: Optional[PoreModel] = None,
    radius: int = 100,
) -> np.ndarray:
    """Event-level resquiggle: align detected EVENTS to bases, not samples.

    Sample-level DTW (``resquiggle_signal``) lets single bases absorb long
    sample runs and starves neighbours (measured on the reference's real
    reads: median dwell 10 at true mean 24, 8% zero-dwell bases); aligning
    the level-shift event segmentation (tools/pore_estimate.detect_events)
    to the per-base expected levels instead constrains every boundary to a
    detected level change — the same trick the cwDTW pipeline gets from
    aligning two continuous event curves (chiron/chiron_label.py:255-277).
    Returns starts [len(sequence)+1] in sample coordinates.
    """
    from chiron_tpu_torch.tools.pore_estimate import detect_events

    pm = pore_model or PoreModel.default()
    sig = znorm(raw_signal)
    ev_starts, ev_means = detect_events(sig)
    em = np.asarray(ev_means, np.float32)
    # event means -> base levels, 1 expected entry per base (expand=1)
    starts_ev = resquiggle_signal(
        em, sequence, pore_model=pm, radius=radius, expand=1
    )
    starts = np.asarray(ev_starts, np.int64)[starts_ev].astype(np.int32)
    starts[len(sequence)] = len(raw_signal)
    return starts


def viterbi_segment(
    raw_signal: np.ndarray,
    sequence: str,
    pore_model=None,
    band: int = 1500,
    stdv_floor: float = 0.15,
) -> np.ndarray:
    """Segmental-HMM resquiggle: banded Viterbi with a dwell prior.

    DTW's free stay/skip moves produce pathological segmentations on noisy
    real signal (measured on the reference's example reads: median dwell
    10 at true mean 24, 8% of bases assigned zero samples — see
    ``resquiggle_events``). This models what the signal actually is: base
    k emits a geometric-dwell run of samples at level(k); transitions cost
    ``log p_move``, stays ``log (1-p_move)`` with ``p_move = m/n``, so
    every base consumes >= 1 sample and dwell skew is penalised instead of
    free. DP over [m bases x 2*band samples] around the uniform diagonal,
    vectorised per base row. Emission is a per-kmer Gaussian when the
    model carries stdvs (ONT table layout), unit-variance otherwise.

    Returns starts [len(sequence)+1] in sample coordinates.
    """
    sig = znorm(raw_signal).astype(np.float32)
    n = len(sig)
    m = len(sequence)
    if m < 2 or n < m:
        return np.linspace(0, n, m + 1).astype(np.int32)
    pm = pore_model or PoreModel.default()
    levels = np.asarray(pm.expected_signal(sequence), np.float32)
    lmean, lstd = float(np.mean(levels)), float(np.std(levels) or 1.0)
    levels = (levels - lmean) / lstd
    stdvs = np.full(m, 1.0, np.float32)
    if hasattr(pm, "expected_stdv"):
        stdvs = np.maximum(
            np.asarray(pm.expected_stdv(sequence), np.float32) / lstd,
            stdv_floor,
        )

    p_move = m / n
    move_cost = np.float32(np.log(p_move))
    stay_cost = np.float32(np.log1p(-p_move))

    # band around the uniform diagonal: score[k][j] = best log-prob of
    # bases 0..k consuming samples 0..j-1 with sample j-1 emitted by base
    # k; j constrained to [lo[k], hi[k])
    diag = np.round(np.arange(1, m + 1) * (n / m)).astype(np.int64)
    lo = np.maximum(diag - band, np.arange(1, m + 1))      # >= k+1 samples
    hi = np.minimum(diag + band + 1, n - (m - np.arange(1, m + 1)) + 1)
    np.maximum(hi, lo + 1, out=hi)
    width = int(np.max(hi - lo))

    neg = np.float32(-1e30)
    prev = np.full(width, neg, np.float32)
    # moves[k, i] = 1 iff base k's run STARTS at sample (lo[k]+i)-1
    moves = np.zeros((m, width), np.uint8)
    j0 = np.arange(int(lo[0]), int(hi[0]))
    em0 = -0.5 * ((sig[j0 - 1] - levels[0]) / stdvs[0]) ** 2 - np.log(stdvs[0])
    prev[: len(j0)] = np.cumsum(em0) + stay_cost * (j0 - 1)
    moves[0, 0] = 1  # base 0 starts at sample 0 (j0[0] == 1)
    prev_lo = int(lo[0])
    for k in range(1, m):
        klo, khi = int(lo[k]), int(hi[k])
        w = khi - klo
        j = np.arange(klo, khi)
        em = -0.5 * ((sig[j - 1] - levels[k]) / stdvs[k]) ** 2 - np.log(
            stdvs[k]
        )
        idx = j - 1 - prev_lo
        from_prev = np.where(
            (idx >= 0) & (idx < width), prev[np.clip(idx, 0, width - 1)], neg
        ) + move_cost
        # cur[i] = em[i] + max(from_prev[i], cur[i-1] + stay_cost): a
        # max-plus prefix scan. With E = cumsum(em) and ramp = i*stay_cost:
        # cur[i] = E[i] + ramp[i] + max_{s<=i}(from_prev[s] - E[s-1]
        # - ramp[s])
        ramp = stay_cost * np.arange(w, dtype=np.float32)
        E = np.cumsum(em).astype(np.float32)
        E_prev = np.concatenate([[np.float32(0.0)], E[:-1]])
        cand = from_prev - E_prev - ramp
        run = np.maximum.accumulate(cand)
        moves[k, :w] = cand >= run  # chain start here; tie -> advance
        prev = np.full(width, neg, np.float32)
        prev[:w] = E + ramp + run
        prev_lo = klo
    # backtrack from score[m-1][n] (all samples consumed)
    starts = np.zeros(m + 1, np.int32)
    starts[m] = n
    j = n
    for k in range(m - 1, -1, -1):
        klo = int(lo[k])
        while j > klo and not moves[k, j - klo]:
            j -= 1
        starts[k] = j - 1
        j -= 1
    starts[0] = 0
    return starts


def events_from_starts(starts: np.ndarray, sequence: str):
    """(start, length, base) event rows from base start indices."""
    rows = []
    for k, base in enumerate(sequence):
        rows.append((int(starts[k]), int(starts[k + 1] - starts[k]), base))
    return rows


def write_corrected_events(
    fast5_path: str,
    starts: np.ndarray,
    sequence: str,
    group: str = "Corrected_000",
    subgroup: str = "BaseCalled_template",
) -> None:
    """Write resquiggle results as Corrected events (chiron_label.py:189-213
    write-back parity: the layout chiron's export stage consumes)."""
    import h5py

    data_format = np.dtype(
        [("start", "<i4"), ("length", "<i4"), ("base", "S1")]
    )
    rows = events_from_starts(starts, sequence)
    events = np.asarray(
        [(s, l, b.encode()) for s, l, b in rows], dtype=data_format
    )
    with h5py.File(fast5_path, "r+") as root:
        path = f"/Analyses/{group}/{subgroup}/Events"
        if path in root:
            del root[path]
        ev = root.create_dataset(path, shape=(len(events),), dtype=data_format)
        ev[...] = events
        ev.attrs["read_start_rel_to_raw"] = 0
