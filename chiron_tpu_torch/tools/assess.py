"""Basecall accuracy assessment: identity / error-rate analysis.

A copy of ``chiron_tpu/tools/assess.py`` (numpy only), so that the port's
accuracy and benchmark entry points import nothing of the JAX package;
the tests hold the two copies to the same outputs.

Self-contained replacement for the reference's external toolchain
(chiron/utils/assess.sh: graphmap align -> samtools -> japsa
jsa.hts.errorAnalysis): called reads are globally aligned to their
references with the framework's affine-gap aligner and per-read + aggregate
identity, mismatch, insertion and deletion rates are reported. For long
reads the alignment runs banded around the diagonal for linear-ish time.

Usage:
  python -m chiron_tpu_torch.tools.assess -i result/ -r reference_dir_or_fasta
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np


def _read_fastx(path: str) -> Dict[str, str]:
    """name -> sequence for a fasta/fastq file."""
    seqs: Dict[str, str] = {}
    with open(path) as f:
        text = f.read()
    if not text:
        return seqs
    if text[0] == ">":
        name = None
        parts: list = []
        for line in text.splitlines():
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(parts)
                name = line[1:].split()[0]
                parts = []
            else:
                parts.append(line.strip())
        if name is not None:
            seqs[name] = "".join(parts)
    elif text[0] == "@":
        lines = text.splitlines()
        for i in range(0, len(lines) - 1, 4):
            seqs[lines[i][1:].split()[0]] = lines[i + 1].strip()
    return seqs


def banded_global_align(
    a: str, b: str, band: Optional[int] = None,
    match: int = 1, mismatch: int = -3, gap_open: int = -5, gap_extend: int = -2,
) -> Tuple[int, int, int, int]:
    """Affine-gap global alignment statistics inside a diagonal band.

    Returns (matches, mismatches, insertions, deletions) where insertions
    are bases in ``a`` (the called read) absent from ``b`` (the reference).
    """
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return 0, 0, n, m
    if band is None:
        band = max(64, abs(n - m) + 64)
    av = np.frombuffer(a.encode(), np.uint8)
    bv = np.frombuffer(b.encode(), np.uint8)
    neg = -(1 << 30)
    width = 2 * band + 1
    # DP over diagonals: col j in [i - band + off0, ...]; store M/X/Y rows
    M = np.full(width, neg, np.int64)
    X = np.full(width, neg, np.int64)
    Y = np.full(width, neg, np.int64)
    # pointers packed: 2 bits per state per cell per row
    ptrM = np.zeros((n + 1, width), np.int8)
    ptrX = np.zeros((n + 1, width), np.int8)
    ptrY = np.zeros((n + 1, width), np.int8)

    def col_range(i):
        lo = max(0, i - band)
        hi = min(m, i + band) + 1
        return lo, hi

    # row 0
    lo0, hi0 = col_range(0)
    M[0 - lo0 + 0] = 0  # j=0
    js = np.arange(1, hi0)
    Y[js - lo0] = gap_open + gap_extend * js
    ptrY[0, js[js > 1] - lo0] = 2
    prevM, prevX, prevY, prev_lo = M.copy(), X.copy(), Y.copy(), lo0
    karange = np.arange(width)
    # each row is one batch of vector ops: X and M read the previous row at
    # band offset ``sh`` (0 while the band's left edge sits at column 0, then
    # 1 once it slides), and the in-row Y chain Y[k] = max(M[k-1]+open,
    # Y[k-1]+ext) unrolls to a running maximum over M[j'] + open - ext*j'
    # (scores are small integers, so the reassociation is exact)
    for i in range(1, n + 1):
        lo, hi = col_range(i)
        sh = lo - prev_lo
        nk = hi - lo
        valid = karange < nk
        M = np.full(width, neg, np.int64)
        X = np.full(width, neg, np.int64)
        Y = np.full(width, neg, np.int64)
        # X: consume a[i-1] (gap in reference -> insertion), from prev row
        pm = prevM[sh:] if sh else prevM
        px = prevX[sh:] if sh else prevX
        nx = len(pm)
        xo = pm + (gap_open + gap_extend)
        xe = px + gap_extend
        X[:nx] = np.where(valid[:nx], np.maximum(xo, xe), neg)
        ptrX[i, :nx] = np.where(valid[:nx], (xe > xo).view(np.int8), 0)
        ptrX[i, nx:] = 0
        # M: diagonal from prev row (j - 1 -> band offset k + sh - 1)
        d0 = sh - 1 + max(0, 1 - lo)  # prev index for the first j >= 1
        k0 = max(0, 1 - lo)           # first k with j >= 1
        if d0 < 0:
            d0, k0 = d0 + 1, k0 + 1
        pd_m, pd_x, pd_y = prevM[d0:], prevX[d0:], prevY[d0:]
        nd = min(len(pd_m), width - k0)
        cands = np.stack([pd_m[:nd], pd_x[:nd], pd_y[:nd]])
        kk = np.argmax(cands, axis=0)
        best = np.take_along_axis(cands, kk[None], 0)[0]
        ok = valid[k0:k0 + nd] & (best > neg)
        jcols = lo + karange[k0:k0 + nd]
        # columns past the band edge are masked by ``ok``; clamp their index
        sub = np.where(av[i - 1] == bv[np.minimum(jcols - 1, m - 1)],
                       match, mismatch)
        M[k0:k0 + nd] = np.where(ok, best + sub, neg)
        ptrM[i, k0:k0 + nd] = np.where(ok, kk.astype(np.int8), 0)
        ptrM[i, :k0] = 0
        ptrM[i, k0 + nd:] = 0
        # Y: in-row scan. t[k] = best chain start at column k (M[k] + open
        # - ext*k, with the neg Y[0] chain as floor), Y[k] = run_max + ext*k
        if nk > 1:
            t = M[:nk - 1] + gap_open - gap_extend * karange[:nk - 1]
            t[0] = max(t[0], neg)  # the Y[k=0] = neg extension chain
            run = np.maximum.accumulate(t)
            ycand = run + gap_extend * karange[1:nk]
            Y[1:nk] = np.where(valid[1:nk], ycand, neg)
            ext_wins = Y[:nk - 1] + gap_extend > M[:nk - 1] + (
                gap_open + gap_extend
            )
            ptrY[i, 1:nk] = np.where(ext_wins, np.int8(2), np.int8(0))
            ptrY[i, 0] = 0
            ptrY[i, nk:] = 0
        prevM, prevX, prevY, prev_lo = M, X, Y, lo
    lo, hi = col_range(n)
    k = m - lo
    if not (0 <= k < width):
        return 0, 0, n, m  # band exceeded: count as all-error
    state = int(np.argmax((M[k], X[k], Y[k])))
    # traceback
    i, j = n, m
    matches = mismatches = insertions = deletions = 0
    while i > 0 or j > 0:
        lo_i = max(0, i - band)
        k = j - lo_i
        if state == 0 and i > 0 and j > 0:
            if av[i - 1] == bv[j - 1]:
                matches += 1
            else:
                mismatches += 1
            state = int(ptrM[i, k])
            i -= 1
            j -= 1
        elif state == 1 and i > 0:
            insertions += 1
            state = 0 if ptrX[i, k] == 0 else 1
            i -= 1
        elif j > 0:
            deletions += 1
            state = 0 if ptrY[i, k] == 0 else 2
            j -= 1
        else:
            insertions += i
            break
    return matches, mismatches, insertions, deletions


def kmer_hit_rate(called: str, reference: str, k: int = 11) -> float:
    """Fraction of the called read's k-mers present in the reference.

    The global-alignment identity of a RANDOM same-length 4-letter
    sequence is ~0.52 (free mismatch pairing), so identity alone cannot
    distinguish weak basecalls from noise. An 11-mer from a random caller
    hits a 10kb reference with probability ~10kb/4^11 = 0.002 — this
    statistic is ~0 for junk and rises only with genuine local accuracy
    (analogous to the seed-hit rate of the reference's graphmap assessment
    stage, chiron/utils/assess.sh:15).
    """
    if len(called) < k or len(reference) < k:
        return 0.0
    ref_kmers = {reference[i:i + k] for i in range(len(reference) - k + 1)}
    n = len(called) - k + 1
    hits = sum(1 for i in range(n) if called[i:i + k] in ref_kmers)
    return hits / n


def _canon(seq: str) -> str:
    """Canonical scoring alphabet: uppercase, U -> T.

    RNA-mode basecalls are written with U (io/writers.py:44-45, parity with
    chiron/chiron_eval.py:204-205) while references/truth fastas use T; an
    alphabet-sensitive aligner would score every U as a mismatch (~25% of
    bases), burying all genuine skill below the random-identity floor —
    exactly the round-3 synthetic_rna "skill 0.00" artifact.
    """
    return seq.upper().replace("U", "T")


def assess_read(called: str, reference: str, band: Optional[int] = None) -> dict:
    called = _canon(called)
    reference = _canon(reference)
    ma, mi, ins, de = banded_global_align(called, reference, band)
    ref_len = len(reference)
    return {
        "matches": ma,
        "mismatches": mi,
        "insertions": ins,
        "deletions": de,
        "identity": ma / max(ref_len, 1),
        "error_rate": (mi + ins + de) / max(ref_len, 1),
        "called_len": len(called),
        "ref_len": ref_len,
        "kmer11_hit_rate": kmer_hit_rate(called, reference),
    }


def assess_dir(result_dir: str, reference: str, band: Optional[int] = None) -> dict:
    """Assess every called read in result_dir against its reference.

    ``reference`` may be a directory of per-read <name>_ref.fastq files (the
    extraction layout) or a single fasta/fastq keyed by read name.
    """
    refs: Dict[str, str] = {}
    if os.path.isdir(reference):
        for f in os.listdir(reference):
            seqs = _read_fastx(os.path.join(reference, f))
            for name, seq in seqs.items():
                refs[name] = seq
            if len(seqs) == 1 and f.endswith("_ref.fastq"):
                refs[f[: -len("_ref.fastq")]] = next(iter(seqs.values()))
    else:
        refs = _read_fastx(reference)
    rows = {}
    for f in sorted(os.listdir(result_dir)):
        if not (f.endswith(".fastq") or f.endswith(".fasta")):
            continue
        called_seqs = _read_fastx(os.path.join(result_dir, f))
        for name, called in called_seqs.items():
            ref = refs.get(name) or refs.get(os.path.splitext(f)[0])
            if ref is None:
                continue
            rows[name] = assess_read(called, ref, band)
    return {"reads": rows, "summary": summarize_rows(rows)}


def summarize_rows(rows: Dict[str, dict]) -> dict:
    """Aggregate per-read assess_read rows into the standard summary block
    (shared by assess_dir and the oracle decoder, tools/oracle.py)."""
    totals = {"matches": 0, "mismatches": 0, "insertions": 0, "deletions": 0,
              "ref_len": 0}
    for row in rows.values():
        for key in totals:
            totals[key] += row[key]
    ref_total = max(totals["ref_len"], 1)
    called_total = sum(r["called_len"] for r in rows.values())
    kmer11 = (
        sum(r["kmer11_hit_rate"] * r["called_len"] for r in rows.values())
        / max(called_total, 1)
    )
    identity = totals["matches"] / ref_total
    # identity of a random same-length caller under this aligner is ~0.52
    # (forced mismatch pairing); "skill" rescales so 0 = noise, 1 = perfect
    return {
        "n_reads": len(rows),
        "identity": identity,
        "skill": max(0.0, (identity - RANDOM_IDENTITY) / (1 - RANDOM_IDENTITY)),
        "kmer11_hit_rate": kmer11,
        "mismatch_rate": totals["mismatches"] / ref_total,
        "insertion_rate": totals["insertions"] / ref_total,
        "deletion_rate": totals["deletions"] / ref_total,
        "error_rate": (totals["mismatches"] + totals["insertions"] + totals["deletions"]) / ref_total,
    }


# measured on random same-length 4-letter pairs through banded_global_align
# (1k/2.5k bases: 0.522/0.527); see kmer_hit_rate docstring
RANDOM_IDENTITY = 0.525


def main(argv=None):
    parser = argparse.ArgumentParser(description="Basecall accuracy assessment.")
    parser.add_argument("-i", "--input", required=True,
                        help="result/ dir of called fastq/fasta files")
    parser.add_argument("-r", "--reference", required=True,
                        help="reference dir (extraction layout) or fasta/fastq")
    parser.add_argument("--band", type=int, default=None,
                        help="alignment band radius (default: auto)")
    args = parser.parse_args(argv)
    out = assess_dir(args.input, args.reference, args.band)
    s = out["summary"]
    print(f"reads assessed: {s['n_reads']}")
    print(f"identity:       {s['identity']:.4f}")
    print(f"mismatch rate:  {s['mismatch_rate']:.4f}")
    print(f"insertion rate: {s['insertion_rate']:.4f}")
    print(f"deletion rate:  {s['deletion_rate']:.4f}")
    print(f"error rate:     {s['error_rate']:.4f}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
