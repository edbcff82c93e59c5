"""Genome k-mer model: P(next base | preceding k-mer) from fasta/fastq.

A copy of ``chiron_tpu/tools/genome_model.py`` (numpy only), so that the
port imports nothing of the JAX package; the tests hold the two copies to
the same outputs.

Functional re-design of chiron/utils/gm.py:7-161 — same indexing scheme
(all kmers of length 1..k packed into one table of size 4*(4^k-1)/3) and
JSON persistence, but counting is numpy-vectorised over the sequence via a
rolling base-4 index instead of a python dict walk per position.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


class GenomeModel:
    def __init__(self, k: int = 5, mode: int = 0):
        self.k = k
        self.n = int(4 * (4 ** k - 1) / 3)  # 4^1 + ... + 4^k
        self.base = ["A", "C", "G", "T"] if mode == 0 else ["A", "C", "G", "U"]
        self.kmer_count = np.zeros((self.n, 4), dtype=np.int64)

    # -- index mapping (parity with gm._kmer2idx/_idx2kmer) ----------------
    def kmer2idx(self, kmer: str) -> int:
        idx = 0
        for b_idx, b in enumerate(kmer):
            idx += (self.base.index(b) + 1) * 4 ** b_idx
        return idx - 1

    def idx2kmer(self, idx: int) -> str:
        idx += 1
        kmer = ""
        while idx > 0:
            kmer = self.base[idx % 4 - 1] + kmer
            idx = (idx - 1) // 4
        return kmer

    # -- counting ----------------------------------------------------------
    def count_kmer(self, seq: str) -> None:
        """Count every (kmer, next-base) pair in seq for kmer len 1..k."""
        lookup = np.full(256, -1, np.int64)
        for i, b in enumerate(self.base):
            lookup[ord(b)] = i
        codes = lookup[np.frombuffer(seq.encode(), np.uint8)]
        valid = codes >= 0
        n = len(codes)
        for klen in range(1, self.k + 1):
            if n <= klen:
                break
            # rolling index of the kmer ENDING at position i-1 (preceding
            # the next-base at i), little-endian per reference's kmer2idx:
            # kmer[0] is the most recent base (weight 4^0).
            idx = np.zeros(n - klen, np.int64)
            ok = np.ones(n - klen, bool)
            for j in range(klen):
                # kmer string = seq[i-klen : i] read left-to-right; the
                # j-th (oldest-first) character seq[i-klen+j] carries
                # weight 4^j (reference kmer2idx ordering).
                c = codes[j: n - klen + j]
                idx += (c + 1) * (4 ** j)
                ok &= c >= 0
            nxt = codes[klen:]
            ok &= nxt >= 0
            np.add.at(self.kmer_count, (idx[ok] - 1, nxt[ok]), 1)

    def get_count(self, kmer: str) -> np.ndarray:
        return self.kmer_count[self.kmer2idx(kmer)]

    def prob(self, kmer: str, alpha: float = 1.0) -> np.ndarray:
        """Additive-smoothed P(next base | kmer)."""
        c = self.get_count(kmer).astype(np.float64) + alpha
        return c / c.sum()

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.get_count(key)
        if isinstance(key, (int, slice)):
            return self.kmer_count[key]
        raise TypeError("Key should be a kmer string or int index.")

    # -- persistence (JSON like the reference) -----------------------------
    def save(self, sav_path: str) -> None:
        with open(sav_path, "w+") as f:
            json.dump(
                {
                    "k": self.k,
                    "n": self.n,
                    "base": self.base,
                    "kmer_count": self.kmer_count.tolist(),
                },
                f,
            )

    @classmethod
    def load(cls, model_path: str) -> "GenomeModel":
        with open(model_path) as f:
            d = json.load(f)
        gm = cls(k=d["k"], mode=0 if d["base"][3] == "T" else 1)
        assert gm.n == d["n"]
        gm.kmer_count = np.asarray(d["kmer_count"], np.int64)
        return gm


def read_sequences(path: str):
    """Yield sequences from a fasta or fastq file."""
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            seq = []
            for line in f:
                if line.startswith(">"):
                    if seq:
                        yield "".join(seq)
                        seq = []
                else:
                    seq.append(line.strip())
            if seq:
                yield "".join(seq)
        elif first == "@":
            for i, line in enumerate(f):
                if i % 4 == 1:
                    yield line.strip()


def build(reference_path: str, k: int = 5, mode: int = 0) -> GenomeModel:
    gm = GenomeModel(k=k, mode=mode)
    for seq in read_sequences(reference_path):
        gm.count_kmer(seq.upper())
    return gm


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build a genome k-mer model.")
    parser.add_argument("-i", "--input", required=True, help="fasta/fastq reference")
    parser.add_argument("-o", "--output", required=True, help="output JSON model")
    parser.add_argument("-k", type=int, default=5)
    parser.add_argument("--mode", type=int, default=0, help="0=DNA 1=RNA")
    args = parser.parse_args(argv)
    gm = build(args.input, args.k, args.mode)
    gm.save(args.output)
    print(f"Saved k<={args.k} genome model ({gm.n} kmers) to {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
