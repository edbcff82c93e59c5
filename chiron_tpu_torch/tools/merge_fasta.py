"""Merge per-read fasta outputs into one multi-sequence fasta.

A copy of ``chiron_tpu/tools/merge_fasta.py`` (standard library only), so
that the port imports nothing of the JAX package; the tests hold the two
copies to the same outputs.

Equivalent of the reference's utils/merge.sh:1-21: every <name>.fasta in
the input folder contributes one record named ``sequenceN <name>`` holding
its last (sequence) line.
"""

from __future__ import annotations

import argparse
import os
import sys


def merge_fasta(input_folder: str, output_file: str) -> int:
    """Returns the number of merged records."""
    out_dir = os.path.dirname(os.path.abspath(output_file))
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(output_file, "w") as out:
        for fname in sorted(os.listdir(input_folder)):
            if not fname.endswith(".fasta"):
                continue
            with open(os.path.join(input_folder, fname)) as f:
                lines = [ln.rstrip("\n") for ln in f if ln.strip()]
            if not lines:
                continue
            n += 1
            seq_name = os.path.splitext(fname)[0]
            out.write(f">sequence{n} {seq_name}\n{lines[-1]}\n\n")
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge the fasta files in <input_folder> into <output_file>."
    )
    parser.add_argument("input_folder")
    parser.add_argument("output_file")
    args = parser.parse_args(argv)
    n = merge_fasta(args.input_folder, args.output_file)
    print(f"Merged {n} sequences into {args.output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
