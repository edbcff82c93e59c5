"""Remove duplicate records from a fasta/fastq file (last occurrence wins).

A copy of ``chiron_tpu/tools/dedup_fasta.py`` (standard library only), so
that the port imports nothing of the JAX package; the tests hold the two
copies to the same outputs.

Equivalent of the reference's utils/remove_duplicate.py:13-24, which
re-keys records by their full header line so a repeated header keeps only
its final body. Unlike the reference's line-startswith scan, this parses
fastq as proper 4-line records so quality strings beginning with '@' or
'>' cannot be mistaken for headers.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Iterator, List, Tuple


def _iter_records(path: str) -> Iterator[Tuple[str, List[str]]]:
    """Yield (header_line, body_lines) records from a fasta or fastq file."""
    with open(path) as f:
        first = f.readline()
        if not first:
            return
        if first.startswith("@"):  # fastq: strict 4-line records
            header = first.rstrip("\n")
            while True:
                body = [f.readline() for _ in range(3)]
                if not body[2]:
                    raise ValueError(f"{path}: truncated fastq record {header}")
                yield header, [ln.rstrip("\n") for ln in body]
                nxt = f.readline()
                if not nxt:
                    return
                header = nxt.rstrip("\n")
        elif first.startswith(">"):  # fasta: body runs to the next '>'
            header = first.rstrip("\n")
            body: List[str] = []
            for line in f:
                if line.startswith(">"):
                    yield header, body
                    header = line.rstrip("\n")
                    body = []
                else:
                    body.append(line.rstrip("\n"))
            yield header, body
        else:
            raise ValueError(f"{path}: not a fasta/fastq file")


def dedup_fast(in_file: str, out_file: str) -> Tuple[int, int]:
    """Copy in_file to out_file keeping one record per header.

    Returns (records_read, records_written). The last record with a given
    header wins, at its first position — matching the reference's
    OrderedDict overwrite semantics.
    """
    seqs: Dict[str, List[str]] = {}
    n_read = 0
    for header, body in _iter_records(in_file):
        n_read += 1
        seqs[header] = body
    with open(out_file, "w") as out:
        for header, body in seqs.items():
            out.write(header + "\n")
            for line in body:
                out.write(line + "\n")
    return n_read, len(seqs)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Remove records with duplicate headers from a fasta(q) file."
    )
    parser.add_argument("-i", "--input", required=True, help="Input fasta(q) file.")
    parser.add_argument("-o", "--output", required=True, help="Output fasta(q) file")
    args = parser.parse_args(argv)
    n_in, n_out = dedup_fast(args.input, args.output)
    print(f"{n_in} records -> {n_out} unique")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
