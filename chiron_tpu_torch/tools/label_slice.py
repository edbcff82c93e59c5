"""Slice a .signal/.label pair into per-label training rows.

A copy of ``chiron_tpu/tools/label_slice.py`` (standard library only), so
that the port imports nothing of the JAX package; the tests hold the two
copies to the same outputs.

Parity: chiron/utils/cmle_training_preprocess.pl — for every labelled event
(start, end, base) emit one TSV row
``label<TAB>start<TAB>end<TAB>signal_len<TAB>s1,s2,...<TAB>prefix``
containing the raw signal slice, the format the reference's CMLE training
preprocessing consumed.

Usage: python -m chiron_tpu_torch.tools.label_slice <input prefix> <output path>
where <prefix>.signal and <prefix>.label are readable.
"""

from __future__ import annotations

import sys



def slice_labels(prefix: str, out_path: str) -> int:
    """Write one row per label event; returns the row count.

    Signal values are kept as their original text tokens (the perl script
    slices the whitespace-split file verbatim).
    """
    signal = open(prefix + ".signal").read().split()
    n = 0
    with open(prefix + ".label") as labels, open(out_path, "w") as out:
        for line in labels:
            parts = line.split()
            if len(parts) < 3:
                continue
            start, end, label = int(parts[0]), int(parts[1]), parts[2]
            out.write(
                "%s\t%d\t%d\t%d\t%s\t%s\n"
                % (
                    label,
                    start,
                    end,
                    len(signal),
                    ",".join(signal[start:end]),
                    prefix,
                )
            )
            n += 1
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(
            "Usage: python -m chiron_tpu_torch.tools.label_slice "
            "<input path prefix> <output path>\n"
            "where appending prefix with (.signal,.label) are readable paths",
            file=sys.stderr,
        )
        return 1
    slice_labels(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
