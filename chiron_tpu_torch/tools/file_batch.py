"""fast5 -> fixed-record .bin training batches (file_batch equivalent).

Port of ``chiron_tpu/tools/file_batch.py`` (reference: chiron/utils/
file_batch.py): walks resquiggled fast5 files, cuts label-boundary-aligned
windows (``io/binfmt.segment_events``), normalizes, and writes
data_batch_<n>.bin files (struct layout '<1H{L}f1H{L}b') plus a data.meta
descriptor. Needs ``h5py``:

    python -m chiron_tpu_torch.tools.file_batch -i <fast5 dir> -o <out> -l 512 -b 10000
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from chiron_tpu_torch.io.binfmt import segment_events, write_bin, write_meta
from chiron_tpu_torch.io.labels import get_label_raw
from chiron_tpu_torch.io.signal import MEAN, MEDIAN, normalize_signal


def run(args) -> dict:
    root_folder = args.input + os.path.sep
    output_folder = args.output + os.path.sep
    if not os.path.isdir(root_folder):
        raise IOError("Input directory does not found.")
    os.makedirs(output_folder, exist_ok=True)
    batch_idx = 1
    events, event_lengths, labels, label_lengths = [], [], [], []
    success, failed = 0, 0
    norm = {"mean": MEAN, "median": MEDIAN}.get(args.normalization)

    def flush():
        nonlocal batch_idx
        while len(events) >= args.batch:
            write_bin(os.path.join(output_folder, f"data_batch_{batch_idx}.bin"),
                      events[: args.batch], event_lengths[: args.batch],
                      labels[: args.batch], label_lengths[: args.batch])
            for part in (events, event_lengths, labels, label_lengths):
                del part[: args.batch]
            batch_idx += 1

    for base_dir, _, file_list in os.walk(root_folder):
        for file_n in sorted(file_list):
            if not file_n.endswith("fast5"):
                continue
            try:
                (raw_data, raw_label, raw_start, raw_length), _ = get_label_raw(
                    os.path.join(base_dir, file_n), args.basecall_group,
                    args.basecall_subgroup)
            except Exception:  # a file that does not read is counted and skipped
                failed += 1
                continue
            if args.mode == "rna":
                raw_data = raw_data[::-1]
            raw_data = normalize_signal(raw_data, norm)
            ev, evl, lb, lbl = segment_events(raw_data, raw_label, np.asarray(raw_start),
                                              args.length, args.mode)
            events += ev
            event_lengths += evl
            labels += lb
            label_lengths += lbl
            success += 1
            flush()
            if args.max is not None and batch_idx > args.max:
                break
    write_meta(output_folder, args.length, args.batch, args.normalization,
               args.basecall_group, args.basecall_subgroup, args.mode)
    n_batches = batch_idx - 1
    print(f"File batch transfer completed, {n_batches} batches; "
          f"{success} files read, {failed} failed.")
    return {"batches": n_batches, "success": success, "failed": failed,
            "leftover": len(events)}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Transfer fast5 to file batch.")
    parser.add_argument("-i", "--input", required=True,
                        help="Directory that stores the fast5 files.")
    parser.add_argument("-o", "--output", required=True, help="Output folder")
    parser.add_argument("--basecall_group", default="RawGenomeCorrected_000")
    parser.add_argument("--basecall_subgroup", default="BaseCalled_template")
    parser.add_argument("-l", "--length", type=int, default=512,
                        help="Length of the signal segment")
    parser.add_argument("-b", "--batch", type=int, default=10000,
                        help="Number of records in one file.")
    parser.add_argument("-n", "--normalization", default="median",
                        help="'median', 'mean' or 'None'")
    parser.add_argument("-m", "--max", type=int, default=10,
                        help="Maximum number of batch files generated.")
    parser.add_argument("--mode", default="dna", help="dna or rna")
    args = parser.parse_args(argv)
    run(args)


if __name__ == "__main__":
    main(sys.argv[1:])
