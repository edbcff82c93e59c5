"""`chiron export`: resquiggled fast5 -> .signal + .label training pairs.

Port of ``chiron_tpu/tools/raw_extract.py`` (reference: chiron/utils/raw.py:
45-148): walks the input tree, reads corrected events with
``get_label_raw``, writes newline-delimited .signal and "start end base"
.label files into numbered batch subfolders, counts the error kinds,
optionally rescales to pA units and reverses RNA signal. ``--tffile`` also
bundles the reads into one TFRecord (the port's ``io/tfrecord.py``). Needs
``h5py``. Unlike the JAX copy, each run closes its ``raw.log`` handler at
its end, so a later run in the same process does not write into an earlier
run's log.
"""

from __future__ import annotations

import logging
import os
from collections import Counter

from chiron_tpu_torch.io.fast5 import rescale_to_pa
from chiron_tpu_torch.io.labels import get_label_raw

SUCCEED_TAG = "succeed"
logger = logging.getLogger("chiron_tpu_torch.export")


def _set_logger(log_file: str) -> logging.Handler:
    handler = logging.FileHandler(log_file, mode="a+")
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.propagate = False
    logger.setLevel(logging.INFO)
    return handler


def _make_batch_folder(root_f: str, batch_i: int) -> str:
    batch_folder = os.path.join(root_f, str(batch_i))
    os.makedirs(batch_folder, exist_ok=True)
    return batch_folder


def extract_file(input_file: str, flags):
    """One fast5 -> (state, (signal, label rows), channel calibration)."""
    try:
        raw_info, channel_info = get_label_raw(input_file, flags.basecall_group,
                                               flags.basecall_subgroup)
        raw_data, raw_label, raw_start, raw_length = raw_info
        offset, range_s, digitisation = channel_info
    except Exception as e:  # every failure kind is counted by its message
        return str(e), (None, None), (None, None, None)
    raw_data_array = []
    for index, start in enumerate(raw_start):
        raw_data_array.append(
            [start, start + raw_length[index], raw_label["base"][index].decode()])
    if flags.mode == "rna":
        raw_data = raw_data[::-1]
    if len(raw_data_array) > flags.min_bps:
        return SUCCEED_TAG, (raw_data, raw_data_array), (offset, digitisation, range_s)
    return "Read has too few nucleotides output", (None, None), (None, None, None)


def extract(root_folder: str, output_folder: str, flags,
            tf_reads: list | None = None) -> Counter:
    run_record: Counter = Counter()
    batch_i = 1
    if not os.path.isdir(root_folder):
        raise IOError("Input directory does not found.")
    batch_folder = _make_batch_folder(output_folder, batch_i)
    for dir_n, _, file_list in os.walk(root_folder):
        for file_n in sorted(file_list):
            if not file_n.endswith("fast5"):
                continue
            file_prefix = file_n.split(".")[0]
            full_path = os.path.join(dir_n, file_n)
            state, (raw_data, raw_data_array), (offset, digitisation, range_s) = (
                extract_file(full_path, flags))
            run_record[state] += 1
            if run_record[SUCCEED_TAG] > batch_i * flags.batch:
                batch_i += 1
                batch_folder = _make_batch_folder(output_folder, batch_i)
            if state == SUCCEED_TAG:
                if tf_reads is not None:
                    # the TFRecord stores the DIGITAL int16 signal
                    # (chiron_input.py:26), taken before any pA rescale
                    tf_reads.append((file_prefix, raw_data,
                                     [(r[0], r[1], r[2]) for r in raw_data_array]))
                if flags.unit:
                    raw_data = rescale_to_pa(raw_data, offset, range_s, digitisation)
                with open(os.path.join(batch_folder, file_prefix + ".signal"), "w+") as f:
                    f.write("\n".join(str(x) for x in raw_data))
                with open(os.path.join(batch_folder, file_prefix + ".label"), "w+") as f:
                    for label in raw_data_array:
                        f.write(" ".join(str(x) for x in label))
                        f.write("\n")
                logger.info("%s file transfered.", full_path)
            else:
                logger.error("FAIL on %s file, because of error %s.", full_path, state)
    return run_record


def run(args) -> Counter:
    dirs = args.input.split(",")
    for root_folder in dirs:
        if not os.path.isdir(root_folder):
            raise IOError(f"Input directory {root_folder} does not found.")
    output_folder = args.output + os.path.sep
    os.makedirs(output_folder, exist_ok=True)
    handler = _set_logger(os.path.join(output_folder, "raw.log"))
    try:
        total: Counter = Counter()
        # --tffile: also bundle the extracted reads into one TFRecord (the
        # reference declares the flag, entry.py:99, but never implements it).
        # Reads are buffered in memory.
        tffile = getattr(args, "tffile", None)
        tf_reads: list | None = [] if tffile else None
        for directory in dirs:
            total += extract(directory + os.path.sep, output_folder, args, tf_reads=tf_reads)
    finally:
        logger.removeHandler(handler)
        handler.close()
    if tffile and tf_reads is not None:
        from chiron_tpu_torch.io.tfrecord import write_training_tfrecord

        write_training_tfrecord(os.path.join(output_folder, tffile), tf_reads)
        print(f"Wrote {len(tf_reads)} reads to {tffile}.")
    errors = [(k, v) for k, v in total.most_common() if k != SUCCEED_TAG]
    print(f"Extracted {total[SUCCEED_TAG]} reads; {sum(v for _, v in errors)} failures.")
    for kind, count in errors[: getattr(args, "n_errors", 5)]:
        print(f"  {count} x {kind}")
    return total
