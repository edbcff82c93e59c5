"""Call-time extraction: fast5 -> output/raw/*.signal (+ reference/).

A copy of ``chiron_tpu/tools/extract_sig.py`` (parity with
chiron/utils/extract_sig_ref.py:31-145): walks the input tree,
extracts raw signal (and any embedded basecall/alignment reference) from
single- or multi-read fast5 files in a multiprocessing pool, writes
newline-delimited .signal files into <output>/raw/ and references into
<output>/reference/. Errors are logged per-file to <output>/log/extract.log.
"""

from __future__ import annotations

import logging
import os
from multiprocessing import Pool, cpu_count

from chiron_tpu_torch.io.fast5 import iter_fast5_reads

logger = logging.getLogger("chiron_tpu_torch.extract")


def _set_logger(log_file: str) -> None:
    handler = logging.FileHandler(log_file)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.propagate = False
    logger.setLevel(logging.INFO)


def extract_file_worker(args) -> int:
    full_file_n, flags_dict = args
    file_n = os.path.basename(full_file_n)
    if not full_file_n.endswith("fast5"):
        return 0
    count = 0
    try:
        for suffix, signal, reference, read_id in iter_fast5_reads(
            full_file_n,
            mode=flags_dict["mode"],
            unit=flags_dict["unit"],
            polya=flags_dict["polya_pair"],
        ):
            if signal is None or len(signal) == 0:
                raise ValueError("Got empty raw signal")
            if flags_dict["idname"] and read_id:
                base = read_id
            else:
                base = os.path.splitext(file_n)[0] + suffix
            sig_path = os.path.join(flags_dict["raw_folder"], base + ".signal")
            with open(sig_path, "w+") as f:
                f.write(flags_dict["delimiter"].join(str(v) for v in signal))
            if reference:
                ref_path = os.path.join(
                    flags_dict["ref_folder"],
                    os.path.splitext(file_n)[0] + "_ref.fastq",
                )
                with open(ref_path, "w+") as f:
                    f.write(reference)
            count += 1
    except Exception as e:  # per-file fault tolerance (reference parity)
        logger.error("Cannot extract file %s. %s", full_file_n, e)
        return 0
    return count


def extract(flags) -> int:
    """Extract every fast5 under flags.input_dir. Returns read count."""
    root_folder = flags.input_dir
    out_folder = flags.output_dir
    if not os.path.isdir(root_folder):
        raise IOError("Input directory does not found.")
    os.makedirs(out_folder, exist_ok=True)
    raw_folder = os.path.abspath(os.path.join(out_folder, "raw"))
    ref_folder = os.path.abspath(os.path.join(out_folder, "reference"))
    log_folder = os.path.abspath(os.path.join(out_folder, "log"))
    for d in (raw_folder, ref_folder, log_folder):
        os.makedirs(d, exist_ok=True)
    _set_logger(os.path.join(log_folder, "extract.log"))

    polya_pair = None
    if getattr(flags, "polya", None):
        polya_pair = {}
        with open(flags.polya) as f:
            for line in f:
                parts = line.split(",")
                polya_pair[(os.path.basename(parts[0]), parts[1])] = int(parts[2])

    flags_dict = {
        "mode": flags.mode,
        "unit": getattr(flags, "unit", False),
        "idname": getattr(flags, "idname", False),
        "delimiter": getattr(flags, "delimiter", "\n"),
        "polya_pair": polya_pair,
        "raw_folder": raw_folder,
        "ref_folder": ref_folder,
    }

    file_args = []
    if getattr(flags, "recursive", True):
        for dirpath, _, filenames in os.walk(root_folder):
            for f in filenames:
                file_args.append((os.path.join(dirpath, f), flags_dict))
    else:
        for f in os.listdir(root_folder):
            file_args.append((os.path.join(root_folder, f), flags_dict))

    threads = getattr(flags, "threads", 0) or cpu_count()
    total = 0
    if threads <= 1 or len(file_args) <= 1:
        for a in file_args:
            total += extract_file_worker(a)
    else:
        with Pool(min(threads, len(file_args))) as pool:
            for n in pool.imap_unordered(extract_file_worker, file_args):
                total += n
    return total
