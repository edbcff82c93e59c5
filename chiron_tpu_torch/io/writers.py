"""Output writers: fastq/fasta results, segment files, timing meta files.

Format parity with chiron/chiron_eval.py:176-242 (write_output): the
``result/<read>.fastq``, ``segments/<read>.fastq`` and ``meta/<read>.meta``
layouts are byte-compatible so downstream assessment tooling keeps working.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence


def ensure_output_dirs(output: str) -> None:
    for sub in ("", "segments", "result", "meta"):
        path = os.path.join(output, sub)
        if not os.path.exists(path):
            os.makedirs(path)


def write_output(
    segments: Sequence[str],
    consensus: str,
    time_list,
    file_pre: str,
    global_setting,
    concise: bool = False,
    suffix: str = "fasta",
    seg_q_score: Optional[Sequence[str]] = None,
    q_score: Optional[str] = None,
) -> None:
    """Write one read's consensus (+ segments + meta).

    ``global_setting`` carries the run flags (output dir, mode, batch_size,
    segment_len, jump, start, input, model) — same contract as the
    reference's FLAGS object.
    """
    start_time, reading_time, basecall_time, assembly_time = time_list
    result_folder = os.path.join(global_setting.output, "result")
    seg_folder = os.path.join(global_setting.output, "segments")
    meta_folder = os.path.join(global_setting.output, "meta")
    path_con = os.path.join(result_folder, file_pre + "." + suffix)
    if global_setting.mode == "rna":
        consensus = consensus.replace("T", "U").replace("t", "u")
    if not concise:
        path_reads = os.path.join(seg_folder, file_pre + "." + suffix)
        path_meta = os.path.join(meta_folder, file_pre + ".meta")
    with open(path_con, "w+") as out_con:
        if not concise:
            with open(path_reads, "w+") as out_f:
                for indx, read in enumerate(segments):
                    out_f.write(">{}{}\n{}\n".format(file_pre, str(indx), read))
                    if (suffix == "fastq") and (seg_q_score is not None):
                        out_f.write(
                            "@{}{}\n{}\n+\n{}\n".format(
                                file_pre, str(indx), read, seg_q_score[indx]
                            )
                        )
        if (suffix == "fastq") and (q_score is not None):
            out_con.write("@{}\n{}\n+\n{}\n".format(file_pre, consensus, q_score))
        else:
            out_con.write(">{}\n{}".format(file_pre, consensus))
    if not concise:
        with open(path_meta, "w+") as out_meta:
            total_time = time.time() - start_time
            output_time = total_time - assembly_time
            assembly_time -= basecall_time
            basecall_time -= reading_time
            total_len = len(consensus)
            total_time = time.time() - start_time
            out_meta.write(
                "# Reading Basecalling assembly output total rate(bp/s)\n"
            )
            out_meta.write(
                "%5.3f %5.3f %5.3f %5.3f %5.3f %5.3f\n"
                % (
                    reading_time,
                    basecall_time,
                    assembly_time,
                    output_time,
                    total_time,
                    total_len / total_time,
                )
            )
            out_meta.write("# read_len batch_size segment_len jump start_pos\n")
            out_meta.write(
                "%d %d %d %d %d\n"
                % (
                    total_len,
                    global_setting.batch_size,
                    global_setting.segment_len,
                    global_setting.jump,
                    global_setting.start,
                )
            )
            out_meta.write("# input_name model_name\n")
            out_meta.write("%s %s\n" % (global_setting.input, global_setting.model))


def write_run_meta(output: str, input_path: str, time_dict: dict) -> None:
    """Append whole-run wall/sys/user times (chiron/chiron_eval.py:535-544)."""
    meta_folder = os.path.join(output, "meta")
    if os.path.isdir(input_path):
        file_pre = "all"
    else:
        file_pre = os.path.splitext(os.path.basename(input_path))[0]
    path_meta = os.path.join(meta_folder, file_pre + ".meta")
    with open(path_meta, "a+") as out_meta:
        out_meta.write("# Wall_time Sys_time User_time Cpu_time\n")
        out_meta.write(
            "%5.3f %5.3f %5.3f %5.3f\n"
            % (
                time_dict["real"],
                time_dict["sys"],
                time_dict["user"],
                time_dict["sys"] + time_dict["user"],
            )
        )
