"""Training-label generation pipeline (chiron_label equivalent).

Port of ``chiron_tpu/tools/labeler.py`` (reference: chiron/chiron_label.py:
225-304): for every fast5, obtain the read's reference sequence (a
minimap2/mappy alignment of its basecall where ``mappy`` is installed, else
a per-read reference fasta keyed by read id), resquiggle the raw signal
against it (``tools/resquiggle.py``: the native DTW where the host library
builds) and write the Corrected_000 event table into a fast5 copy, ready
for ``chiron export``. Optional polyA trimming from a Nanopolish TSV in RNA
mode (chiron_label.py:26-113). Needs ``h5py``. ``-t N`` runs N worker
processes started with ``spawn`` (the JAX copy forks):

    python -m chiron_tpu_torch.tools.labeler -i <fast5 dir> -r <refs.fasta> -s <out>
"""

from __future__ import annotations

import argparse
import importlib.util
import multiprocessing as mp
import os
import shutil
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from chiron_tpu_torch.io.fast5 import iter_fast5_reads
from chiron_tpu_torch.tools.resquiggle import (
    PoreModel,
    resquiggle_signal,
    write_corrected_events,
)

# mappy is optional and imported where it is used
HAVE_MAPPY = importlib.util.find_spec("mappy") is not None


def read_polya_tsv(path: str) -> Dict[str, int]:
    """Nanopolish polyA segmentation: readname -> transcript start sample."""
    table = {}
    with open(path) as f:
        header = f.readline().split()
        try:
            name_i = header.index("readname")
            start_i = header.index("transcript_start")
            pass_i = header.index("qc_tag") if "qc_tag" in header else None
        except ValueError:
            name_i, start_i, pass_i = 0, 1, None
        for line in f:
            parts = line.split()
            if pass_i is not None and parts[pass_i] != "PASS":
                continue
            table[parts[name_i]] = int(float(parts[start_i]))
    return table


def _reference_for_read(basecall: Optional[str], aligner, ref_seqs: Dict[str, str],
                        read_id: str):
    """Resolve the reference sequence for one read."""
    if read_id in ref_seqs:
        return ref_seqs[read_id]
    if aligner is not None and basecall:
        import mappy

        for hit in aligner.map(basecall):
            if hit.is_primary:
                seq = aligner.seq(hit.ctg, hit.r_st, hit.r_en)
                if hit.strand < 0:
                    seq = mappy.revcomp(seq)
                return seq
    return basecall  # fall back to self-labelled basecall


def _parse_fastq_seq(fastq_text: str) -> Optional[str]:
    lines = fastq_text.strip().splitlines()
    return lines[1] if len(lines) >= 2 else None


def label_file(args_tuple) -> Tuple[str, str]:
    path, cfg = args_tuple
    try:
        items = list(iter_fast5_reads(path, mode=cfg["mode"], unit=False, polya=None))
    except Exception as e:  # an unreadable file is reported, not raised
        return path, f"read-failed: {e}"
    pm = PoreModel.load(cfg["pore_model"]) if cfg["pore_model"] else PoreModel.default()
    aligner = None
    if HAVE_MAPPY and cfg["ref"] and os.path.exists(cfg["ref"]):
        import mappy

        aligner = mappy.Aligner(cfg["ref"], preset="map-ont")
    ref_seqs = cfg["ref_seqs"]
    for suffix, signal, embedded_ref, read_id in items:
        basecall = _parse_fastq_seq(embedded_ref) if embedded_ref else None
        if cfg["polya"] and read_id in cfg["polya"]:
            signal = signal[cfg["polya"][read_id]:]
        ref_seq = _reference_for_read(basecall, aligner, ref_seqs, read_id)
        if not ref_seq:
            return path, "no-reference"
        out_path = os.path.join(
            cfg["out_dir"], os.path.basename(path).replace(".fast5", suffix + ".fast5"))
        shutil.copyfile(path, out_path)
        starts = resquiggle_signal(np.asarray(signal, np.float32), ref_seq, pore_model=pm,
                                   radius=cfg["radius"])
        write_corrected_events(out_path, starts, ref_seq)
    return path, "ok"


def run(args) -> Dict[str, int]:
    os.makedirs(args.saving, exist_ok=True)
    out_dir = os.path.join(args.saving, "fast5s")
    os.makedirs(out_dir, exist_ok=True)
    polya = read_polya_tsv(args.polya) if getattr(args, "polya", None) else None
    ref_seqs: Dict[str, str] = {}
    if getattr(args, "ref", None) and os.path.exists(args.ref) and not HAVE_MAPPY:
        # without an aligner, a fasta of per-read references keyed by name
        from chiron_tpu_torch.tools.genome_model import read_sequences

        names = []
        with open(args.ref) as f:
            for line in f:
                if line.startswith(">") or line.startswith("@"):
                    names.append(line[1:].split()[0])
        for name, seq in zip(names, read_sequences(args.ref)):
            ref_seqs[name] = seq
    cfg = {
        "mode": "rna" if args.mode != 0 else "dna",
        "ref": getattr(args, "ref", None),
        "ref_seqs": ref_seqs,
        "polya": polya,
        "pore_model": getattr(args, "pore_model", None),
        "radius": getattr(args, "radius", 50),
        "out_dir": out_dir,
    }
    file_list = []
    for root, _, files in os.walk(args.input):
        for f in files:
            if f.endswith("fast5"):
                file_list.append((os.path.join(root, f), cfg))
    results: Dict[str, int] = {}
    if args.thread <= 1:
        for _, state in map(label_file, file_list):
            results[state] = results.get(state, 0) + 1
        return results
    with mp.get_context("spawn").Pool(args.thread) as pool:
        for _, state in pool.imap_unordered(label_file, file_list):
            results[state] = results.get(state, 0) + 1
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate resquiggled training labels from fast5 files.")
    parser.add_argument("-i", "--input", required=True, help="Directory of the fast5 files.")
    parser.add_argument("-r", "--ref", default=None, help="Reference file name")
    parser.add_argument("--polya", default=None,
                        help="PolyA segment TSV (Nanopolish), RNA mode.")
    parser.add_argument("-m", "--mode", default=0, type=int,
                        help="0 DNA pore model, 1/-1 RNA pore models.")
    parser.add_argument("-s", "--saving", required=True, help="Output saving folder.")
    parser.add_argument("-t", "--thread", default=1, type=int)
    parser.add_argument("--pore_model", default=None,
                        help="k-mer pore model tsv (kmer, level_mean, ...).")
    parser.add_argument("--radius", default=50, type=int, help="DTW band radius.")
    args = parser.parse_args(argv)
    results = run(args)
    print(results)


if __name__ == "__main__":
    main(sys.argv[1:])
