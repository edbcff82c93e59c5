"""`chiron`-compatible CLI for the PyTorch port: the `call` subcommand.

Flags mirror ``chiron_tpu/cli.py`` (chiron/entry.py:62-155) plus
``--device`` (default cuda; a missing GPU raises instead of falling back).
A fast5 input folder is first extracted to <output>/raw/*.signal (needs
h5py); a folder of .signal files is basecalled directly:

    python -m chiron_tpu_torch.cli call -i <in> -o <out> -p dna-pre
"""

from __future__ import annotations

import argparse
import os
import sys
from os import path

import chiron_tpu_torch
from chiron_tpu_torch.config import PRESETS

# the bundled models live in the JAX package's folder, read as data files
MODEL_ROOT = path.join(path.dirname(path.dirname(path.abspath(__file__))),
                       "chiron_tpu", "model")


def _set_paras(args, p):
    for key in ("start", "batch_size", "segment_len", "jump", "threads", "beam"):
        if getattr(args, key) is None:
            setattr(args, key, p[key])
    return args


def evaluation(args):
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # fail before any extraction work
    if args.preset is None:
        default_p = PRESETS["default"]
    elif args.preset in ("dna-pre", "dna-slow-pre"):
        default_p = PRESETS[args.preset]
        if args.mode == "rna":
            raise ValueError("Try to use the DNA preset parameter setting in RNA mode.")
        if args.preset == "dna-slow-pre" and args.model is None:
            args.model = path.join(MODEL_ROOT, "DNA_slow")
    elif args.preset == "rna-pre":
        default_p = PRESETS["rna-pre"]
        if args.mode == "dna":
            raise ValueError(
                "Attempt to use the RNA preset parameter setting in DNA mode, "
                "enable RNA basecalling by --mode rna"
            )
    else:
        raise ValueError(f"Unknown presetting {args.preset} undifiend")
    if args.model is None:
        args.model = path.join(MODEL_ROOT, "DNA_default")
    args = _set_paras(args, default_p)
    args.input_dir = args.input
    args.output_dir = args.output
    args.unit = False
    args.recursive = True
    args.polya = None
    args.idname = False
    args.delimiter = "\n"
    args.reverse_fast5 = args.mode == "rna"
    if os.path.isdir(args.input) and any(
            f.endswith(".fast5") for _, _, fs in os.walk(args.input) for f in fs):
        from chiron_tpu_torch.tools.extract_sig import extract

        extract(args)
        args.input = args.output + "/raw/"
    return pipeline.run(args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="chiron", description="A deep neural network basecaller (PyTorch/CUDA port).")
    parser.add_argument("-v", "--version", action="version",
                        version="chiron_tpu_torch version " + chiron_tpu_torch.__version__,
                        help="Print out the version.")
    subparsers = parser.add_subparsers(title="sub command", help="sub command help")
    p = subparsers.add_parser("call", description="Perform basecalling",
                              help="Perform basecalling.")
    p.add_argument("-i", "--input", required=True,
                   help="File path or Folder path to the fast5 or .signal files.")
    p.add_argument("-o", "--output", required=True, help="Output folder path")
    p.add_argument("-m", "--model", type=str, default=None,
                   help="model folder path (default: the bundled DNA_default; "
                        "the dna-slow-pre preset defaults to DNA_slow)")
    p.add_argument("-s", "--start", type=int, default=None,
                   help="Start index of the signal file.")
    p.add_argument("-b", "--batch_size", type=int, default=None,
                   help="Batch size for run, bigger batch_size will increase the "
                        "processing speed but require larger RAM load")
    p.add_argument("-l", "--segment_len", type=int, default=None,
                   help="Segment length to be divided into.")
    p.add_argument("-j", "--jump", type=int, default=None, help="Step size for segment")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="Threads number, default is 0, which use all the available threads.")
    p.add_argument("-e", "--extension", default="fastq", help="Output file type.")
    p.add_argument("--beam", type=int, default=None,
                   help="Beam width used in beam search decoder, set to 0 to use a "
                        "greedy decoder.")
    p.add_argument("--length_bonus", type=float, default=None,
                   help="Additive log-score per emitted label in the beam decoder. "
                        "Default: the model's calibrated value from model.json, "
                        "else 0.0 (reference semantics).")
    p.add_argument("--concise", action="store_true",
                   help="Concisely output the result, the meta and segments files "
                        "will not be output.")
    p.add_argument("--mode", default="dna", help="Output mode, can be chosen from dna or rna.")
    p.add_argument("--test_number", default=None, type=int,
                   help="Extract test_number reads, default is None, extract all reads.")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 inference (not supported by this port yet).")
    p.add_argument("-p", "--preset", default=None,
                   help="Preset evaluation parameters: dna-pre, dna-slow-pre, rna-pre")
    p.add_argument("--n_devices", type=int, default=0,
                   help="Shard each batch across this many GPUs (only 0/1 supported).")
    p.add_argument("--sig_norm", type=int, default=None,
                   help="Signal normalization: None raw (default), 0 median/mad, 1 mean/std.")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace under <output>/profile.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a GPU is an error.")
    p.set_defaults(func=evaluation)
    return parser


def main(arguments=None):
    parser = build_parser()
    args = parser.parse_args(sys.argv[1:] if arguments is None else arguments)
    if hasattr(args, "func"):
        return args.func(args)
    parser.print_help()


if __name__ == "__main__":
    main()
