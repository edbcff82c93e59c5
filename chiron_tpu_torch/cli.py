"""`chiron`-compatible CLI for the PyTorch port: `call`, `export` and `train`.

Flags mirror ``chiron_tpu/cli.py`` (chiron/entry.py:62-155) plus
``--device`` (default cuda; a missing GPU raises instead of falling back).
A fast5 input folder is first extracted to <output>/raw/*.signal (needs
h5py); a folder of .signal files is basecalled directly. Training reads a
folder of .signal/.label pairs, a .bin folder (``data.meta``), a TFRecord
file (``-f``) or a window cache (``--train_cache``):

    python -m chiron_tpu_torch.cli call -i <in> -o <out> -p dna-pre
    python -m chiron_tpu_torch.cli export -i <resquiggled fast5 dir> -o <out> \
        --basecall_group Corrected_000 [-f train.tfrecords]
    python -m chiron_tpu_torch.cli train -i <train dir> -o <log dir> -m <name> \
        --configure chiron_tpu/model/DNA_default/model.json

``--n_devices k`` shards `call`'s batches over k GPUs and starts k training
ranks. Under ``torchrun --nproc_per_node N -m chiron_tpu_torch.cli ...``
each process joins the launcher's group: `call` basecalls its hash shard of
the files, `train` feeds its file shard to the global-batch step. `export`
(resquiggled fast5 to .signal/.label batch folders) runs on the host and
needs h5py.
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


def _join_launch_group(args) -> None:
    """Under a multi-process launcher (``torchrun`` sets ``WORLD_SIZE``),
    join its process group: one rank per GPU (NCCL), or gloo with
    ``--device cpu``."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        from chiron_tpu_torch.parallel.mesh import initialize_distributed

        initialize_distributed(device=args.device)


def evaluation(args):
    from chiron_tpu_torch.eval import pipeline
    from chiron_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # fail before any extraction work
    _join_launch_group(args)
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


def export(args):
    from chiron_tpu_torch.tools import raw_extract

    return raw_extract.run(args)


def train(args):
    from chiron_tpu_torch.train import loop
    from chiron_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # fail before loading any data
    _join_launch_group(args)
    return loop.train(args)


def _add_export_parser(subparsers) -> None:
    p = subparsers.add_parser("export", description="Export signal and label from the fast5 file.",
                              help="Extract signal and label in the fast5 file.")
    p.add_argument("-i", "--input", required=True, help="Input folder contain fast5 files.")
    p.add_argument("-o", "--output", required=True, help="Output folder.")
    p.add_argument("--basecall_group", default="Basecall_1D_000",
                   help="Basecall group Nanoraw resquiggle into.")
    p.add_argument("--basecall_subgroup", default="BaseCalled_template",
                   help="Basecall subgroup Nanoraw resquiggle into.")
    p.add_argument("-b", "--batch", type=int, default=4000, help="Number of files per batches.")
    p.add_argument("--unit", dest="unit", action="store_true",
                   help="Use the pA unit instead of the original digital signal.")
    p.add_argument("--mode", default="dna", help="Type of data to basecall: dna or rna.")
    p.add_argument("--min_bps", default=0, type=int,
                   help="The minimum number of labels that has to be in each read.")
    p.add_argument("--n_errors", default=5, type=int,
                   help="The number of errors that are going to be recorded.")
    p.add_argument("-f", "--tffile", default=None,
                   help="Also bundle the extracted reads into this TFRecord file "
                        "(reference flag entry.py:99, implemented here).")
    p.set_defaults(func=export)


def _add_train_parser(subparsers) -> None:
    p = subparsers.add_parser("train", description="Model training", help="Train a model.")
    p.add_argument("-i", "--data_dir", required=True,
                   help="Directory that stores .signal/.label training pairs, a .bin "
                        "folder (data.meta), or a .tfrecord(s) file.")
    p.add_argument("-o", "--log_dir", required=True,
                   help="log directory that store the training model.")
    p.add_argument("-m", "--model_name", required=True, help="model_name")
    p.add_argument("-v", "--validation", default=None,
                   help="validation data directory; default None (no validation)")
    p.add_argument("--train_cache", default=None,
                   help="Window cache directory for the training dataset (built on first "
                        "use, rebuilt when the data or its parameters change).")
    p.add_argument("--valid_cache", default=None,
                   help="Window cache directory for the validation dataset.")
    p.add_argument("-s", "--sequence_len", type=int, default=400, help="the length of sequence")
    p.add_argument("-b", "--batch_size", type=int, default=300, help="Batch size")
    p.add_argument("-t", "--step_rate", type=float, default=4e-3, help="Step rate")
    p.add_argument("-x", "--max_steps", type=int, default=10000, help="Maximum step")
    p.add_argument("-n", "--segments_num", type=int, default=None,
                   help="Maximum number of training segments to read.")
    p.add_argument("--configure", default=None, help="Model structure configure json file.")
    p.add_argument("-k", "--k_mer", default=1, type=int, help="Output k-mer size")
    p.add_argument("-f", "--tfrecord", default=None,
                   help="Train from a TFRecord file (relative to data_dir) instead of "
                        ".signal/.label pairs (reference: entry.py:116-117).")
    p.add_argument("--retrain", dest="retrain", action="store_true", help="Set retrain to true")
    p.add_argument("--resample_after_epoch", type=int, default=0,
                   help="Resample the reads data every n epochs with an increasing initial "
                        "offset.")
    p.add_argument("--offset_increment", type=int, default=3,
                   help="Increment of initial offset per resample.")
    p.add_argument("--n_devices", type=int, default=0,
                   help="Data-parallel GPUs: k > 1 starts k ranks on this host, one a GPU "
                        "(0 or 1: one process).")
    p.add_argument("--sig_norm", type=int, default=None,
                   help="Signal normalization: None raw (default), 0 median/mad, 1 mean/std.")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace and the run's spans under "
                        "<log_dir>/<model_name>/profile (rank 0; profile a short run).")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a GPU is an error.")
    p.set_defaults(func=train)


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
                   help="bfloat16 inference mode: bf16 activations and matmul inputs, "
                        "float32 accumulation, state and logits.")
    p.add_argument("-p", "--preset", default=None,
                   help="Preset evaluation parameters: dna-pre, dna-slow-pre, rna-pre")
    p.add_argument("--n_devices", type=int, default=0,
                   help="Shard each batch across this many GPUs (0 or 1: one).")
    p.add_argument("--sig_norm", type=int, default=None,
                   help="Signal normalization: None raw (default), 0 median/mad, 1 mean/std.")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace and the run's spans under "
                        "<output>/profile.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a GPU is an error.")
    p.set_defaults(func=evaluation)
    _add_export_parser(subparsers)
    _add_train_parser(subparsers)
    return parser


def main(arguments=None):
    parser = build_parser()
    args = parser.parse_args(sys.argv[1:] if arguments is None else arguments)
    if hasattr(args, "func"):
        return args.func(args)
    parser.print_help()


if __name__ == "__main__":
    main()
