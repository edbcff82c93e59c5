"""Write the golden outputs of the bundled example reads through the port.

Port of ``chiron_tpu/tools/regen_goldens.py``: runs the port's ``call``
pipeline on ``chiron_tpu/example_data/{DNA,RNA,DNA_SLOW}`` with the pinned
flags of tests/test_golden.py (fixed batch size: batch-stat BN makes
outputs batch- and platform-sensitive) and writes
``<out>/<NAME>/output/{result,segments}``, the layout of the committed
goldens. It never writes the committed goldens themselves: ``--out`` under
``chiron_tpu/`` is refused. The committed goldens are the CPU's, so
``--device cpu`` reproduces them byte for byte; the default is the card.
The example reads are fast5 files, so the tool needs ``h5py``:

    python -m chiron_tpu_torch.tools.regen_goldens --device cpu [--mode dna|rna|dna_slow|all]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_PACKAGE = os.path.join(REPO, "chiron_tpu")
DEFAULT_OUT = os.path.join(REPO, "chiron_tpu_torch", "_build", "goldens")

PINNED = {
    "dna": dict(batch_size=16, segment_len=400, jump=390, mode="dna", reverse_fast5=False),
    "rna": dict(batch_size=4, segment_len=2000, jump=1900, mode="rna", reverse_fast5=True),
    "dna_slow": dict(batch_size=8, segment_len=2000, jump=1900, mode="dna",
                     reverse_fast5=False),
}

MODEL_DIR = {"dna": "DNA_default", "rna": "RNA_default", "dna_slow": "DNA_slow"}


def _check_out(out: str) -> str:
    out = os.path.realpath(out)
    if os.path.commonpath([out, os.path.realpath(JAX_PACKAGE)]) == os.path.realpath(JAX_PACKAGE):
        raise ValueError(f"--out {out} lies under {JAX_PACKAGE}: the committed goldens "
                         f"are the JAX package's and are not written here")
    return out


def regen(mode: str, out_root: str, device: str = "cuda") -> int:
    """Basecall one example folder into <out_root>/<NAME>/output; returns
    the number of files written."""
    from chiron_tpu_torch.eval import pipeline

    name = mode.upper()
    example = os.path.join(JAX_PACKAGE, "example_data", name)
    model = os.path.join(JAX_PACKAGE, "model", MODEL_DIR[mode])
    if not os.path.isdir(example):
        print(f"skip {mode}: {example} absent")
        return 0
    if not os.path.exists(os.path.join(model, "checkpoint")):
        print(f"skip {mode}: no checkpoint installed in {model}")
        return 0
    os.makedirs(out_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix=f"golden_{mode}_", dir=out_root)
    try:
        flags = types.SimpleNamespace(
            input=example, output=work, model=model, start=0, threads=0, beam=0,
            extension="fastq", concise=False, recursive=False, sig_norm=1, device=device,
            **PINNED[mode])
        result = pipeline.run(flags)
        n = 0
        for sub in ("result", "segments"):
            dst = os.path.join(out_root, name, "output", sub)
            shutil.rmtree(dst, ignore_errors=True)
            os.makedirs(dst)
            for f in sorted(os.listdir(os.path.join(work, sub))):
                shutil.copyfile(os.path.join(work, sub, f), os.path.join(dst, f))
                n += 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"{mode}: wrote {n} golden files ({result['n_files']} reads) under "
          f"{os.path.join(out_root, name, 'output')}")
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="all", choices=["dna", "rna", "dna_slow", "all"])
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="where <NAME>/output/{result,segments} go (never under chiron_tpu/)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the committed goldens are the CPU's.")
    args = p.parse_args(argv)
    out = _check_out(args.out)
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise RuntimeError("regen_goldens reads the example fast5 files and needs h5py") from e
    modes = ["dna", "rna", "dna_slow"] if args.mode == "all" else [args.mode]
    for mode in modes:
        regen(mode, out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
