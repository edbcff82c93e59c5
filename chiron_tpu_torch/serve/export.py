"""Serving-bundle exporter: a copy of ``chiron_tpu/serve/export.py``.

Replaces chiron/export_test.py:43-124: packages a model directory into a
self-describing serving bundle, model.json + parameter checkpoint + a
``serving.json`` signature manifest mirroring the reference's predict
signature {x, seq_len} -> {logits, prob_logits, log_prob, decoded...}.
Bundles are versioned by subdirectory number like SavedModel exports. The
files are the JAX package's, byte for byte, so either package serves the
other's bundles.

    python -m chiron_tpu_torch.serve.export -m <model dir> -o <export dir> --beam 30
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

from chiron_tpu_torch import config as C
from chiron_tpu_torch.train.checkpoint import latest_checkpoint

SIGNATURE = {
    "inputs": {
        "x": {"dtype": "float32", "shape": ["batch", "segment_len"]},
        "seq_len": {"dtype": "int32", "shape": ["batch"]},
    },
    "outputs": {
        "logits": {"dtype": "float32", "shape": ["batch", "time", 5]},
        "prob_logits": {"dtype": "float32", "shape": ["batch"]},
        "log_prob": {"dtype": "float32", "shape": ["batch"]},
        "decoded": {"dtype": "int32", "shape": ["batch", "time"]},
        "decoded_length": {"dtype": "int32", "shape": ["batch"]},
    },
}


def export_model(
    model_dir: str,
    export_dir: str,
    version: Optional[int] = None,
    segment_len: int = 400,
    beam: int = 0,
) -> str:
    """Package model_dir into export_dir/<version>/ and return the path."""
    ckpt = latest_checkpoint(model_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    config = C.read_config(os.path.join(model_dir, "model.json"))
    if version is None:
        existing = [
            int(d) for d in os.listdir(export_dir) if d.isdigit()
        ] if os.path.isdir(export_dir) else []
        version = max(existing, default=0) + 1
    bundle = os.path.join(export_dir, str(version))
    os.makedirs(bundle, exist_ok=True)
    shutil.copy(ckpt, os.path.join(bundle, os.path.basename(ckpt)))
    with open(os.path.join(bundle, "checkpoint"), "w") as f:
        f.write(os.path.basename(ckpt) + "\n")
    C.save_config(os.path.join(bundle, "model.json"), config)
    with open(os.path.join(bundle, "serving.json"), "w") as f:
        json.dump(
            {
                "signature": SIGNATURE,
                "segment_len": segment_len,
                "beam": beam,
                "source_model": os.path.abspath(model_dir),
            },
            f,
            indent=2,
        )
    return bundle


def latest_bundle(export_dir: str) -> str:
    versions = [int(d) for d in os.listdir(export_dir) if d.isdigit()]
    if not versions:
        raise FileNotFoundError(f"no bundles under {export_dir}")
    return os.path.join(export_dir, str(max(versions)))


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Package a trained model directory into a versioned "
        "serving bundle (reference: export_test.py:43-124)."
    )
    parser.add_argument("-m", "--model", required=True,
                        help="Model directory (model.json + checkpoint).")
    parser.add_argument("-o", "--export_dir", required=True,
                        help="Export root; bundles go to <export_dir>/<version>/.")
    parser.add_argument("--version", type=int, default=None,
                        help="Bundle version (default: next integer).")
    parser.add_argument("-s", "--segment_len", type=int, default=400)
    parser.add_argument("--beam", type=int, default=0)
    args = parser.parse_args(argv)
    bundle = export_model(args.model, args.export_dir, args.version,
                          args.segment_len, args.beam)
    print(f"Exported bundle: {bundle}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
