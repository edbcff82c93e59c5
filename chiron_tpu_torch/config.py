"""Model/run configuration (a copy of ``chiron_tpu/config.py``'s read side).

A model folder holds ``model.json`` describing the architecture plus
parameter checkpoints (reference: chiron/chiron_model.py:24-48). CLI presets
mirror chiron/entry.py:20-31.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

# Default model configuration (reference: chiron/chiron_model.py:41-47).
_DEFAULT_CONFIG: Dict[str, Any] = {
    "cnn": {"model": "dna_model1"},
    "rnn": {
        "layer_num": 3,
        "hidden_num": 100,
        "cell_type": "LSTM",
        "layer_type": "normal",
    },
    "opt_method": "Adam",
    "fl_gamma": 2,
}

# Evaluation presets (reference: chiron/entry.py:20-31).
PRESETS: Dict[str, Dict[str, int]] = {
    "default": {
        "start": 0,
        "batch_size": 400,
        "segment_len": 500,
        "jump": 490,
        "threads": 0,
        "beam": 30,
    },
    "dna-pre": {
        "start": 0,
        "batch_size": 400,
        "segment_len": 400,
        "jump": 390,
        "threads": 0,
        "beam": 30,
    },
    "rna-pre": {
        "start": 0,
        "batch_size": 300,
        "segment_len": 2000,
        "jump": 1900,
        "threads": 0,
        "beam": 30,
    },
    # slow-translocation DNA (~18-32 samples/base): long windows + the
    # DNA_slow model's stride-4 front
    "dna-slow-pre": {
        "start": 0,
        "batch_size": 300,
        "segment_len": 2000,
        "jump": 1900,
        "threads": 0,
        "beam": 30,
    },
}

# Blank is the LAST CTC class (TF CTC convention).
BASES = "ACGT"
# Extended alphabet for methylation calling (config "alphabet": 5).
BASES_METH = "ACGTX"


def class_n(config) -> int:
    """CTC class count for a model config: alphabet size + blank."""
    return int(config.get("alphabet", 4)) + 1


def alphabet(config) -> str:
    return BASES_METH[: int(config.get("alphabet", 4))]


def default_config() -> Dict[str, Any]:
    """A deep copy of the default (DNA) model configuration."""
    return json.loads(json.dumps(_DEFAULT_CONFIG))


def read_config(config_file: str | None) -> Dict[str, Any]:
    """Read a model.json; fall back to the default DNA config."""
    if config_file is not None and os.path.exists(config_file):
        with open(config_file) as f:
            config = json.load(f)
    else:
        config = default_config()
    # Normalise missing keys so old configs keep working.
    config.setdefault("rnn", {})
    config["rnn"].setdefault("layer_num", 3)
    config["rnn"].setdefault("hidden_num", 100)
    config["rnn"].setdefault("cell_type", "LSTM")
    config["rnn"].setdefault("layer_type", "normal")
    config.setdefault("opt_method", "Adam")
    config.setdefault("fl_gamma", 0)
    return config
