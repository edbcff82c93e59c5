"""Checkpoints: the flat-npz pytrees of ``chiron_tpu/train/checkpoint.py``.

Every leaf of a params pytree is stored under its "/"-joined key path in one
.npz; list items are keyed ``[i]``. A ``checkpoint`` text file in the model
dir names the latest one. The format and the file names are the JAX
package's own, so a checkpoint written by either package loads in the
other. Needs numpy alone.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

_LIST_KEY = re.compile(r"^\[(\d+)\]$")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}/__empty__" if prefix else "__empty__"] = np.asarray(0)
            return out
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}/__emptylist__" if prefix else "__emptylist__"] = np.asarray(0)
            return out
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/[{i}]" if prefix else f"[{i}]"))
    else:
        # arrays, and static metadata leaves (ints, strings) as 0-d arrays
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        arr = node
        if arr.ndim == 0 and arr.dtype.kind in "iu":
            return int(arr)
        if arr.ndim == 0 and arr.dtype.kind == "U":
            return str(arr)
        return arr
    keys = list(node.keys())
    if keys == ["__empty__"]:
        return {}
    if keys == ["__emptylist__"]:
        return []
    if keys and all(_LIST_KEY.match(k) for k in keys):
        items = sorted(keys, key=lambda k: int(_LIST_KEY.match(k).group(1)))
        return [_listify(node[k]) for k in items]
    return {k: _listify(v) for k, v in node.items()}


def save_checkpoint(model_dir: str, params: Any, step: int, prefix: str = "model",
                    max_to_keep: Optional[int] = 5, update_state: bool = True) -> str:
    """Write ``<prefix>-<step>.npz`` from a tree with numpy leaves.

    ``update_state=False`` leaves the ``checkpoint`` pointer alone, for side
    snapshots (EMA) that must not change what ``restore_latest`` resumes
    from. ``max_to_keep`` keeps the newest files of this prefix only
    (tf.train.Saver parity); other prefixes are never touched.
    """
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"{prefix}-{step}.npz")
    np.savez(path, **_flatten(params))
    if update_state:
        with open(os.path.join(model_dir, "checkpoint"), "w") as f:
            f.write(f"{prefix}-{step}.npz\n")
    if max_to_keep:
        pat = re.compile(re.escape(prefix) + r"-(\d+)\.npz$")
        steps = sorted(int(m.group(1)) for f in os.listdir(model_dir) if (m := pat.match(f)))
        for old in steps[:-max_to_keep]:
            try:
                os.remove(os.path.join(model_dir, f"{prefix}-{old}.npz"))
            except FileNotFoundError:
                pass
    return path


def latest_checkpoint(model_dir: str) -> Optional[str]:
    state = os.path.join(model_dir, "checkpoint")
    if os.path.exists(state):
        with open(state) as f:
            name = f.read().strip().splitlines()[0]
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            return path
    # fall back to the newest .npz in the folder
    cands = [f for f in os.listdir(model_dir) if f.endswith(".npz")] if os.path.isdir(model_dir) else []
    if not cands:
        return None
    cands.sort(key=lambda f: os.path.getmtime(os.path.join(model_dir, f)))
    return os.path.join(model_dir, cands[-1])


def load_checkpoint(path: str) -> Any:
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat)


def restore_latest(model_dir: str) -> Tuple[Optional[Any], Optional[int]]:
    path = latest_checkpoint(model_dir)
    if path is None:
        return None, None
    step = None
    m = re.search(r"-(\d+)\.npz$", path)
    if m:
        step = int(m.group(1))
    return load_checkpoint(path), step
