"""Build and load the hand-written CUDA kernels in ``chiron_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``chiron_tpu_torch/_build/lib<name>.so`` for ``sm_90a`` (Hopper), then
loaded with ``ctypes``. Nothing is built at import time: the first launch
of a kernel builds its library (or ``build_all`` builds every library at
once, one ``nvcc`` process per library, all started together). A library is
rebuilt when its source is newer than it. A source may be built into more
than one library with other macros (``VARIANTS``): ``bilstm_bf16`` is
``csrc/bilstm.cu`` with ``-DLSTM_XW_BF16``, the LSTM inference kernel's
bfloat16 instance, built beside the float32 one rather than after it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("conv_bn", "bilstm", "bilstm_bf16", "lstm_c16", "beam", "lstm_grad", "gru",
           "bnlstm", "ctc_loss", "crf")
# library -> (its source in csrc/, extra nvcc flags); every other library is
# csrc/<name>.cu with none
VARIANTS = {"bilstm_bf16": ("bilstm", ("-DLSTM_XW_BF16",))}

_LIBS: Dict[str, ctypes.CDLL] = {}
_DECLARE: Dict[str, Callable[[ctypes.CDLL], None]] = {}
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel library that does not build or load, or a launch that
    returned a CUDA error: a fault of the card or the kernels, never of the
    model a caller asked for."""


def register(name: str, declare: Callable[[ctypes.CDLL], None]) -> None:
    """Record how to set argtypes/restype of ``lib<name>.so`` once loaded."""
    _DECLARE[name] = declare


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.exists(c):
            return c
    raise KernelError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    source = VARIANTS.get(name, (name,))[0]
    return (os.path.join(CSRC, f"{source}.cu"),
            os.path.join(BUILD, f"lib{name}.so"),
            os.path.join(BUILD, f"{name}.log"))


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    return not os.path.exists(lib) or os.path.getmtime(src) > os.path.getmtime(lib)


def _start_build(name: str):
    """Start nvcc for one source; returns what _finish_build needs."""
    src, lib, log = _paths(name)
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *VARIANTS.get(name, (name, ()))[1], "-o", tmp, src]
    with open(log, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
    return proc, tmp


def _finish_build(name: str, started) -> None:
    proc, tmp = started
    rc = proc.wait()
    if rc != 0:
        with open(_paths(name)[2]) as f:
            raise KernelError(f"nvcc failed for {name} (rc {rc}):\n{f.read()}")
    os.replace(tmp, _paths(name)[1])


def build_all(names: Iterable[str] = SOURCES) -> Tuple[Dict[str, str], Dict[str, float]]:
    """Build every stale library in parallel; return ({name: ptxas log},
    {name: seconds from the start to its nvcc's exit})."""
    build_seconds: Dict[str, float] = {}
    with _LOCK:
        t0 = time.time()
        procs = {n: _start_build(n) for n in names if _stale(n)}
        while len(build_seconds) < len(procs):
            for n, started in procs.items():
                if n not in build_seconds and started[0].poll() is not None:
                    build_seconds[n] = time.time() - t0
            time.sleep(0.05)
        for n, started in procs.items():
            _finish_build(n, started)
    logs = {}
    for n in names:
        log = _paths(n)[2]
        if os.path.exists(log):
            with open(log) as f:
                logs[n] = f.read()
    return logs, build_seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            if _stale(name):
                _finish_build(name, _start_build(name))
            try:
                lib = ctypes.CDLL(_paths(name)[1])
            except OSError as e:
                raise KernelError(f"cannot load the {name} kernels: {e}") from e
            _DECLARE[name](lib)
            _LIBS[name] = lib
        return _LIBS[name]


def on_device(dev: torch.device):
    """The context every kernel launch runs in: its tensors' device made
    current. A ``<<<>>>`` launch and ``cudaFuncSetAttribute`` act on the
    current device, whatever the stream passed, so a launch for ``cuda:1``
    from a thread whose current device is ``cuda:0`` needs it."""
    return torch.cuda.device(dev)


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise KernelError(f"CUDA launch of {what} failed: cudaError {rc}")
