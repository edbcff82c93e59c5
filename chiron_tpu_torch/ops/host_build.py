"""Build and load the port's native host library (``chiron_tpu_torch/native``).

Three C++ sources with a plain C interface, the host half of ``call`` and of
the resquiggle tool:

* ``parse.cc``: ``chiron_parse_signal``, the ``.signal`` text parser
  (``io/signal.py``);
* ``assembly.cc``: ``chiron_assemble_glue`` (the glue / stick assembler of
  the standard presets), ``chiron_global_disp`` and ``chiron_simple_blocks``
  (the other assemblers' displacement searches; ``assembly/consensus.py``);
* ``dtw.cc``: ``chiron_resquiggle`` and ``chiron_dtw_distance``, the
  coarse-to-fine banded DTW (``tools/resquiggle.py``).

They are compiled at first use with ``g++ -O3 -std=c++17 -fPIC -Wall
-shared`` into ``chiron_tpu_torch/_build/libchiron_host.so``, rebuilt when a
source is newer. The compiler writes a temporary file that is renamed into
place, so processes that build at once each load a whole library. Where no
library can be built (no compiler), the callers take their numpy paths,
which give the same results: ``native_available()`` says which path runs,
and the first load logs it.
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG, "native")
SOURCES = ("dtw.cc", "parse.cc", "assembly.cc")
LIB = os.path.join(_PKG, "_build", "libchiron_host.so")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

logger = logging.getLogger("chiron_tpu_torch.native")
_LIB = None  # None: not tried yet; False: unavailable
_LOCK = threading.Lock()
_NUMPY_ONLY = False


class NativeBuildError(RuntimeError):
    """The native host library does not build or load."""


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(SOURCE_DIR, s)) > built for s in SOURCES)


def build(lib_path: str = LIB) -> str:
    """Compile the sources into ``lib_path`` if it is missing or older than
    a source; returns the path. Raises NativeBuildError when the compiler is
    missing or fails."""
    if not _stale(lib_path):
        return lib_path
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp,
           *(os.path.join(SOURCE_DIR, s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                               f"{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _f32():
    return np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes and restype of the six entry points."""
    ll, f64 = ctypes.c_longlong, np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.chiron_parse_signal.restype = ll
    lib.chiron_parse_signal.argtypes = [ctypes.c_char_p, ll, _f32(), ll]
    lib.chiron_assemble_glue.restype = ll
    # qs is a float* or None
    lib.chiron_assemble_glue.argtypes = [ctypes.c_char_p, i64, ll, ctypes.c_void_p,
                                         ctypes.c_int, f64, f64, ll]
    lib.chiron_global_disp.restype = ll
    lib.chiron_global_disp.argtypes = [ctypes.c_char_p, ll, ctypes.c_char_p, ll]
    lib.chiron_simple_blocks.restype = ll
    lib.chiron_simple_blocks.argtypes = [ctypes.c_char_p, ll, ctypes.c_char_p, ll, i64, ll]
    lib.chiron_resquiggle.restype = ctypes.c_double
    lib.chiron_resquiggle.argtypes = [
        _f32(), ctypes.c_int, _f32(), ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.chiron_dtw_distance.restype = ctypes.c_double
    lib.chiron_dtw_distance.argtypes = [_f32(), ctypes.c_int, _f32(), ctypes.c_int,
                                        ctypes.c_int]
    return lib


def open_library(lib_path: str) -> ctypes.CDLL:
    """Load a built library and declare its entry points."""
    try:
        return _declare(ctypes.CDLL(lib_path))
    except (OSError, AttributeError) as e:
        raise NativeBuildError(f"cannot load {lib_path}: {e}") from e


def load():
    """The native host library, built on first use; None where it cannot be
    built or loaded, or inside ``numpy_paths()`` (the callers then take their
    numpy paths)."""
    global _LIB
    if _NUMPY_ONLY:
        return None
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                try:
                    _LIB = open_library(build())
                    logger.info("native host code: %s", LIB)
                except NativeBuildError as e:
                    _LIB = False
                    logger.warning("native host code unavailable, numpy paths run: %s", e)
    return _LIB or None


def native_available() -> bool:
    """Whether the native host library runs (else the numpy paths do)."""
    return load() is not None


@contextlib.contextmanager
def numpy_paths():
    """Within the block every caller takes its numpy path (to hold the two
    paths to each other, or time them). Not thread-safe."""
    global _NUMPY_ONLY
    before, _NUMPY_ONLY = _NUMPY_ONLY, True
    try:
        yield
    finally:
        _NUMPY_ONLY = before
