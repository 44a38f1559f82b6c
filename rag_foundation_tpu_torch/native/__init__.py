"""Native (C++) host shim of the port, built at first use and loaded
through ``ctypes``.

``hasher.cpp`` holds the feature hasher (``ragtpu_hash_encode``) that
``models/hash_encoder.HashingEncoder`` embeds with by default, and the
exact int8 re-rank (``ragtpu_rescore``) of the ``ivf_pq`` host tier
(``engine/archive.HostArchive.rescore``). It is the port's own copy of
the JAX package's shim, compiled with the same flags, so the two
libraries compute the same bits.

``load_hasher()`` compiles it with ``g++`` into ``build/native/`` at the
repository root (git-ignored), named by a hash of the source, the flags
and the CPU that ``-march=native`` resolves to, so a library built on
one machine is never loaded on another. It shares the build cache of
``ops/cuda_lib`` that the CUDA kernels use: several processes may build
at once, each writes its own temporary file and renames it into place.
Without ``g++`` on ``PATH`` it returns None (logged once) and the
callers take their Python and numpy paths; a source that does not
compile raises with the compiler's output. Nothing is built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import logging
import shutil
import subprocess
import threading
from pathlib import Path

from rag_foundation_tpu_torch.ops import cuda_lib

SRC = Path(__file__).resolve().parent / "hasher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the JAX package's flags exactly. -march=native: the library is built
# on the machine that loads it, so the re-rank's dot vectorizes for its
# ISA; -fopenmp-simd honors the reduction pragma without the OpenMP
# runtime
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp-simd", "-shared", "-fPIC",
             "-std=c++17")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_MISSING = False
_log = logging.getLogger(__name__)


def _native_target(gxx: str) -> str:
    """What ``-march=native`` resolves to on this machine."""
    out = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60)
    return " ".join(line.split()[-1] for line in out.stdout.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def library_path(gxx: str) -> Path:
    return cuda_lib.hashed_library(
        BUILD_DIR, "ragtpu_hasher",
        [SRC.read_bytes(), " ".join(GXX_FLAGS).encode(),
         _native_target(gxx).encode()])


def loaded() -> bool:
    """Whether this process has loaded the native shim."""
    return _LIB is not None


def load_hasher() -> ctypes.CDLL | None:
    """The native shim, built on first use; None when no ``g++`` is on
    ``PATH`` (the callers then take their Python and numpy paths)."""
    global _LIB, _MISSING
    if _LIB is not None or _MISSING:
        return _LIB
    with _LOCK:
        if _LIB is not None or _MISSING:
            return _LIB
        gxx = shutil.which("g++")
        if gxx is None:
            _MISSING = True
            _log.warning("native shim not built: no g++ on PATH; the "
                         "hasher and the host re-rank take their Python "
                         "and numpy paths")
            return None
        path = library_path(gxx)
        if not path.exists():
            try:
                cuda_lib.finish_build(
                    *cuda_lib.start_build([gxx, *GXX_FLAGS, str(SRC)], path),
                    path, timeout=300)
            except RuntimeError as e:
                raise RuntimeError(f"native shim build failed for {SRC}: "
                                   f"{e}") from None
        lib = ctypes.CDLL(str(path))
        lib.ragtpu_hash_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64]
        lib.ragtpu_hash_encode.restype = None
        lib.ragtpu_rescore.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        lib.ragtpu_rescore.restype = None
        _LIB = lib
        return _LIB
