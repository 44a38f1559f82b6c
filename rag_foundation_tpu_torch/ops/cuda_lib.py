"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C entry point. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (git-ignored), named by a hash
of its source, the shared headers (``csrc/*.cuh``) and the flags, and
loaded with ``ctypes``. Nothing is built
or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def hashed_library(build_dir: Path, stem: str, inputs: list[bytes]) -> Path:
    """``build_dir/lib<stem>-<hash>.so``, named by a hash of ``inputs``
    (sources, flags, target): a change to any of them names a new
    library, so a stale one is never loaded."""
    h = hashlib.sha256()
    for part in inputs:
        h.update(part)
    return build_dir / f"lib{stem}-{h.hexdigest()[:16]}.so"


def start_build(cmd: list[str], out: Path) -> tuple[subprocess.Popen, Path]:
    """Start the compiler ``cmd`` writing to a temporary file of this
    process and thread beside ``out``; ``finish_build`` moves it there."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def finish_build(proc: subprocess.Popen, tmp: Path, out: Path,
                 timeout: float | None = None) -> str:
    """Wait for a build of ``start_build`` and return the compiler's
    output. On success the library is renamed into place (atomic:
    concurrent builders agree); on failure the temporary is removed and
    the output raised."""
    log, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(proc.args[0]).name} exit "
                           f"{proc.returncode} building {out.name}\n{log}")
    os.replace(tmp, out)
    return log


def library_path(name: str) -> Path:
    """Library of ``csrc/<name>.cu``, named by a hash of that source, of
    every header beside it (a source may include any of them) and of the
    flags."""
    headers = [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    return hashed_library(
        BUILD_DIR, name, [(CSRC_DIR / f"{name}.cu").read_bytes(), *headers,
                          " ".join(NVCC_FLAGS).encode()])


def build(names: list[str]) -> dict[str, dict]:
    """Compile every listed kernel source that has no library yet, all
    ``nvcc`` processes started together. Returns per name
    ``{"seconds", "ptxas"}`` (the ``-Xptxas -v`` report; empty when the
    library was already built). Raises with the compiler's output on a
    failed build."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")]
        started[name] = (time.perf_counter(), out, *start_build(cmd, out))
    report = {name: {"seconds": 0.0, "ptxas": ""} for name in names}
    failed = []
    for name, (t0, out, proc, tmp) in started.items():
        try:
            log = finish_build(proc, tmp, out)
        except RuntimeError as e:
            failed.append(f"{name}: {e}")
            continue
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
    return lib


class LaunchCounter:
    """Thread-safe count of a kernel's launches (the engine launches from
    several threads)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
