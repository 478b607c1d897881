"""Builds the port's CUDA sources (``ops/csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with :mod:`ctypes` — no PyTorch headers,
so a build takes seconds. Libraries land in ``build/torch_kernels/`` at the
root of the checkout, named by a hash of their source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. ``nvcc``'s report (ptxas
registers, shared memory, spills) is kept beside each library as ``.log``.

Only the machine with the card builds: nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the port's "
        "CUDA kernels build on a machine with the CUDA toolkit"
    )


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Starts nvcc for ``csrc/<name>.cu`` unless its library is built;
    returns ``(process, tmp_path, lib_path)`` or None."""
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, lib


def _finish(name: str, started) -> None:
    proc, tmp, lib = started
    out, _ = proc.communicate()
    lib.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)  # atomic: a reader never sees a half-written file


def build_all() -> Dict[str, str]:
    """Builds every source in ``csrc/`` at once (one nvcc each, all started
    together) and returns each library's nvcc report."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as err:
                    errors.append(str(err))
        if errors:
            raise RuntimeError("\n".join(errors))
    logs = {n: _library_path(n).with_suffix(".log") for n in names}
    return {n: log.read_text() if log.exists() else "" for n, log in logs.items()}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return lib


__all__ = ["build_all", "load", "BUILD_DIR"]
