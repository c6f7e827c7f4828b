"""Build the package's CUDA sources with ``nvcc`` and load them by ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source bytes and the compiler flags, so an edited
source rebuilds and an unchanged one is loaded as it is.  Nothing is
built when this module is imported: the first call of a kernel's wrapper
builds it.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# first calls from several threads (shards run from a pool) build and load
# each library once
_libs_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$PATH``, else ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found (searched $PATH and "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "build")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(*names: str) -> Dict[str, str]:
    """Build each ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    per source, all started together; returns each name's compiler output
    ("" when nothing was built).  Each library is written to a temporary
    name and renamed into place, so an interrupted build never leaves a
    partial file."""
    procs = {}
    outputs = {name: "" for name in names}
    for name in names:
        out = library_path(name)
        if out.exists() or name in procs:
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        outputs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{outputs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outputs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
