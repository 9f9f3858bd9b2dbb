"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed by a hash
of the sources and the compiler flags, and is loaded with ctypes. Nothing is
compiled when a module is imported: a kernel's wrapper calls :func:`load` the
first time it launches on a CUDA tensor. :func:`load_all` builds several
sources at once, one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):  # headers count too
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled if not yet built.

    Raises RuntimeError with nvcc's output when the build fails."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _loaded:
            src = os.path.join(CSRC_DIR, name + ".cu")
            so = os.path.join(BUILD_DIR, f"{name}-{_digest()}.so")
            log = ""
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                res = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    capture_output=True, text=True,
                )
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src} (exit {res.returncode}):\n"
                        f"{res.stderr}{res.stdout}"
                    )
                os.replace(tmp, so)
                log = res.stderr + res.stdout
            _loaded[name] = (ctypes.CDLL(so), log)
        return _loaded[name][0]


def load_all(names: Sequence[str]) -> List[ctypes.CDLL]:
    """:func:`load` for every name, the builds running side by side. Every
    build runs to its end before the first failure is raised (``map`` would
    cancel the builds not yet started when an early one fails)."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = [pool.submit(load, name) for name in names]
    return [f.result() for f in futures]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills) from
    this process's build of ``name``; empty when the library was already
    built."""
    return _loaded[name][1] if name in _loaded else ""
