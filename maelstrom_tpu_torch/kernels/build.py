"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into
``<repo>/build/kernels/lib<name>-<hash>.so`` at first use, and loaded
with ``ctypes``: the sources expose a plain C interface, so no PyTorch
headers are compiled (seconds instead of minutes). The hash covers the
source and the flags, so an edited source rebuilds. Several sources
build in parallel (:func:`build_all`: one ``nvcc`` each, all started
together). Nothing happens at import: the CPU tests import this module
on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report of each build made by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to use: on PATH, else the toolkit's default home."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of maelstrom_tpu_torch build only where the CUDA toolkit is "
        "installed")


def _source(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def _lib_path(src: str) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")


def _start(src: str) -> Optional[subprocess.Popen]:
    out = _lib_path(src)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out = tmp, out
    return proc


def _finish(name: str, src: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    os.replace(proc.tmp, proc.out)   # atomic: concurrent builders agree


def build_all(names: Sequence[str]) -> None:
    """Compile every named source that is not built yet, in parallel."""
    procs = {n: _start(_source(n)) for n in names}
    for n, p in procs.items():
        _finish(n, _source(n), p)


def load_file(src: str) -> ctypes.CDLL:
    """The loaded library for the CUDA source file ``src``, built if
    needed (any path: an earlier version of a kernel, for comparison)."""
    src = os.path.abspath(src)
    lib = _loaded.get(src)
    if lib is None:
        _finish(src, src, _start(src))
        lib = ctypes.CDLL(_lib_path(src))
        _loaded[src] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    return load_file(_source(name))
