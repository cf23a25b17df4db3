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

The executable store (``aot_store.py``) keeps certified copies of these
libraries: it builds a library the store lacks with :func:`build_to`
(always a real ``nvcc``, whatever ``build/kernels/`` holds) and hands a
verified library to this module with :func:`install`, after which
:func:`load` returns it and starts no ``nvcc``. A process keeps the
first library it loaded for a source (``_loaded``); ``origins`` says
where each came from, and ``nvcc_starts`` counts the ``nvcc`` processes
this process started.
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
# where each loaded library came from: "build <path>" or "store <path>"
origins: Dict[str, str] = {}
# nvcc's -Xptxas -v report of each build made by this process
build_logs: Dict[str, str] = {}
# nvcc processes started by this process
nvcc_starts = 0


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


def source_hash(src: str) -> str:
    """sha256 over a CUDA source and the flags it is built with."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _lib_path(src: str) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{source_hash(src)[:12]}.so")


def _nvcc(src: str, out: str) -> subprocess.Popen:
    global nvcc_starts
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    nvcc_starts += 1
    return proc


def _start(src: str) -> Optional[subprocess.Popen]:
    out = _lib_path(src)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = _nvcc(src, tmp)
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
    """Compile every named source that is not built or loaded yet, in
    parallel."""
    procs = {n: _start(_source(n)) for n in names
             if os.path.abspath(_source(n)) not in _loaded}
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
        origins[src] = f"build {_lib_path(src)}"
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    return load_file(_source(name))


def source(name: str) -> str:
    """The path of ``csrc/<name>.cu``."""
    return _source(name)


def build_to(name: str, out: str) -> str:
    """Compile ``csrc/<name>.cu`` into the file ``out`` with a real
    ``nvcc``, whatever ``build/kernels/`` holds; nvcc's report."""
    proc = _nvcc(_source(name), out)
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {_source(name)}:\n{log}")
    return log


def install(name: str, path: str, origin: str) -> bool:
    """Load the library file ``path`` as ``csrc/<name>.cu``'s, unless
    this process already loaded one for that source (it keeps its
    first). True when ``path`` was loaded."""
    src = os.path.abspath(_source(name))
    if src in _loaded:
        return False
    _loaded[src] = ctypes.CDLL(path)
    origins[src] = origin
    return True


def is_loaded(name: str) -> bool:
    return os.path.abspath(_source(name)) in _loaded
