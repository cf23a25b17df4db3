"""ctypes binding of the native WGL linearizability core (``cpp/checker``).

A copy of ``maelstrom_tpu/checkers/native.py``'s binding, with its own
build: ``cpp/checker/wgl.cpp`` is compiled by ``g++`` (``$CXX`` when set,
the flags of ``cpp/checker/Makefile``) into
``<repo>/build/wgl/libwgl-<hash>.so`` at first use and loaded with
``ctypes``; the hash covers the source and the flags, so an edited
source rebuilds. A build or load failure raises, naming what is missing:
the linearizability checker never falls back to its Python search
because the core is absent (that search has a tenth of the core's state
budget, so the verdicts would differ). The core's own "cannot handle
this shape" answer (``None`` below) does take the Python search, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "cpp", "checker", "wgl.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "wgl")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

F_CODES = {"read": 1, "write": 2, "cas": 3}

_lib = None


def _lib_path(build_dir: str) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir, f"libwgl-{h.hexdigest()[:12]}.so")


def build_library(build_dir: str = BUILD_DIR,
                  cxx: Optional[str] = None) -> str:
    """Compile ``cpp/checker/wgl.cpp`` into ``build_dir`` unless it is
    built already; the library's path. Raises when the compiler is
    missing or fails."""
    out = _lib_path(build_dir)
    if os.path.exists(out):
        return out
    cxx = cxx or os.environ.get("CXX") or "g++"
    exe = shutil.which(cxx)
    if exe is None:
        raise RuntimeError(
            f"the native WGL core needs a C++ compiler to build "
            f"{SOURCE}; {cxx!r} was not found (set CXX to one)")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([exe, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders agree
    return out


def load():
    """The loaded core, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.wgl_check.restype = ctypes.c_int64
        lib.wgl_check.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64]
        _lib = lib
    return _lib


def check_register_history_native(ops, budget_states: int
                                  ) -> Optional[object]:
    """One key's WGL check in the native core: ``ops`` is the Python
    checker's ``_Op`` list. True / False / "unknown", or None when the
    core cannot take the case (values that are not hashable, an
    oversized segment): the caller then runs the Python search."""
    lib = load()
    table = {}

    def vid(v) -> int:
        # values densified to non-negative ints; nil -> -1
        if v is None:
            return -1
        if v not in table:
            table[v] = len(table)
        return table[v]

    flat: List[int] = []
    try:
        for o in ops:
            f = F_CODES[o.f]
            if o.f == "cas":
                a, b = vid(o.args[0]), vid(o.args[1])
                ret = -1
            elif o.f == "write":
                a, b, ret = vid(o.args), -1, -1
            else:
                a, b = -1, -1
                ret = vid(o.ret) if o.required else -1
            end = -1 if o.end == float("inf") else int(o.end)
            flat += [f, a, b, ret, int(o.inv), end, 1 if o.required else 0]
    except (TypeError, KeyError):
        return None

    arr = (ctypes.c_int64 * len(flat))(*flat)
    rc = lib.wgl_check(arr, len(ops), -1, budget_states)
    if rc == 1:
        return True
    if rc == 0:
        return False
    if rc == -1:
        return "unknown"
    return None   # -2: a shape the core does not take
