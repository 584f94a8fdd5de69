"""ctypes bridge to the native snapshot compiler (native/ccsnap.cpp).

The library is this package's own build of the checkout's
native/ccsnap.cpp: `build()` compiles it with the C++ compiler on PATH
(CXX, else g++; `-O2 -std=c++17 -fPIC -shared`, as the Makefile does) into
build/native/ at the checkout's root on first use, keyed by the source's
hash.  ClusterSnapshot.from_objects(use_native=True) aggregates through
it; its default is the pure-Python aggregation, which is faster at 10,000
nodes (PERF.md).  `available()` is False when no compiler is found or the
build fails, and use_native=True then raises (`build_error()` says why).
A differential test (tests/test_torch_native.py) keeps the two
implementations in lockstep.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "ccsnap.cpp")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None
_error: Optional[str] = None
_lock = threading.Lock()


class _CCSnapResult(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("n_resources", ctypes.c_int64),
        ("allocatable", ctypes.POINTER(ctypes.c_double)),
        ("requested", ctypes.POINTER(ctypes.c_double)),
        ("nonzero", ctypes.POINTER(ctypes.c_double)),
        ("node_names", ctypes.POINTER(ctypes.c_char)),
        ("node_names_len", ctypes.c_int64),
        ("resource_names", ctypes.POINTER(ctypes.c_char)),
        ("resource_names_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def build_dir() -> str:
    """Where the library is built: build/native/ at the checkout's root
    (listed in .gitignore)."""
    return os.path.join(_ROOT, "build", "native")


def build() -> str:
    """Compile native/ccsnap.cpp into build_dir() unless a build of the
    same source and flags is there; returns the library path.  Raises
    RuntimeError when there is no compiler or the compile fails."""
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()) \
        .hexdigest()[:16]
    lib = os.path.join(build_dir(), f"libccsnap_{digest}.so")
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH (set CXX) to build "
                           "native/ccsnap.cpp")
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    """The loaded library, built on first use; None (with build_error()
    set) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                from ..obs import recompile
                t0 = time.perf_counter()
                lib = ctypes.CDLL(build())
                recompile.record_compile(time.perf_counter() - t0)
                lib.ccsnap_compile.restype = ctypes.POINTER(_CCSnapResult)
                lib.ccsnap_compile.argtypes = [ctypes.c_char_p,
                                               ctypes.c_int64,
                                               ctypes.c_char_p]
                lib.ccsnap_free.argtypes = [ctypes.POINTER(_CCSnapResult)]
                _lib = lib
            except (OSError, RuntimeError) as e:
                _error = str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or before the
    first attempt)."""
    return _error


@dataclass
class CompiledArrays:
    node_names: List[str]
    resource_names: List[str]
    allocatable: np.ndarray     # f64[N, R]
    requested: np.ndarray       # f64[N, R]
    nonzero: np.ndarray         # f64[N, 2]


def compile_snapshot(objects: dict,
                     exclude_nodes: Sequence[str] = ()
                     ) -> Optional[CompiledArrays]:
    """Aggregate node/pod resource tensors natively.  Returns None when the
    library is unavailable (the caller uses the Python path); raises
    ValueError with the compiler's message on input it rejects."""
    lib = _load()
    if lib is None:
        return None
    payload = json.dumps({"nodes": objects.get("nodes") or [],
                          "pods": objects.get("pods") or []}).encode()
    res_p = lib.ccsnap_compile(payload, len(payload),
                               ",".join(exclude_nodes).encode())
    res = res_p.contents
    try:
        if res.error:
            raise ValueError(res.error.decode())
        n, r = res.n_nodes, res.n_resources
        alloc = np.ctypeslib.as_array(res.allocatable, shape=(n * r,)) \
            .reshape(n, r).copy() if n * r else np.zeros((n, r))
        req = np.ctypeslib.as_array(res.requested, shape=(n * r,)) \
            .reshape(n, r).copy() if n * r else np.zeros((n, r))
        nz = np.ctypeslib.as_array(res.nonzero, shape=(n * 2,)) \
            .reshape(n, 2).copy() if n else np.zeros((n, 2))
        names_blob = ctypes.string_at(res.node_names, res.node_names_len) \
            if res.node_names_len else b""
        res_blob = ctypes.string_at(res.resource_names,
                                    res.resource_names_len) \
            if res.resource_names_len else b""
        node_names = [s.decode() for s in names_blob.split(b"\0")[:-1]]
        resource_names = [s.decode() for s in res_blob.split(b"\0")[:-1]]
        return CompiledArrays(node_names=node_names,
                              resource_names=resource_names,
                              allocatable=alloc, requested=req, nonzero=nz)
    finally:
        lib.ccsnap_free(res_p)
