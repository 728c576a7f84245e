"""Native (C++) host-side components, loaded through ctypes.

* ``fill_ref(a, N, M)`` -- long-double reference Stirling fill: the
  beyond-f64 verification oracle for the JAX fills (stable.c
  recurrence semantics; see stb_ref.cpp).
* ``crp_generate(...)`` -- native CRP data simulation (demo.c:284-311
  semantics), replacing the Python loop in models/pyp.py for large
  workloads.

The shared library builds on first use (g++, ~1 s) and caches next to
this file; ``available()`` reports whether a toolchain/binary exists so
callers can fall back to the Python paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "stb_ref.cpp")
_SO = os.path.join(_DIR, "_stb_ref.so")
_lib = None


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _SO, _SRC],
            check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    lib = ctypes.CDLL(_SO)
    lib.stb_fill_ref.argtypes = [
        ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    lib.stb_fill_ref.restype = None
    lib.stb_crp_generate.argtypes = [
        ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
    lib.stb_crp_generate.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def fill_ref(a: float, n_max: int, m_max: int,
             want_logs: bool = True, want_v: bool = True,
             want_s1: bool = True):
    """Long-double reference fill; returns (logS, V, S1) (None if not
    requested).  Layout matches core/stirling.py: [n-1, m-1]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native toolchain unavailable")
    logS = np.empty((n_max, m_max), np.float64) if want_logs else None
    V = np.empty((n_max, m_max), np.float64) if want_v else None
    S1 = np.empty((n_max,), np.float64) if want_s1 else None

    def ptr(x):
        return (x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
                if x is not None else None)

    lib.stb_fill_ref(float(a), n_max, m_max, ptr(logS), ptr(V), ptr(S1))
    return logS, V, S1


def crp_generate(seed: int, n_groups: int, dim: int, n_per_group: int,
                 a: float, b: float, H: Optional[np.ndarray] = None,
                 return_latent: bool = False):
    """Native CRP simulation; returns a models.pyp.PYPData.

    ``return_latent=True`` additionally returns the generator's latent
    table counts: (data, t, T) with t (J, D) and T (J,) -- used by
    statistical tests against the known PYP E[T] formula."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native toolchain unavailable")
    from ..models import pyp

    L = n_groups * n_per_group
    n = np.zeros((n_groups, dim), np.int32)
    t = np.zeros((n_groups, dim), np.int32)
    T = np.zeros((n_groups,), np.int32)
    cats = np.zeros((L,), np.int32)
    grps = np.zeros((L,), np.int32)
    firsts = np.zeros((L,), np.uint8)
    Harr = None
    hptr = None
    if H is not None:
        Harr = np.ascontiguousarray(np.asarray(H, np.float64))
        hptr = Harr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.stb_crp_generate(
        seed, n_groups, dim, n_per_group, float(a), float(b), hptr,
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        T.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        grps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        firsts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    Hout = (Harr if Harr is not None
            else np.full(dim, 1.0 / dim, np.float64))
    data = pyp.PYPData(cats, grps, firsts.astype(bool), n,
                       n.sum(axis=1).astype(np.int32), Hout)
    if return_latent:
        return data, t, T
    return data
