"""fp64 oracles: a ctypes binding for the C++/OpenMP one (nbody_oracle.cpp)
and its NumPy twins.

The native library is built with g++ on first use (cached next to the
source, which .gitignore lists; rebuilt when the source is newer). Callers
check ``available()`` and use the NumPy fp64 oracle (``numpy_body_force``,
``numpy_euler_steps``), which needs no build, otherwise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "nbody_oracle.cpp"
_LIB = _HERE / "libnbody_oracle.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        str(_SRC), "-o", str(_LIB),
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"build failed to launch: {e}"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr[-500:]}"
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build_error = _build()
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(str(_LIB))
        lib.body_force_f64.restype = None
        lib.body_force_f64.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.potential_energy_f64.restype = ctypes.c_double
        lib.potential_energy_f64.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_double, ctypes.c_int64,
        ]
        lib.euler_steps_f64.restype = None
        lib.euler_steps_f64.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def body_force_oracle(pos_i, pos_j, mass_j=None, softening: float = 1e-9) -> np.ndarray:
    """fp64 all-pairs forces via the native oracle (raises if unavailable)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_build_error}")
    pi = _as_f32(pos_i)
    pj = _as_f32(pos_j)
    ni, nj = pi.shape[0], pj.shape[0]
    out = np.empty((ni, 3), np.float64)
    # Keep the converted mass array alive past the C call: _fptr(_as_f32(m))
    # alone drops the only reference to the conversion before ctypes runs.
    m = _as_f32(mass_j) if mass_j is not None else None
    mp = _fptr(m) if m is not None else None
    lib.body_force_f64(
        _fptr(pi), _fptr(pj), mp, ctypes.c_double(softening),
        ni, nj, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def potential_energy_oracle(pos, mass=None, softening: float = 1e-9) -> float:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_build_error}")
    p = _as_f32(pos)
    m = _as_f32(mass) if mass is not None else None  # keep alive (see above)
    mp = _fptr(m) if m is not None else None
    return float(
        lib.potential_energy_f64(_fptr(p), mp, ctypes.c_double(softening),
                                 p.shape[0])
    )


def euler_steps_oracle(pos, vel, mass=None, dt: float = 0.01, steps: int = 10,
                       softening: float = 1e-9):
    """Reference trajectory: `steps` semi-implicit Euler steps with fp64
    forces and fp32 state (upstream mini-nbody semantics: v += dt*F;
    x += dt*v). Returns (pos, vel) float32 arrays."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_build_error}")
    p = _as_f32(pos).copy()
    v = _as_f32(vel).copy()
    n = p.shape[0]
    m = _as_f32(mass) if mass is not None else None  # keep alive (see above)
    mp = _fptr(m) if m is not None else None
    scratch = np.empty((n, 3), np.float64)
    lib.euler_steps_f64(
        _fptr(p), _fptr(v), mp, ctypes.c_double(softening),
        ctypes.c_double(dt), n, steps,
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return p, v


def numpy_body_force(pos_i, pos_j, mass_j=None, softening: float = 1e-9,
                     budget: int = 1 << 24) -> np.ndarray:
    """fp64 all-pairs forces on pos_i from (pos_j, mass_j) in NumPy, the
    receivers in row chunks of at most ``budget`` pairs (bounded memory at
    any N; no build)."""
    pi = np.asarray(pos_i, np.float64)
    pj = np.asarray(pos_j, np.float64)
    m = (np.ones(pj.shape[0]) if mass_j is None
         else np.asarray(mass_j, np.float64))
    rows = max(1, budget // max(pj.shape[0], 1))
    out = np.empty((pi.shape[0], 3), np.float64)
    for a in range(0, pi.shape[0], rows):
        d = pj[None, :, :] - pi[a:a + rows, None, :]
        r2 = np.einsum("ijk,ijk->ij", d, d) + softening
        w = r2 ** -1.5 * m[None, :]
        out[a:a + rows] = np.einsum("ijk,ij->ik", d, w)
    return out


def numpy_euler_steps(pos, vel, mass=None, dt: float = 0.01, steps: int = 10,
                      softening: float = 1e-9):
    """fp64 semi-implicit Euler (v += dt*F; x += dt*v), fp64 state
    throughout. Returns (pos, vel) float64 arrays."""
    p = np.asarray(pos, np.float64).copy()
    v = np.asarray(vel, np.float64).copy()
    for _ in range(steps):
        v += dt * numpy_body_force(p, p, mass, softening)
        p += dt * v
    return p, v


# Used by tests to report why the oracle is missing.
def build_error() -> Optional[str]:
    _load()
    return _build_error
