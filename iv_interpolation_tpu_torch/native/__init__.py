"""ctypes binding of the native host packer (``csrc/packer.cpp``), the
port of ``iv_interpolation_tpu/native``.

On first use the source is compiled with the host's C++ compiler
(``$CXX``, else ``g++``, else ``c++``) into ``build/native/`` at the
repository root, as ``libivtorch_packer_<hash>.so``: the hash covers the
source and the flags, so an edit rebuilds and an unchanged tree reuses
the library. The library is written under a temporary name and moved
into place, so processes that build at once (parallel test workers)
never load a half-written file. ``nvcc`` never sees this source
(``_build.sources`` takes ``.cu``/``.cuh`` only).

As in the JAX package, each entry point reports whether the native path
ran (``scatter_pack`` returns False and ``gather_unpack`` None where the
library cannot be built or the dtype is not float32), and the caller
then takes NumPy; ``build_error`` says why the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libivtorch_packer_{digest.hexdigest()[:16]}.so"


def _compiler() -> Optional[str]:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def build() -> Path:
    """Compile the packer unless the library for this source exists;
    raises with the compiler's output when it cannot."""
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found ($CXX, g++, c++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.scatter_pack.argtypes = [p, p, p, p, i64, i64, i64, p, p]
        lib.gather_unpack.argtypes = [p, p, p, i64, i64, i64, p]
        lib.scatter_pack.restype = lib.gather_unpack.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def scatter_pack(colmat: np.ndarray, row_sym: np.ndarray,
                 row_pos: np.ndarray, on_grid: np.ndarray,
                 values: np.ndarray, obs_mask: np.ndarray) -> bool:
    """Scatter observation rows into (B, C, L) grids in place:
    ``values[row_sym[r], :, row_pos[r]] = colmat[r]`` and
    ``obs_mask[row_sym[r], row_pos[r]] = True`` for each row with
    ``on_grid[r]``.

    Returns True if the native path ran; False means the caller must use
    NumPy. ``values`` and ``colmat`` must be float32, ``values`` and
    ``obs_mask`` (bool or uint8) C-contiguous.
    """
    lib = _load()
    if (lib is None or colmat.dtype != np.float32
            or values.dtype != np.float32):
        return False
    if not (values.flags.c_contiguous and obs_mask.flags.c_contiguous):
        raise ValueError("values and obs_mask must be C-contiguous")
    colmat = np.ascontiguousarray(colmat)
    row_sym = np.ascontiguousarray(row_sym, np.int32)
    row_pos = np.ascontiguousarray(row_pos, np.int64)
    on_grid = np.ascontiguousarray(on_grid, np.uint8)
    R, C = colmat.shape
    B, _, L = values.shape
    if (values.shape[1] != C or obs_mask.shape != (B, L)
            or not len(row_sym) == len(row_pos) == len(on_grid) == R):
        raise ValueError(f"shapes do not match: colmat {colmat.shape}, rows {len(row_sym)}, "
                         f"{len(row_pos)}, {len(on_grid)}, values {values.shape}, "
                         f"obs_mask {obs_mask.shape}")
    _check_bounds(row_sym[on_grid != 0], row_pos[on_grid != 0], B, L)
    lib.scatter_pack(colmat.ctypes.data, row_sym.ctypes.data, row_pos.ctypes.data,
                     on_grid.ctypes.data, R, C, L,
                     values.ctypes.data, obs_mask.view(np.uint8).ctypes.data)
    return True


def _check_bounds(sym: np.ndarray, pos: np.ndarray, B: int, L: int) -> None:
    """The native loops index without checks: every (symbol, slot) they
    touch must lie inside the (B, L) grid."""
    if len(sym) and (sym.min() < 0 or sym.max() >= B or pos.min() < 0 or pos.max() >= L):
        raise IndexError(f"grid index out of range for a ({B}, {L}) grid")


def gather_unpack(values: np.ndarray, out_sym: np.ndarray,
                  out_pos: np.ndarray) -> Optional[np.ndarray]:
    """(N, C) rows ``values[out_sym, :, out_pos]`` of (B, C, L) float32
    grids; None where the native path cannot run (the caller uses NumPy)."""
    lib = _load()
    if lib is None or values.dtype != np.float32:
        return None
    values = np.ascontiguousarray(values)
    out_sym = np.ascontiguousarray(out_sym, np.int32)
    out_pos = np.ascontiguousarray(out_pos, np.int64)
    N = out_sym.shape[0]
    B, C, L = values.shape
    if out_pos.shape != (N,):
        raise ValueError(f"{N} symbols but {out_pos.shape} slots")
    _check_bounds(out_sym, out_pos, B, L)
    out = np.empty((N, C), np.float32)
    lib.gather_unpack(values.ctypes.data, out_sym.ctypes.data, out_pos.ctypes.data,
                      N, C, L, out.ctypes.data)
    return out
