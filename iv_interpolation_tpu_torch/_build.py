"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources are ``csrc/*.cu`` (and any ``*.cuh``) in this package. On
first use, :func:`load_library` compiles them with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` a source, all started together, and links the
objects into one shared library with a plain C interface under
``build/kernels/`` at the repository root. The library's file name holds
a hash of the sources and the compiler flags, so an edit to either
forces a rebuild and an unchanged tree reuses the library on disk.

Nothing here runs at import: importing the package on a machine without
``nvcc`` or a card is fine, and only a kernel launch on a CUDA tensor
reaches :func:`load_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xptxas=-v",  # registers, shared memory and spills land in the log
    "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libivtorch_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built with the CUDA toolkit")
    return found


def build() -> tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists.

    Each ``.cu`` compiles in its own ``nvcc``, all at once, and one more
    ``nvcc`` links the objects. Returns the library path and the seconds
    spent building (0.0 when the library was already on disk). The
    compilers' output, including ptxas's register, shared-memory and spill
    report, is kept beside the library as ``<name>.log``.
    """
    lib = library_path()
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    tmp = lib.with_name(f"{tag}.tmp.so")
    cu = [p for p in sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cu]
    logs = [o.with_suffix(".log") for o in objs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, obj, log in zip(cu, objs, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                          stdout=out, stderr=subprocess.STDOUT))
    codes = [proc.wait() for proc in procs]
    text = "".join(f"== {src.name}\n{log.read_text()}" for src, log in zip(cu, logs))
    if all(code == 0 for code in codes):
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        codes.append(proc.returncode)
        text += f"== link\n{proc.stdout}{proc.stderr}"
    seconds = time.perf_counter() - t0
    lib.with_suffix(".log").write_text(text)
    for path in (*objs, *logs):
        path.unlink(missing_ok=True)
    if any(codes):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit codes {codes}):\n{text[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, seconds


def pin_precision() -> None:
    """Full float32 in every product on the card, checked.

    The E2 (second-derivative) operator entries scale like 1/h^2 (about
    +-600 at n=50 on [-1, 1]); TF32 or any reduced-precision product
    rounds them enough to flip the sign of butterfly g on clean smiles.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("could not pin float32 matmul precision")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        # dl, d, du, b, x, n, batch, systems a block, stream
        "ivt_thomas_staged_f32": [p] * 5 + [i, ll, i, p],
        "ivt_thomas_staged_f64": [p] * 5 + [i, ll, i, p],
        # dl, d, du, b, x, c' scratch, n, batch, stream
        "ivt_thomas_scratch_f32": [p] * 6 + [i, ll, p],
        "ivt_thomas_scratch_f64": [p] * 6 + [i, ll, p],
        # 7 inputs, 7 outputs, B, L, num_segments, bucket_minutes,
        # base_bucket, min_count, tile, threads, stream
        "ivt_stream_agg_i32": [p] * 14 + [i, i, i, ll, ll, i, i, i, p],
        "ivt_stream_agg_i64": [p] * 14 + [i, i, i, ll, ll, i, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i


def load_library() -> ctypes.CDLL:
    """Build (first use only), load and declare the kernel library, and
    pin matmul precision."""
    global _lib
    with _lock:
        if _lib is None:
            pin_precision()
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
    return _lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")
