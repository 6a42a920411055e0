"""Build and load the CUDA C++ kernels (K1 interval_affine, K2 theta_chain).

The sources under ``csrc/`` have a plain C interface.  On first use they
are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared library,
``build/kernels/<hash>/libpymgrit_kernels.so`` under the repository root,
keyed by a hash of the sources and flags, and loaded with ``ctypes``.
A missing ``nvcc`` or a failed build raises: there is no other route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int64
# argtypes of the exported launchers (f32 and f64 share one signature shape)
_SIGNATURES = {
    "pm_interval_affine": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P],
    "pm_theta_chain": [_P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                       ctypes.c_double, _I, _I, _I, _P],
}

_lib = None
_lib_dir = None
build_seconds = None     # wall time of the build in this process (None: cached)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _lib_dir, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libpymgrit_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libpymgrit_kernels.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s" % (proc.returncode, proc.stderr))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    _lib, _lib_dir = lib, out_dir
    return lib


def build_log() -> str:
    """ptxas output (registers, spills) of the current build, if built here."""
    library()
    log = _lib_dir / "build.log"
    return log.read_text() if log.exists() else ""


def check(status: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
