"""Build and load the CUDA C++ kernels (K1 interval_affine, K2 theta_chain,
K3 residual_row_norms, K4 cpoint_combine, K5 sine_solve2d, K6
sine_affine2d, K7 theta_rhs2d, K8 affine_prefix, K9 affine_windows, K10
periodic_solve2d, K11 allen_cahn_pointwise, K12 dopri45_arenstorf, K13
rk4_brusselator, K14 gray_scott_pointwise, K15 burgers2d_pointwise, K16
burgers1d_newton, K17 circulant_solve1d, K18 restrict_combine, K19
interpolate_combine, K20 sine_solve1d, K21 indexed_combine, K22 eig_step,
K23 dd_interval_affine, K24 dd_theta_chain, K25 dd_arith, K26 dd_matmul):
every kernel of the port.

The sources under ``csrc/`` have a plain C interface.  On first use each
``.cu`` file is compiled by its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library, ``build/kernels/<hash>/libpymgrit_kernels.so`` under the
repository root, keyed by a hash of the sources, headers and flags, and
loaded with ``ctypes``.  A missing ``nvcc`` or a failed build raises: there
is no other route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# argtypes of the exported launchers (f32 and f64 share one signature shape)
_SIGNATURES = {
    "pm_interval_affine": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P],
    # the packed argument array, theta, 1 - theta, the stream
    "pm_theta_chain": [_P, _D, _D, _P],
    # the packed argument array, the scalar shift, the stream
    "pm_sine_solve2d": [_P, _D, _P],
    # the packed argument array, the stream
    "pm_sine_affine2d": [_P, _P],
    # the packed argument array, dt, theta, fx, fy, the stream
    "pm_theta_rhs2d": [_P, _D, _D, _D, _D, _P],
    "pm_affine_prefix": [_P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    # the packed argument array, the stream
    "pm_affine_windows": [_P, _P],
    # the packed argument array, the prologue's two scalars, the stream
    "pm_periodic_solve2d": [_P, _D, _D, _P],
    "pm_dopri45_arenstorf": [_P, _I, _P, _P, _P, _I, _I, _P, _I, _I, _P, _D, _D, _D, _I, _I, _I,
                             _P],
    # the packed argument array, the stream
    "pm_rk4_brusselator": [_P, _P],
    "pm_burgers1d_newton": [_P, _I, _P, _P, _I, _I, _P, _I, _I, _P, _P, _D, _D, _D, _D, _D, _I,
                            _I, _I, _I, _P],
    # the packed argument array, fac, the stream
    "pm_circulant_solve1d": [_P, _D, _P],
    "pm_eig_step": [_P, _P],
    # the packed argument array, the stream
    "pm_sine_solve1d": [_P, _P],
    # one packed int64 argument array, the coefficients by value, the stream
    "pm_restrict_combine": [_P, _D, _D, _D, _D, _D, _P],
    # the packed argument array, dst, a, b, the stream
    "pm_interpolate_combine": [_P, _P, _P, _P, _P],
    "pm_indexed_combine": [_P, _D, _D, _D, _P],
    "pm_cpoint_combine": [_P, _D, _D, _D, _P],
    # the packed argument array, s, u, out, the stream
    "pm_residual_row_norms": [_P, _P, _P, _P, _P],
    # the packed argument array, 1/eps^2, dx^2, the stream
    "pm_allen_cahn_pointwise": [_P, _D, _D, _P],
    # the packed argument array, du, dv, a, b, dx^2, the stream
    "pm_gray_scott_pointwise": [_P, _D, _D, _D, _D, _D, _P],
    # the packed argument array, nu, 2 dx, dx^2, the stream
    "pm_burgers2d_pointwise": [_P, _D, _D, _D, _P],
}
# the float32-pair (double-double) launchers: one symbol each, no dtype suffix
_DD_SIGNATURES = {
    # the packed argument array, the float arguments (immediates,
    # coefficients), the stream
    "pm_dd_arith": [_P, _P, _P],
    # the packed argument array, the stream
    "pm_dd_interval_affine": [_P, _P],
    # the packed argument array, theta, the stream
    "pm_dd_theta_chain": [_P, _D, _P],
    "pm_dd_matmul": [_P, _P],
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
    for s in sorted(CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libpymgrit_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, pid = _nvcc(), os.getpid()
        t0 = time.perf_counter()
        objs = [out_dir / f"{s.stem}.{pid}.o" for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [(s.name, p.communicate()[0], p.returncode) for s, p in zip(sources, procs)]
        tmp = out_dir / f"libpymgrit_kernels.{pid}.so"
        failed = [(name, log) for name, log, rc in logs if rc != 0]
        link = None
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(("link", link.stdout + link.stderr))
        build_seconds = time.perf_counter() - t0
        (out_dir / "build.log").write_text(
            "".join(f"== {name}\n{log}" for name, log, _ in logs)
            + (f"== link\n{link.stdout}{link.stderr}" if link is not None else ""))
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{log}" for n, log in failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    symbols = {f"{name}_{suffix}": args for name, args in _SIGNATURES.items()
               for suffix in ("f32", "f64")}
    for name, args in {**symbols, **_DD_SIGNATURES}.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    _lib, _lib_dir = lib, out_dir
    return lib


def build_log() -> str:
    """ptxas output (registers, spills) of the current build, if built here."""
    library()
    log = _lib_dir / "build.log"
    return log.read_text() if log.exists() else ""


def stream(index: int) -> int:
    """The raw cudaStream_t of the current stream of CUDA device ``index``
    (what ``torch.cuda.current_stream(d).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    """The shared memory one block of CUDA device ``index`` may opt in to,
    in bytes (read once)."""
    import torch
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def check(status: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
