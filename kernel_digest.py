#!/usr/bin/env python3
"""Digests of kernels' outputs at ``chip_smoke.py``'s phase-3 and
``[dd-kernels]`` cases, on one NVIDIA GPU, to check that a rebuilt kernel
gives another build's bits, or their phase-3 times on another build:

    python3 kernel_digest.py burgers1d_newton [--package=DIR] [--csrc=DIR] [--time]

The cases (inputs from chip_smoke's seeds) come from this checkout's
``chip_smoke.py``; the kernels from the ``pymgrit_tpu_torch`` under DIR
(default: this checkout), which builds its own library under DIR.  Each
case prints one line, ``[digest] kernel | case | dtype | sha256[:16]`` of
the bytes of what one kernel call returns (float64 and float32); run two
builds and compare the lines.  With ``--time``, this checkout's phase 3
runs for the named kernels instead (its checks, times, device times,
bounds and latency floors).  With ``--csrc=DIR``, the library is built
from the ``.cu`` and ``.cuh`` files under DIR alone (a patched copy of
some of ``csrc/``: a build variant) and binds the launchers they define.
Needs a CUDA device.
"""

import hashlib
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
PACKAGE = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--package=")), None)
CSRC = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--csrc=")), None)
sys.path.insert(0, str(Path(PACKAGE).resolve()) if PACKAGE is not None else str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# this checkout's chip_smoke.py, whatever DIR holds
_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def digest(out):
    parts = (out.hi, out.lo) if hasattr(out, "hi") else (out,)
    h = hashlib.sha256()
    for t in parts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def use_csrc(path):
    """Build the library from the sources under ``path`` and bind only the
    launchers they define (``pm_NAME(`` in a source: NAME_f32 and NAME_f64,
    or NAME itself)."""
    from pymgrit_tpu_torch.ops import _build
    text = "".join(f.read_text() for f in Path(path).glob("*.cu"))
    _build.CSRC = Path(path).resolve()
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items() if f"{k}_f64(" in text}
    _build._DD_SIGNATURES = {k: v for k, v in _build._DD_SIGNATURES.items() if f"{k}(" in text}


def main():
    names = [a for a in sys.argv[1:] if not a.startswith("--")]
    chip_smoke.check(torch.cuda.is_available() and names, "usage: kernel_digest.py KERNEL... "
                     "[--package=DIR] [--csrc=DIR] [--time] on a CUDA device")
    import pymgrit_tpu_torch
    from pymgrit_tpu_torch.ops import DISPATCH
    if CSRC is not None:
        use_csrc(CSRC)
    print(f"[digest] package {Path(pymgrit_tpu_torch.__file__).resolve().parent} | "
          f"sources {CSRC or 'csrc/'} | {torch.cuda.get_device_name(0)}")
    if "--time" in sys.argv[1:]:
        torch.backends.cuda.matmul.allow_tf32 = False
        chip_smoke.phase_kernels(names)
        return
    dev = torch.device("cuda")
    for dtype in (torch.float64, torch.float32):
        stash = {}
        for kernel, case, run in chip_smoke.kernel_cases(dtype, dev, stash):
            if kernel in names:
                out = run(DISPATCH)
                torch.cuda.synchronize()
                print(f"[digest] {kernel} | {case} | {str(dtype)[6:]} | {digest(out)}")
    rng = np.random.default_rng(chip_smoke.SEED + 8)
    for kernel, case, run in chip_smoke.dd_cases(dev, rng, {}):
        if kernel in names:
            out = run(DISPATCH)
            torch.cuda.synchronize()
            print(f"[digest] {kernel} | {case} | float32 pairs | {digest(out)}")


if __name__ == "__main__":
    main()
