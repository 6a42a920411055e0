#!/usr/bin/env python3
"""Smoke run of ``pymgrit_tpu_torch`` on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main path -- TOMS example 3: Heat2D 129x129, backward
Euler, spectral basis, nt = 16385, five levels with coarsening 32/16/4/4,
FCF-relaxation, V-cycles, nested iteration, condensed level-0 carry,
``Mgrit.solve_compiled()`` -- in float64 on the card, in phases:

1. device   the card's name and power limit (nvidia-smi); a CUDA device is
            required, there is no CPU carry-on;
2. build    nvcc builds the CUDA C++ kernels (K1, K2) from ``csrc/``;
3. kernels  K1-K4 against their plain PyTorch versions at the main path's
            shapes, float32 and float64, with timings;
4. small    Heat2D nx=17, nt=129, ms=(4, 4): the port on the CPU (plain
            versions) against the port on the GPU (kernels);
5. main     the full TOMS solve through the kernels: launch counts, history,
            agreement with the plain versions on the GPU, the materialized
            tube against a sequential time march, wall times, steps/s.

Each phase prints one line (phase 3 one per case); any failure raises and
exits non-zero.  The line before the last is the card again; the last line
is the JSON result.  Numbers are measured in this run on this card.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20240917
DEVICE = "cuda"     # every tensor of phases 3-5 lives here

TOMS = dict(nx=129, nt=2 ** 14 + 1, ms=(32, 16, 4, 4))
SMALL = dict(nx=17, nt=129, ms=(4, 4))
MAIN_TOL, MAIN_MAX_ITER = 1e-10, 30
SMALL_MAX_ITER = 5

# Kernel against plain version, normwise: max|k - p| / max|p|.  The kernels
# contract a*b + c into one FMA (nvcc's default --fmad=true, Triton's fp
# fusion) and K3 sums in another order, so they agree with the plain
# versions to rounding, not bitwise: a few ulp per operation, at most L = 15
# sequential steps (K2) or a blocked sum of 16129 terms (K3).
KERNEL_RTOL = {"float64": 1e-13, "float32": 1e-5}
# Small config, CPU plain against GPU kernels: histories to rtol 1e-10, with
# an atol at the float64 residual floor (FMA moves each residual by ulps).
SMALL_RTOL = 1e-10
# Main path, GPU kernels against GPU plain versions: rtol 1e-9, with the same
# floor as atol.
MAIN_RTOL = 1e-9
FLOOR_OPS = 8      # rounded operations per residual entry in the floor bound


def fail(msg):
    raise SystemExit("chip_smoke FAILED: " + msg)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# problem setup (the bench's TOMS problem, built per level like bench.py)
# ---------------------------------------------------------------------------

def rhs(x, y, t):
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.ones_like(t * x * y)


def init_cond(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y)


def build_problem(P, nx, nt, ms, device, ops, method="BE"):
    t = np.linspace(0, 1, nt)
    problem, stride = [], 1
    for lvl in range(len(ms) + 1):
        problem.append(P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=nx,
                                a=1.0, rhs=rhs, init_cond=init_cond, t_interval=t[::stride],
                                basis="spectral", method=method, device=device, ops=ops))
        if lvl < len(ms):
            stride *= ms[lvl]
    return problem


def count_fine_steps_per_iter(mgrit, first):
    """Fine-level Phi evaluations per MGRIT iteration (bench.py's count)."""
    info = mgrit.levels[0]
    nf = info.fpts.size
    nc1 = info.cpts.size - 1
    steps = nf if first else 0
    steps += mgrit.cf_iter[0] * (nc1 + nf)
    return steps + nc1 + nf + nc1


def residual_floor(mgrit):
    """float64 floor of the residual history: FLOOR_OPS roundings of every
    C-point value, in the 2-norm over C-points and coefficients."""
    import torch
    info = mgrit.levels[0]
    u_c = mgrit.u[0][0:info.nt:info.m]
    return FLOOR_OPS * float(torch.finfo(torch.float64).eps) * float(torch.linalg.vector_norm(u_c))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed: " + smi.stderr)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    import pymgrit_tpu_torch
    pkg = Path(pymgrit_tpu_torch.__file__).resolve().parent
    check(pkg == ROOT / "pymgrit_tpu_torch", f"imported {pkg}, not the package beside this script")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    return card


def phase_build():
    import triton
    from pymgrit_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln]
    print(f"[build] nvcc sm_90a libpymgrit_kernels.so in {seconds:.2f} s "
          f"(nvcc {_build.build_seconds}) | triton {triton.__version__} | ptxas: {' ; '.join(regs)}")


def cuda_ms(fn, reps=20):
    """Median ms of one call, CUDA events around each call (after one warm
    call); includes the wrapper's host time where the card waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def kernel_cases(dtype, dev):
    """(kernel, case, run(ops) -> output tensor) at the main path's shapes:
    N = 127^2 coefficients and J = 512 level-0 intervals (K1), level-1
    F-relaxation J = 32, L = 15 and the coarsest solve J = 1, L = 2 (K2),
    512 C-rows (K3, K4)."""
    import torch
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
    rng = np.random.default_rng(SEED)
    n, nt0, ms = TOMS["nx"] - 2, TOMS["nt"], TOMS["ms"]
    N, m0 = n * n, ms[0]
    J = (nt0 - 1) // m0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    _, lam1 = sine_eigenbasis(n, (n + 1.0) ** 2)
    lam = t((lam1[:, None] + lam1[None, :]).reshape(-1))
    cases = []

    # K1 interval_affine: tables (T, N), T = m-1 (F-sweep, materialize) and
    # T = m (condensed C-step); the seeds are the level-0 C-rows.
    seeds = t(rng.uniform(-1, 1, (J, N)))
    for T in (m0 - 1, m0):
        A, G = t(rng.uniform(0, 1, (T, N))), t(rng.uniform(-1, 1, (T, N)))

        def row_major(k, A=A, G=G, T=T):
            out = torch.empty((T, J, N), dtype=dtype, device=dev)
            k.interval_affine(seeds, A, G, out.transpose(0, 1), 0)
            return out

        def interval_major(k, A=A, G=G, T=T):
            out = torch.empty((J, T, N), dtype=dtype, device=dev)
            return k.interval_affine(seeds, A, G, out, 0)

        def only_last(k, A=A, G=G, T=T):
            out = torch.empty((1, J, N), dtype=dtype, device=dev)
            k.interval_affine(seeds, A, G, out.transpose(0, 1), T - 1)
            return out

        cases += [("interval_affine", f"T={T} row-major", row_major),
                  ("interval_affine", f"T={T} interval-major", interval_major),
                  ("interval_affine", f"T={T} only_last", only_last)]
        if T == m0 - 1:
            seeds_c = t(rng.uniform(-1, 1, (J + 1, N)))

            def materialize(k, A=A, G=G):
                tube = torch.empty((nt0, N), dtype=dtype, device=dev)
                blocks = tube[:J * m0].view(J, m0, N)
                k.interval_affine(seeds_c[:J], A, G, blocks[:, 1:], 0, blocks[:, 0])
                tube[nt0 - 1].copy_(seeds_c[J])
                return tube

            cases.append(("interval_affine", "materialize", materialize))

    # K2 theta_chain: chains read their seeds from C-rows and write the
    # F-rows of a level tube (strided views); the rhs is time-independent.
    # (J, L, m, theta, g?, dt): level-1 F-relaxation in BE and CN, the
    # coarsest forward solve, a one-step Phi of the level-1 C-rows
    # (C-relaxation, FAS).
    lift, rhs_row = t(rng.uniform(-1, 1, N)), t(rng.uniform(-1, 1, N))
    m1, dt1 = ms[1], m0 / (nt0 - 1)
    J1 = J // m1
    dtc = float(np.prod(ms)) / (nt0 - 1)
    nt_c = (nt0 - 1) // int(np.prod(ms)) + 1
    for Jc, L, m, theta, with_g, step in ((J1, m1 - 1, m1, 1.0, True, dt1),
                                          (J1, m1 - 1, m1, 0.5, True, dt1),
                                          (1, nt_c - 1, nt_c, 1.0, True, dtc),
                                          (J1, 1, m1, 1.0, False, dt1)):
        nt = Jc * m + 1
        u_tube = t(rng.uniform(-1, 1, (nt, N)))
        g_tube = t(rng.uniform(-1e-3, 1e-3, (nt, N)))
        dt = t(np.full((L, Jc), step))
        rhs1 = rhs_row.expand(L, Jc, N)

        def chain(k, Jc=Jc, L=L, m=m, theta=theta, with_g=with_g, u_tube=u_tube,
                  g_tube=g_tube, dt=dt, rhs1=rhs1, nt=nt):
            out_tube = torch.empty_like(u_tube)
            out = out_tube[1:nt].view(Jc, m, N)[:, :L]
            g = g_tube[1:nt].view(Jc, m, N)[:, :L] if with_g else None
            k.theta_chain(u_tube[0:nt - 1:m], out, dt, lam, lift, rhs1, rhs1, theta, g)
            return out.clone()

        kind = "BE" if theta == 1.0 else "CN"
        label = f"J={Jc} L={L} {kind}{' +g' if with_g else ''}"
        if (Jc, L, theta, with_g) == (J1, m1 - 1, 1.0, True):
            label = "level-1 F-relax " + label
        cases.append(("theta_chain", label, chain))

    # K3 residual_row_norms / K4 cpoint_combine on 512 C-rows of a tube
    a, b, c = (t(rng.uniform(-1, 1, (J + 1, N))) for _ in range(3))
    cases.append(("residual_row_norms", "C-rows", lambda k: k.residual_row_norms(a[1:], b[:J])))
    cases.append(("cpoint_combine", "FAS g_tail",
                  lambda k: k.cpoint_combine(torch.empty((J, N), dtype=dtype, device=dev),
                                             [a[1:], b[:J], c[1:]], [1.0, -1.0, 1.0])))
    strided = t(rng.uniform(-1, 1, (2 * J, N)))
    cases.append(("cpoint_combine", "weighted C strided",
                  lambda k: k.cpoint_combine(torch.empty((J, N), dtype=dtype, device=dev),
                                             [strided[1::2], strided[0::2]], [1.3, -0.3])))

    def in_place(k):
        dst = a[1:].clone()
        return k.cpoint_combine(dst, [dst, b[:J]], [1.0, 1.0])

    cases.append(("cpoint_combine", "correction in place", in_place))
    return cases


def phase_kernels():
    """Every kernel against its plain version; returns the per-kernel rows
    of the JSON summary (float64, the main path's dtype)."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN
    dev = torch.device(DEVICE)
    # the case whose time the summary reports: the kernel's largest call on
    # the main path
    headline = {"interval_affine": "materialize", "theta_chain": "level-1 F-relax",
                "residual_row_norms": "C-rows", "cpoint_combine": "FAS g_tail"}
    rows = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for kernel, case, run in kernel_cases(dtype, dev):
            out_k = run(DISPATCH)
            torch.cuda.synchronize()
            out_p = run(PLAIN)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out_k).all()), f"{kernel} {case} {dname}: non-finite output")
            abs_err = float((out_k - out_p).abs().max())
            rel = abs_err / max(float(out_p.abs().max()), 1e-300)
            del out_k, out_p
            ms_k, ms_p = cuda_ms(lambda: run(DISPATCH)), cuda_ms(lambda: run(PLAIN))
            ok = rel <= KERNEL_RTOL[dname]
            print(f"[kernels] {kernel:<18} {case:<34} {dname} rel {rel:.3e} "
                  f"(tol {KERNEL_RTOL[dname]:.0e}) abs {abs_err:.3e} | kernel {ms_k:.4f} ms "
                  f"plain {ms_p:.4f} ms | {'ok' if ok else 'FAIL'}")
            check(ok, f"{kernel} {case} {dname}: rel err {rel:.3e} > {KERNEL_RTOL[dname]:.0e}")
            if dtype == torch.float64 and case.startswith(headline[kernel]):
                rows[kernel] = dict(max_abs_err=abs_err, ms=ms_k, plain_ms=ms_p)
        torch.cuda.empty_cache()
    return rows


def solve_history(P, ops, device, nx, nt, ms, tol, max_iter):
    mg = P.Mgrit(problem=build_problem(P, nx, nt, ms, device, ops), tol=tol,
                 max_iter=max_iter, logging_lvl=30)
    check(mg._condensed0, "the condensed level-0 carry was declined: " + str(mg._cnd_decline_reason))
    return mg, mg.solve_compiled()["conv"]


def phase_small():
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH
    cpu, hc = solve_history(P, DISPATCH, "cpu", tol=MAIN_TOL, max_iter=SMALL_MAX_ITER, **SMALL)
    gpu, hg = solve_history(P, DISPATCH, DEVICE, tol=MAIN_TOL, max_iter=SMALL_MAX_ITER, **SMALL)
    atol = max(1e-14, residual_floor(cpu))
    check(hc.shape == hg.shape, f"small: {hc.size} CPU iterations against {hg.size} on the GPU")
    err = np.abs(hg - hc)
    ok = bool(np.all(err <= atol + SMALL_RTOL * np.abs(hc)))
    du = float((gpu.u[0].cpu() - cpu.u[0]).abs().max())
    print(f"[small] {SMALL} BE f64: {hg.size} iterations, last {hg[-1]:.6e}, "
          f"max |gpu-cpu| {err.max():.3e} (rtol {SMALL_RTOL:.0e}, atol {atol:.2e}), "
          f"tube max |gpu-cpu| {du:.3e} | {'ok' if ok else 'FAIL'}")
    check(ok, "small config: GPU history differs from the CPU history")
    check(du <= 1e-10, f"small config: GPU tube differs from the CPU tube by {du:.3e}")


def sequential_march(problem0, nt):
    """The plain Heat2D step, nt - 1 times in sequence, every row kept."""
    import torch
    ref = torch.empty((nt,) + tuple(problem0.vector_t_start.shape), dtype=torch.float64,
                      device=problem0.vector_t_start.device)
    ref[0] = problem0.vector_t_start
    t = problem0.t
    for i in range(1, nt):
        ref[i] = problem0._step_spectral(ref[i - 1], t[i - 1], t[i])
    return ref


def timed_solve(P, ops, device):
    import torch
    mg = P.Mgrit(problem=build_problem(P, device=device, ops=ops, **TOMS), tol=MAIN_TOL,
                 max_iter=MAIN_MAX_ITER, logging_lvl=30)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = mg.solve_compiled()["conv"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = sum(count_fine_steps_per_iter(mg, it == 0) for it in range(conv.size))
    return seconds, steps


def phase_main(card):
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    dev = DEVICE

    problem = build_problem(P, device=dev, ops=DISPATCH, **TOMS)
    reset_launch_counts()
    t0 = time.perf_counter()
    mk = P.Mgrit(problem=problem, tol=MAIN_TOL, max_iter=MAIN_MAX_ITER, logging_lvl=30)
    hk = mk.solve_compiled()["conv"]
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    counts = launch_counts()
    print(f"[main] launches on the main path: {json.dumps(counts)} "
          f"(setup + first solve {first_seconds:.2f} s)")
    check(mk._condensed0, "main: the condensed carry was declined")
    check(all(n > 0 for n in counts.values()), f"main: a kernel was never launched: {counts}")
    check(hk.size >= 2 and bool(np.all(np.diff(hk) < 0)), f"main: history not decreasing: {hk}")
    check(hk[-1] < MAIN_TOL, f"main: history ends at {hk[-1]:.3e}, not below {MAIN_TOL:.0e}")

    mp = P.Mgrit(problem=build_problem(P, device=dev, ops=PLAIN, **TOMS), tol=MAIN_TOL,
                 max_iter=MAIN_MAX_ITER, logging_lvl=30)
    hp = mp.solve_compiled()["conv"]
    atol = residual_floor(mk)
    check(hp.shape == hk.shape, f"main: {hk.size} kernel iterations against {hp.size} plain")
    herr = np.abs(hk - hp)
    h_ok = bool(np.all(herr <= atol + MAIN_RTOL * np.abs(hp)))
    du_plain = float((mk.u[0] - mp.u[0]).abs().max())
    print(f"[main] history kernels vs plain (GPU): max diff {herr.max():.3e}, max rel "
          f"{float(np.max(herr / hp)):.3e} (rtol {MAIN_RTOL:.0e}, atol floor {atol:.2e}); "
          f"tube max diff {du_plain:.3e} | {'ok' if h_ok else 'FAIL'}")
    check(h_ok, "main: kernel history differs from the plain history")
    del mp
    torch.cuda.empty_cache()

    # materialized tube against a sequential march: with a contractive
    # step, the error of C-point c is at most the sum of the residuals of
    # C-points <= c, so every row's 2-norm error is at most
    # sqrt(nc-1) * ||r||_2 (Cauchy-Schwarz); the march itself rounds at most
    # nt * eps * max|u|.
    tube = mk.u[0]
    nt, nx, nc = TOMS["nt"], TOMS["nx"], mk.levels[0].cpts.size
    check(tuple(tube.shape) == (nt, nx - 2, nx - 2), f"main: tube shape {tuple(tube.shape)}")
    check(bool(torch.isfinite(tube).all()), "main: non-finite values in the tube")
    ref = sequential_march(problem[0], nt)
    row_err = torch.linalg.vector_norm((tube - ref).view(nt, -1), dim=1)
    err = float(row_err.max())
    umax = float(ref.abs().max())
    bound = math.sqrt(nc - 1) * hk[-1] + nt * float(torch.finfo(torch.float64).eps) * umax
    phys = problem[0].to_physical(tube[-1])
    phys_ref = problem[0].to_physical(ref[-1])
    perr = float((phys - phys_ref).abs().max())
    check(tuple(phys.shape) == (nx, nx) and bool(torch.isfinite(phys).all()),
          "main: to_physical of the last row is not a finite nx x nx field")
    print(f"[main] tube {tuple(tube.shape)} vs sequential {nt - 1}-step march: max row 2-norm err "
          f"{err:.3e}, physical last row max err {perr:.3e}, bound {bound:.3e} | "
          f"{'ok' if max(err, perr) <= bound else 'FAIL'}")
    check(max(err, perr) <= bound, f"main: tube error {max(err, perr):.3e} above {bound:.3e}")
    del mk, tube, ref, row_err
    torch.cuda.empty_cache()

    # wall time of fresh solves (setup excluded), in turns plain, kernel,
    # kernel, plain
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        seconds, steps = timed_solve(P, PLAIN if name == "plain" else DISPATCH, dev)
        runs[name].append(seconds)
        torch.cuda.empty_cache()
    tk, tp = float(np.median(runs["kernel"])), float(np.median(runs["plain"]))
    print(f"[main] TOMS {nx}x{nx} nt={nt} ms={TOMS['ms']} f64 BE spectral condensed: "
          f"{hk.size} iterations, "
          f"history {[float(f'{h:.6e}') for h in hk]} | solve wall kernel {tk:.4f} s "
          f"(runs {runs['kernel']}), plain {tp:.4f} s (runs {runs['plain']}) | "
          f"{steps} fine steps: {steps / tk:.1f} steps/s kernel, {steps / tp:.1f} steps/s plain | "
          f"{card}")
    return counts


REPLACES = {
    "interval_affine": ("cuda", "pymgrit_tpu_torch/ops/csrc/interval_affine.cu",
                        "pymgrit_tpu/models/heat_2d.py:538"),
    "theta_chain": ("cuda", "pymgrit_tpu_torch/ops/csrc/theta_chain.cu",
                    "pymgrit_tpu/models/heat_2d.py:419"),
    "residual_row_norms": ("triton", "pymgrit_tpu_torch/ops/triton_kernels.py",
                           "pymgrit_tpu/core/solver.py:1056"),
    "cpoint_combine": ("triton", "pymgrit_tpu_torch/ops/triton_kernels.py",
                       "pymgrit_tpu/core/solver.py:914"),
}


def main():
    card = phase_device()
    import torch
    phase_build()
    rows = phase_kernels()
    phase_small()
    counts = phase_main(card)
    kernels = [dict(name=name, route=route, source=source, replaces=replaces,
                    launches=counts[name], **rows[name])
               for name, (route, source, replaces) in REPLACES.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
