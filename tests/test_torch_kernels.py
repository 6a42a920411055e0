"""The port's kernels against their plain PyTorch versions, and the checks
their wrappers make.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they
skip without one.  Run them on the card with

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerance on the card: normwise, max|kernel - plain| <= RTOL * max|plain|
with RTOL = 1e-13 (float64) and 1e-5 (float32).  The kernels contract
a*b + c into FMAs and K3 sums in another order, so they agree with the plain
versions to rounding (a few ulp per operation, at most L sequential steps);
K5 and K6 sum their length-n products in another order than cuBLAS, which
adds ~sqrt(n) ulp per product (n <= 15 here, 127 in chip_smoke.py).  K8
associates its scan in chunks, the plain version by doubling: with |A| < 1
each rounding is damped, so the difference stays a few ulp of the largest
state.  K10 sums its Hartley products in another order than cuBLAS (as
K5).  K12 integrates adaptively: its accept decisions follow the plain
version's (the time arithmetic is free of FMA contraction), the stage
arithmetic contracts, and the orbit amplifies those ulps, so it is held at
1e-12 in float64 (since the plain initial step divides as K12 does).  In
float32 the error estimate at atol 1e-6 sits near float32 rounding and
decisions flip; each flip moves a step's result by up to a few of the
controller's rtol 1e-3, so three chained steps are held at 1e-2.

The remaining tests run on the CPU: a CPU tensor goes to the plain version
without counting a launch, and every wrapper raises on operands its kernel
does not take.
"""

import numpy as np
import pytest
import torch

import pymgrit_tpu_torch as P
from pymgrit_tpu_torch.ops import (DISPATCH, PLAIN, _build, dense_newton, heat_kernels,
                                   indexed, launch_counts, periodic, pointwise, prefix,
                                   reset_launch_counts, row_norms, runge_kutta, theta_rhs)
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
KERNEL_RTOL = {"dopri45_arenstorf": {torch.float64: 1e-12, torch.float32: 1e-2}}
NI = 15                 # interior side of the physical states (17 x 17 with the ring)
N = NI * NI


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _agree(k, p, dtype, name=None):
    err = float((k - p).abs().max())
    assert err <= KERNEL_RTOL.get(name, RTOL)[dtype] * float(p.abs().max()), (name, err)


def _cases(dtype, dev):
    """(kernel name, run(ops) -> output) with strided operands."""
    x = _rand((9, N), dtype, dev, 1)
    A, G = _rand((4, N), dtype, dev, 2).abs(), _rand((4, N), dtype, dev, 3)
    tube = _rand((19, N), dtype, dev, 4)
    lam = _rand((N,), dtype, dev, 5).abs() * 100
    lift, rhs = _rand((N,), dtype, dev, 6), _rand((5, 1, N), dtype, dev, 7)
    dt = torch.full((4, 3), 1e-2, dtype=dtype, device=dev)

    def k1_rows(ops):
        out = torch.empty((3, 9, N), dtype=dtype, device=dev)
        ops.interval_affine(x, A, G, out.transpose(0, 1), 1)
        return out

    def k1_tube(ops):
        out = torch.zeros((9 * 5, N), dtype=dtype, device=dev)
        blocks = out.view(9, 5, N)
        ops.interval_affine(x, A, G, blocks[:, 1:], 0, blocks[:, 0])
        return out

    def k2(theta, with_g, time_dependent):
        def run(ops):
            out = torch.zeros_like(tube)
            r = rhs[:4].expand(4, 3, N) if time_dependent else rhs[0].expand(4, 3, N)
            g = tube[1:16].view(3, 5, N)[:, :4] * 1e-2 if with_g else None
            ops.theta_chain(tube[0:15:5], out[1:16].view(3, 5, N)[:, :4], dt, lam, lift, r,
                            rhs[1:5].expand(4, 3, N) if time_dependent else r, theta, g)
            return out
        return run

    def k3(ops):
        return ops.residual_row_norms(tube[1:19:2], tube[0:18:2])

    def k4(ops):
        out = tube.clone()
        ops.cpoint_combine(out[1:19:2], [out[1:19:2], tube[0:18:2], x], [0.5, -1.0, 2.0])
        return out

    # physical states: (n + 2)^2 with a ring, tables over the n^2 interior
    n, nx = NI, NI + 2
    S = torch.as_tensor(sine_eigenbasis(n, 256.0)[0], dtype=dtype, device=dev)
    lam2 = lam.view(n, n)
    ring = _rand((nx, nx), dtype, dev, 8)
    ring[1:-1, 1:-1] = 0.0
    lift2 = _rand((n, n), dtype, dev, 9)
    ptube = _rand((19, nx, nx), dtype, dev, 10)
    shifts = torch.linspace(1e-3, 4e-3, 3, dtype=dtype, device=dev)

    def k5(solve, with_g, shift):
        def run(ops):
            out = torch.zeros_like(ptube)
            dst = out[1:16].view(3, 5, nx, nx)[:, 0] if solve else out[:3, 1:-1, 1:-1]
            g = ptube[1:16].view(3, 5, nx, nx)[:, 1] * 1e-2 if with_g else None
            ops.sine_solve2d(ptube[0:15:5, 1:-1, 1:-1], dst, S, S, lam2 if solve else None,
                             shift if solve else None, ring if solve else None, g)
            return out
        return run

    def k6(cn, with_seed):
        def run(ops):
            out = torch.zeros_like(ptube)
            blocks = out[:15].view(3, 5, nx, nx)
            ops.sine_affine2d(x[:3], A, G, blocks[:, 1:], S, S, 0, ring,
                              x[3:6] if cn else None, lam * 1e-4 if cn else None,
                              ptube[0:3] if with_seed else None,
                              blocks[:, 0] if with_seed else None)
            return out
        return run

    rows = _rand((12, N), dtype, dev, 11)

    def k7(theta, dt, with_g):
        def run(ops):
            # time-dependent rhs rows for CN and FE, one row (stride 0) for BE
            r1, r0 = (rows[:6], rows[6:]) if theta < 1.0 else (rows[0].expand(6, N),) * 2
            if theta == 0.0:
                out = torch.zeros((6, nx, nx), dtype=dtype, device=dev)
                return ops.theta_rhs2d(ptube[0:18:3], out, dt, 0.0, 256.0, 100.0, r1, r0,
                                       ring=ring, g=ptube[1:7] if with_g else None)
            out = torch.zeros((6, n, n), dtype=dtype, device=dev)
            return ops.theta_rhs2d(ptube[0:18:3], out, dt, theta, 256.0, 100.0, r1, r0,
                                   lift=lift2)
        return run

    dts = torch.linspace(1e-3, 2e-3, 6, dtype=dtype, device=dev)

    # rectangular states (ny != nx): the kernels' row and column roles differ
    nr, nc_ = 11, 14
    Sr = torch.as_tensor(sine_eigenbasis(nr, 144.0)[0], dtype=dtype, device=dev)
    Sc = torch.as_tensor(sine_eigenbasis(nc_, 225.0)[0], dtype=dtype, device=dev)
    lam_rc = _rand((nr, nc_), dtype, dev, 12).abs() * 500
    ring_rc = _rand((nr + 2, nc_ + 2), dtype, dev, 13)
    ring_rc[1:-1, 1:-1] = 0.0
    rect = _rand((4, nr + 2, nc_ + 2), dtype, dev, 14)
    rows_rc = _rand((2, nr * nc_), dtype, dev, 15)

    def k5_rect(ops):
        out = torch.zeros_like(rect)
        return ops.sine_solve2d(rect[:, 1:-1, 1:-1], out, Sr, Sc, lam_rc, 2e-3, ring_rc)

    def k6_rect(ops):
        out = torch.zeros((4, 2, nr + 2, nc_ + 2), dtype=dtype, device=dev)
        A_rc, G_rc = rows_rc.abs(), rows_rc.flip(0)
        return ops.sine_affine2d(rows_rc[[0, 1, 0, 1]], A_rc, G_rc, out, Sr, Sc, 0, ring_rc)

    def k7_rect(ops):
        out = torch.zeros((4, nr, nc_), dtype=dtype, device=dev)
        return ops.theta_rhs2d(rect, out, 1e-3, 0.5, 144.0, 225.0, rows_rc[0].expand(4, -1),
                               rows_rc[1].expand(4, -1), lift=_rand((nr, nc_), dtype, dev, 16))

    # K8, K9: odd row counts (not a multiple of K8's chunk), a strided out
    # view into a tube, A and b rows with stride 0, g rows of a tube
    u_tube = _rand((2 * 38, 7), dtype, dev, 17)[::2]
    g_tube = _rand((38, 7), dtype, dev, 18) * 1e-2
    A_rows, b_rows = _rand((37, 7), dtype, dev, 19).abs() / 4, _rand((1, 7), dtype, dev, 20)

    def k8(with_g, broadcast):
        def run(ops):
            out = torch.zeros((2 * 38, 7), dtype=dtype, device=dev)[::2]
            A_ = torch.sigmoid(A_rows[:1]).expand(37, 7) if broadcast else A_rows
            ops.affine_prefix(A_, b_rows.expand(37, 7), u_tube[0], out[1:],
                              g_tube[1:] if with_g else None)
            return out
        return run

    scalar = _rand((1001,), dtype, dev, 21)

    def k8_scalar(ops):
        out = torch.zeros((1001, 1), dtype=dtype, device=dev)
        A_ = torch.full((1000, 1), 1 / 1.2, dtype=dtype, device=dev)
        return ops.affine_prefix(A_, torch.zeros((1, 1), dtype=dtype, device=dev).expand(1000, 1),
                                 scalar[:1], out[1:], scalar[1:, None] * 1e-2)

    def k9(k, broadcast):
        def run(ops):
            out = torch.zeros((2 * 38, 7), dtype=dtype, device=dev)[1::2]
            A_ = torch.sigmoid(A_rows[:1]).expand(37, 7) if broadcast else A_rows
            return ops.affine_windows(u_tube, A_, b_rows.expand(37, 7), g_tube[1:], out, k)
        return run

    # K10, K11: periodic states of odd and even side read from strided tube
    # rows; K12, K13: lanes of a tube, chains written into its rows
    H17, H16 = (torch.as_tensor(periodic.hartley_basis(s), dtype=dtype, device=dev) for s in (17, 16))
    lam17 = _rand((17, 17), dtype, dev, 22).abs() * 1e3
    lam16 = _rand((16, 16), dtype, dev, 23).abs() * 1e3
    ac_tube = _rand((10, 17, 17), dtype, dev, 24).clamp(-1, 1)
    ac_shift = torch.tensor([1e-3, 2e-3, 5e-4], dtype=dtype, device=dev)

    def k10(imex, with_g):
        def run(ops):
            out = torch.zeros_like(ac_tube)
            g = ac_tube[1:10:3] * 1e-2 if with_g else None
            return ops.periodic_solve2d(ac_tube[0:9:3], out[1:10:3], H17, lam17, ac_shift,
                                        nu=2 if imex else 0, inv_eps2=625.0, g=g)
        return run

    def k10_even(ops):
        b = _rand((1, 16, 16), dtype, dev, 25)
        return ops.periodic_solve2d(b, torch.empty_like(b), H16, lam16, ac_shift[:1])

    def k11(mode):
        def run(ops):
            out = torch.zeros((3, 17, 17), dtype=dtype, device=dev)
            res = ops.allen_cahn_pointwise(mode, ac_tube[0:9:3], out, ac_shift, 625.0,
                                           1.0 / 17 ** 2, 2, x=ac_tube[1:10:3],
                                           rhs=ac_tube[2:10:3] if mode == "residual" else None)
            return torch.cat([res[0].flatten(), res[1]]) if mode == "residual" else res
        return run

    orbit = torch.tensor([0.994, 0.0, 0.0, -2.00158510637908], dtype=dtype, device=dev)
    ode_seed = orbit * (1 + 1e-6 * _rand((5, 4), dtype, dev, 26))
    ode_t = torch.linspace(0, 1.5, 16, dtype=dtype, device=dev)
    tp, tc = ode_t[:-1].view(3, 5).contiguous(), ode_t[1:].view(3, 5).contiguous()
    bru_seed = _rand((5, 2), dtype, dev, 27).abs()

    def k12(with_g):
        def run(ops):
            out = torch.zeros((5 * 4, 4), dtype=dtype, device=dev).view(5, 4, 4)
            g = (ode_seed[:, None] * 1e-4).expand(5, 3, 4) if with_g else None
            return ops.dopri45_arenstorf(ode_seed, tp, tc, out[:, 1:], g)
        return run

    def k13(with_g):
        def run(ops):
            out = torch.zeros((5 * 4, 2), dtype=dtype, device=dev).view(5, 4, 2)
            g = (bru_seed[:, None] * 1e-3).expand(5, 3, 2) if with_g else None
            return ops.rk4_brusselator(bru_seed, tp, tc, out[:, 1:], g)
        return run

    # K10 with a species axis (Gray-Scott pairs from strided tube rows, one
    # coefficient per species, the Gray-Scott prologue); K14, K15 on the
    # same pairs; K16, K17: lanes of a tube, chains written into its rows
    pair_tube = _rand((10, 2, 17, 17), dtype, dev, 33).clamp(-1, 1)
    coef = torch.tensor([8e-3, 4e-3], dtype=dtype, device=dev)

    def k10_pair(imex, with_g):
        def run(ops):
            out = torch.zeros_like(pair_tube)
            g = pair_tube[1:10:3] * 1e-2 if with_g else None
            return ops.periodic_solve2d(pair_tube[0:9:3], out[1:10:3], H17, lam17, ac_shift, g=g,
                                        coef=coef, gray_scott=(0.024, 0.084) if imex else None)
        return run

    def k14(mode, with_g=False):
        def run(ops):
            out = torch.zeros((3, 2, 17, 17), dtype=dtype, device=dev)
            res = ops.gray_scott_pointwise(mode, pair_tube[0:9:3], out, ac_shift * 100, 8e-3, 4e-3,
                                           0.024, 0.084, (2.0 / 17) ** 2, w=pair_tube[1:10:3],
                                           r=pair_tube[2:10:3] if mode == "residual" else None,
                                           g=pair_tube[2:10:3] if with_g else None)
            return torch.cat([res[0].flatten(), res[1]]) if mode == "residual" else res
        return run

    def k15(mode):
        def run(ops):
            out = torch.zeros((3, 2, 17, 17), dtype=dtype, device=dev)
            res = ops.burgers2d_pointwise(mode, pair_tube[0:9:3], out, ac_shift, 0.05, 1.0 / 17,
                                          w=pair_tube[1:10:3],
                                          r=pair_tube[2:10:3] if mode == "residual" else None)
            return torch.cat([res[0].flatten(), res[1]]) if mode == "residual" else res
        return run

    x1 = torch.linspace(0, 1, 33, dtype=torch.float64)[:32]
    line_seed = (torch.sin(2 * np.pi * x1) * (1 + 0.1 * torch.arange(5)[:, None])).to(dev, dtype)
    line_dt = torch.linspace(1e-2, 3e-2, 15, dtype=dtype, device=dev).view(3, 5)
    line_g = _rand((5, 3, 32), dtype, dev, 34) * 1e-3

    def k16(with_g):
        tol, maxiter = (1e-10, 30) if dtype == torch.float64 else (0.0, 4)

        def run(ops):
            out = torch.zeros((5, 4, 32), dtype=dtype, device=dev)
            iters = torch.zeros((3, 5), dtype=torch.int32, device=dev)
            ops.burgers1d_newton(line_seed, line_dt, out[:, 1:], line_g if with_g else None,
                                 0.01, 1.0 / 32, tol, maxiter, iters)
            return torch.cat([out.flatten(), iters.flatten().to(dtype)])
        return run

    def k17(fac, with_g):
        def run(ops):
            out = torch.zeros((5, 4, 32), dtype=dtype, device=dev)
            return ops.circulant_solve1d(line_seed, line_dt, out[:, 1:],
                                         line_g if with_g else None, fac)
        return run

    # K18, K19: rows of fine and coarse tubes (strided), 1D (15 <-> 7 interior
    # points) and 2D (9 x 11 <-> 5 x 6 vertices)
    ftube1, ctube1 = _rand((12, 15), dtype, dev, 36), _rand((12, 7), dtype, dev, 37)
    ftube2, ctube2 = _rand((12, 9, 11), dtype, dev, 38), _rand((12, 5, 6), dtype, dev, 39)

    def k18(dim, nterms, nadds):
        ft, ct = (ftube1, ctube1) if dim == 1 else (ftube2, ctube2)

        def run(ops):
            out = torch.zeros_like(ct)
            ops.restrict_combine(out[1:11:2], [ft[k:10 + k:2] for k in range(nterms)],
                                 [1.0, -1.0, 1.0][:nterms], [ct[k:10 + k:2] for k in range(nadds)],
                                 [1.0, -1.0][:nadds], dim)
            return out
        return run

    def k19(dim, with_b):
        ft, ct = (ftube1, ctube1) if dim == 1 else (ftube2, ctube2)

        def run(ops):
            out = ft.clone()
            ops.interpolate_combine(out[2:12:2], ct[0:10:2], ct[1:11:2] if with_b else None, dim)
            return out
        return run

    # past the one-tile core's side (128): K5 and K6 (the tiled path, a
    # rectangular state with partial tiles), K10 (pairs with the Gray-Scott
    # prologue and g, Allen-Cahn's), K16 and K17 on wide lines
    br, bc = 133, 40
    Sbr = torch.as_tensor(sine_eigenbasis(br, 900.0)[0], dtype=dtype, device=dev)
    Sbc = torch.as_tensor(sine_eigenbasis(bc, 400.0)[0], dtype=dtype, device=dev)
    lam_big = _rand((br, bc), dtype, dev, 40).abs() * 500
    ring_big = _rand((br + 2, bc + 2), dtype, dev, 41)
    ring_big[1:-1, 1:-1] = 0.0
    big = _rand((5, br + 2, bc + 2), dtype, dev, 42)
    rows_big = _rand((3, br * bc), dtype, dev, 43)

    def k5_big(ops):
        out = torch.zeros_like(big)
        return ops.sine_solve2d(big[0:4:2, 1:-1, 1:-1], out[1:5:2], Sbr, Sbc, lam_big,
                                torch.tensor([1e-3, 3e-3], dtype=dtype, device=dev), ring_big,
                                big[1:4:2] * 1e-2)

    def k6_big(ops):
        out = torch.zeros((2, 3, br + 2, bc + 2), dtype=dtype, device=dev)
        A_b, G_b = rows_big.abs(), rows_big.flip(0)
        ops.sine_affine2d(rows_big[[0, 2]], A_b, G_b, out[:, 1:], Sbr, Sbc, 1, ring_big,
                          rows_big[[1, 0]], lam_big.view(-1) * 1e-4, big[:2], out[:, 0])
        return out

    Hb = torch.as_tensor(periodic.hartley_basis(130), dtype=dtype, device=dev)
    lam_hb = _rand((130, 130), dtype, dev, 44).abs() * 1e3
    pair_big = _rand((3, 2, 130, 130), dtype, dev, 45).clamp(-1, 1)

    def k10_big(gray_scott):
        def run(ops):
            out = torch.zeros_like(pair_big)
            if gray_scott:
                return ops.periodic_solve2d(pair_big[:2], out[1:], Hb, lam_hb, ac_shift[:2],
                                            g=pair_big[1:] * 1e-2, coef=coef, gray_scott=(0.024, 0.084))
            return ops.periodic_solve2d(pair_big[:, 1], out[:, 0], Hb, lam_hb, ac_shift, nu=2,
                                        inv_eps2=625.0)
        return run

    x_wide = torch.linspace(0, 1, 171, dtype=torch.float64)[:170]
    wide_seed = (torch.sin(2 * np.pi * x_wide) * (1 + 0.1 * torch.arange(3)[:, None])).to(dev, dtype)
    wide_dt = torch.full((2, 3), 2e-2, dtype=dtype, device=dev)

    def k16_big(ops):
        tol, maxiter = (1e-10, 30) if dtype == torch.float64 else (0.0, 4)
        out = torch.zeros((3, 2, 170), dtype=dtype, device=dev)
        iters = torch.zeros((2, 3), dtype=torch.int32, device=dev)
        ops.burgers1d_newton(wide_seed, wide_dt, out, None, 0.01, 1.0 / 170, tol, maxiter, iters)
        return torch.cat([out.flatten(), iters.flatten().to(dtype)])

    long_seed = _rand((3, 1030), dtype, dev, 46)

    def k17_big(fac):
        def run(ops):
            out = torch.zeros((3, 3, 1030), dtype=dtype, device=dev)
            return ops.circulant_solve1d(long_seed, line_dt[:, :3].contiguous(), out,
                                         (long_seed[:, None] * 1e-3).expand(3, 3, 1030), fac)
        return run

    # K20: 1D physical rows (strided), a shared or per-row rhs, the
    # (interval, row) output layout of relax_interval, and a width past one
    # 32-wide tile in both the rows and the columns
    S1 = torch.as_tensor(sine_eigenbasis(NI, 256.0)[0], dtype=dtype, device=dev)
    rows1 = _rand((11, NI), dtype, dev, 47)
    dt1 = torch.linspace(1e-3, 5e-3, 5, dtype=dtype, device=dev)

    def k20(solve, shared_rhs):
        def run(ops):
            out = torch.zeros((11, NI), dtype=dtype, device=dev)
            r = rows1[0].expand(5, NI) if shared_rhs else rows1[1:10:2]
            ops.sine_solve1d(rows1[0:10:2], out[1:11:2], S1, lam[:NI] if solve else None,
                             dt1 if solve else None, r if solve else None)
            return out
        return run

    def k20_blocks(ops):
        out = torch.zeros((4, 3, NI), dtype=dtype, device=dev)
        ops.sine_solve1d(rows1[:6], out.transpose(0, 1)[:, 1:3], S1)
        return out

    nw = 70
    Sw = torch.as_tensor(sine_eigenbasis(nw, 900.0)[0], dtype=dtype, device=dev)
    wide1 = _rand((40, nw), dtype, dev, 48)

    def k20_wide(ops):
        out = torch.zeros((37, nw), dtype=dtype, device=dev)
        return ops.sine_solve1d(wide1[:37], out, Sw, wide1[0].abs() * 1e3,
                                torch.linspace(1e-3, 2e-3, 37, dtype=dtype, device=dev),
                                wide1[1:38] * 1e-2)

    # K20's BDF2 mode: first and second are the slots of a pair tube, the
    # second solve reads the first's output from the same tensor
    pairs = _rand((6, 2, NI), dtype, dev, 49)
    cf = _rand((6, 5), dtype, dev, 50).abs() * 100 + 1

    def k20_bdf2(ops):
        out = pairs[1:].clone()
        ops.sine_solve1d(pairs[:5, 1], out[:, 1], S1, lam[:NI], rhs=rows1[0].expand(5, NI),
                         second=out[:, 0], c2=cf[3], c1=cf[4], coeff=cf[5])
        return out

    # K21 indexed_combine: a gather, a drop-scatter (padding index = the
    # tube's length), an in-place weighted update at index rows, a
    # three-term sum with a gathered term
    src = _rand((12, 2 * NI), dtype, dev, 51)
    pick = torch.as_tensor([3, 0, 11, 3, 7], device=dev)
    put = torch.as_tensor([1, 12, 4, 12, 9], device=dev)

    def k21_gather(ops):
        out = torch.zeros((5, 2 * NI), dtype=dtype, device=dev)
        return ops.indexed_combine(out, [src], [1.0], idx=[pick])

    def k21_scatter(ops):
        out = src.clone()
        return ops.indexed_combine(out, [src[2:7]], [1.0], io=put)

    def k21_weighted(ops):
        out = src.clone()
        return ops.indexed_combine(out, [src[:3], out], [0.7, 0.3], io=pick[2:],
                                   idx=[None, pick[2:]])

    def k21_three(ops):
        out = torch.zeros((5, 2 * NI), dtype=dtype, device=dev)
        return ops.indexed_combine(out, [src, src[5:10], src[::2][:5]], [1.0, -1.0, 1.0],
                                   idx=[pick])

    # K22 eig_step: N and B not multiples of the tiles, strided lanes, a
    # lane count below one row tile and one above
    ne = 150
    We, Ve = (_rand((ne, ne), dtype, dev, s) / ne ** 0.5 for s in (52, 53))
    lam_e = _rand((ne,), dtype, dev, 54).abs() * 10
    xe = _rand((140, ne), dtype, dev, 55)

    def k22(B):
        def run(ops):
            out = torch.zeros((B, ne + 3), dtype=dtype, device=dev)
            dt = torch.linspace(0.1, 0.5, B, dtype=dtype, device=dev)
            return ops.eig_step(xe[:2 * B:2], out[:, 1:ne + 1], We, Ve, lam_e, dt)
        return run

    return [("interval_affine", k1_rows), ("interval_affine", k1_tube),
            ("theta_chain", k2(1.0, True, False)), ("theta_chain", k2(0.5, True, True)),
            ("theta_chain", k2(1.0, False, True)), ("residual_row_norms", k3),
            ("cpoint_combine", k4),
            ("sine_solve2d", k5(True, True, 2e-3)), ("sine_solve2d", k5(True, False, shifts)),
            ("sine_solve2d", k5(False, False, None)),
            ("sine_affine2d", k6(False, True)), ("sine_affine2d", k6(True, False)),
            ("theta_rhs2d", k7(1.0, 1e-3, False)), ("theta_rhs2d", k7(0.5, dts, False)),
            ("theta_rhs2d", k7(0.0, 1e-4, True)),
            ("sine_solve2d", k5_rect), ("sine_affine2d", k6_rect), ("theta_rhs2d", k7_rect),
            ("affine_prefix", k8(True, True)), ("affine_prefix", k8(False, False)),
            ("affine_prefix", k8_scalar),
            ("affine_windows", k9(1, True)), ("affine_windows", k9(3, False)),
            ("affine_windows", k9(8, True)), ("affine_windows", k9(50, False)),
            ("periodic_solve2d", k10(True, True)), ("periodic_solve2d", k10(False, False)),
            ("periodic_solve2d", k10_even),
            ("allen_cahn_pointwise", k11("rhs")), ("allen_cahn_pointwise", k11("residual")),
            ("allen_cahn_pointwise", k11("jacobian")),
            ("dopri45_arenstorf", k12(True)), ("dopri45_arenstorf", k12(False)),
            ("rk4_brusselator", k13(True)), ("rk4_brusselator", k13(False)),
            ("periodic_solve2d", k10_pair(True, True)),
            ("periodic_solve2d", k10_pair(False, False)),
            ("gray_scott_pointwise", k14("expl", True)), ("gray_scott_pointwise", k14("expl")),
            ("gray_scott_pointwise", k14("residual")), ("gray_scott_pointwise", k14("jacobian")),
            ("burgers2d_pointwise", k15("residual")), ("burgers2d_pointwise", k15("jacobian")),
            ("burgers1d_newton", k16(True)), ("burgers1d_newton", k16(False)),
            ("circulant_solve1d", k17(40.0, True)), ("circulant_solve1d", k17(-40.0, False)),
            ("restrict_combine", k18(1, 2, 2)), ("restrict_combine", k18(1, 1, 0)),
            ("restrict_combine", k18(2, 3, 2)), ("restrict_combine", k18(2, 1, 0)),
            ("interpolate_combine", k19(1, True)), ("interpolate_combine", k19(1, False)),
            ("interpolate_combine", k19(2, True)), ("interpolate_combine", k19(2, False)),
            ("sine_solve2d", k5_big), ("sine_affine2d", k6_big),
            ("periodic_solve2d", k10_big(True)), ("periodic_solve2d", k10_big(False)),
            ("burgers1d_newton", k16_big), ("circulant_solve1d", k17_big(40.0)),
            ("circulant_solve1d", k17_big(-40.0)),
            ("sine_solve1d", k20(True, True)), ("sine_solve1d", k20(True, False)),
            ("sine_solve1d", k20(False, False)), ("sine_solve1d", k20_blocks),
            ("sine_solve1d", k20_wide), ("sine_solve1d", k20_bdf2),
            ("indexed_combine", k21_gather), ("indexed_combine", k21_scatter),
            ("indexed_combine", k21_weighted), ("indexed_combine", k21_three),
            ("eig_step", k22(3)), ("eig_step", k22(70))]


N_CASES = 74


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_on_card(cuda, dtype):
    for name, run in _cases(dtype, cuda):
        before = launch_counts()[name]
        out_k = run(DISPATCH)
        torch.cuda.synchronize()
        assert launch_counts()[name] == before + 1
        _agree(out_k, run(PLAIN), dtype, name)


_PATH_KERNELS = {
    "spectral": ("interval_affine", "theta_chain", "residual_row_norms", "cpoint_combine"),
    "physical": ("sine_solve2d", "sine_affine2d", "theta_rhs2d", "residual_row_norms",
                 "cpoint_combine"),
}


def _small_solve(device, basis, method="BE"):
    t = np.linspace(0, 1, 129)
    problem = [P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=17, ny=17, a=1.0,
                        rhs=lambda x, y, t: np.sin(np.pi * x) * np.sin(np.pi * y) + 0 * t,
                        init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                        t_interval=t[::s], basis=basis, method=method, device=device,
                        bc_left=0.5)
               for s in (1, 4, 16)]
    reset_launch_counts()
    mgrit = P.Mgrit(problem=problem, tol=1e-10, max_iter=5, logging_lvl=40)
    return mgrit.solve_compiled()["conv"], mgrit.u[0].cpu(), launch_counts()


@pytest.mark.cuda
def test_small_solve_on_card_matches_cpu(cuda):
    histories, tubes = [], []
    for device in ("cpu", cuda):
        hist, tube, counts = _small_solve(device, "spectral")
        histories.append(hist)
        tubes.append(tube)
        assert all(counts[k] > 0 for k in _PATH_KERNELS["spectral"]) == (device != "cpu")
    np.testing.assert_allclose(histories[1], histories[0], rtol=1e-10, atol=1e-14)
    assert float((tubes[1] - tubes[0]).abs().max()) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["BE", "CN"])
def test_small_physical_solve_on_card_matches_cpu(cuda, method):
    """The physical path on the card runs K3-K7 and no spectral kernel."""
    (hc, tc, cc), (hg, tg, cg) = (_small_solve(d, "physical", method) for d in ("cpu", cuda))
    assert not any(cc.values())
    assert all(cg[k] > 0 for k in _PATH_KERNELS["physical"])
    assert cg["interval_affine"] == cg["theta_chain"] == 0
    np.testing.assert_allclose(hg, hc, rtol=1e-10, atol=1e-14)
    assert float((tg - tc).abs().max()) <= 1e-10


def _heat1d_spatial_solve(device):
    """examples/example_spatial_coarsening.py (Heat1D physical, 17/9/5/5,
    GridTransferHeat): K18, K19 and K20 on the card."""
    rhs = lambda x, t: -np.sin(np.pi * x) * (np.sin(t) - np.pi ** 2 * np.cos(t))
    kw = dict(x_start=0, x_end=2, a=1, rhs=rhs, init_cond=lambda x: np.sin(np.pi * x),
              device=device)
    h0 = P.Heat1D(nx=17, t_start=0, t_stop=2, nt=129, **kw)
    h1 = P.Heat1D(nx=9, t_interval=h0.t[::2], **kw)
    h2 = P.Heat1D(nx=5, t_interval=h1.t[::2], **kw)
    h3 = P.Heat1D(nx=5, t_interval=h2.t[::2], **kw)
    reset_launch_counts()
    mgrit = P.Mgrit(problem=[h0, h1, h2, h3],
                    transfer=[P.GridTransferHeat(), P.GridTransferHeat(), P.GridTransferCopy()],
                    logging_lvl=40)
    return mgrit.solve()["conv"], mgrit.u[0].cpu(), launch_counts()


@pytest.mark.cuda
def test_small_heat1d_spatial_solve_on_card_matches_cpu(cuda):
    (hc, tc, cc), (hg, tg, cg) = (_heat1d_spatial_solve(d) for d in ("cpu", cuda))
    assert not any(cc.values())
    assert all(cg[k] > 0 for k in ("sine_solve1d", "restrict_combine", "interpolate_combine"))
    np.testing.assert_allclose(hg, hc, rtol=1e-10, atol=1e-14)
    assert float((tg - tc).abs().max()) <= 1e-10


def _slice7_solve(device, case):
    """Small solves of the non-uniform route (Heat1D physical on a jittered
    grid: K21, K20), the BDF pair hierarchy (K20's BE and BDF2 modes) and
    Diffusion2D (K22)."""
    rhs = lambda x, t: -np.sin(np.pi * x) * (np.sin(t) - np.pi ** 2 * np.cos(t))
    ic = lambda x: np.sin(np.pi * x)
    if case == "ragged":
        t = np.linspace(0, 2, 65)
        kw = dict(x_start=0, x_end=1, nx=17, a=1, rhs=rhs, init_cond=ic, device=device)
        idx1 = np.array([0, 3, 5, 6, 12, 20, 21, 22, 30, 41, 50, 63, 64])
        problem = [P.Heat1D(t_interval=g, **kw) for g in (t, t[idx1], t[idx1][::3])]
    elif case == "bdf":
        ti = np.linspace(0, 2, 33)
        kw = dict(x_start=0, x_end=1, nx=17, a=1, dtau=2 / 64, rhs=rhs, init_cond=ic,
                  device=device)
        problem = [P.Heat1DBDF2(t_interval=ti, **kw), P.Heat1DBDF1(t_interval=ti[::2], **kw),
                   P.Heat1DBDF1(t_interval=ti[::4], **kw)]
    else:
        problem = [P.Diffusion2D(n=4, t_start=0, t_stop=10, nt=nt, device=device)
                   for nt in (17, 9)]
    reset_launch_counts()
    mgrit = P.Mgrit(problem=problem, tol=1e-10, max_iter=8, logging_lvl=40)
    mgrit.solve()
    # a two-level solve can end at an exact 0, which solve()'s history drops
    return mgrit.conv[1:mgrit.solve_iter + 1], mgrit.u[0].cpu(), launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("case,kernel", [("ragged", "indexed_combine"), ("bdf", "sine_solve1d"),
                                         ("diffusion", "eig_step")])
def test_small_slice7_solve_on_card_matches_cpu(cuda, case, kernel):
    (hc, tc, cc), (hg, tg, cg) = (_slice7_solve(d, case) for d in ("cpu", cuda))
    assert not any(cc.values()) and cg[kernel] > 0
    np.testing.assert_allclose(hg, hc, rtol=1e-9, atol=1e-14)
    assert float((tg - tc).abs().max()) <= 1e-10


# ---------------------------------------------------------------------------
# CPU: routing and the wrappers' checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(N_CASES))
def test_cpu_tensors_take_the_plain_version(case):
    cases = _cases(torch.float64, torch.device("cpu"))
    assert len(cases) == N_CASES
    name, run = cases[case]
    reset_launch_counts()
    np.testing.assert_array_equal(run(DISPATCH).numpy(), run(PLAIN).numpy())
    assert launch_counts() == {k: 0 for k in launch_counts()}


def _k1_args(**over):
    x = torch.zeros((3, N), dtype=torch.float64)
    args = dict(x=x, A=torch.zeros((4, N), dtype=torch.float64),
                G=torch.zeros((4, N), dtype=torch.float64),
                out=torch.empty((3, 4, N), dtype=torch.float64), r0=0)
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(x=torch.zeros((3, N), dtype=torch.float32)), "dtype"),
    (dict(A=torch.zeros((4, N), dtype=torch.float64, device="meta")), "is on meta"),
    (dict(out=torch.empty((3, N, 4), dtype=torch.float64).transpose(1, 2)), "contiguous"),
    (dict(out=torch.empty((3, 5, N), dtype=torch.float64)), "outside"),
    (dict(r0=1), "outside"),
    (dict(out=torch.empty((2, 4, N), dtype=torch.float64)), "expected"),
    (dict(A=torch.zeros((N, 4), dtype=torch.float64).t()), "contiguous"),
])
def test_interval_affine_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        heat_kernels.interval_affine(**_k1_args(**over))


def _k2_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(x0=torch.zeros((3, N), **f), out=torch.empty((3, 2, N), **f),
                dt=torch.zeros((2, 3), **f), lam=torch.zeros(N, **f), lift=torch.zeros(N, **f),
                rhs1=torch.zeros(N, **f).expand(2, 3, N), rhs0=torch.zeros(N, **f).expand(2, 3, N),
                theta=1.0)
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(dt=torch.zeros((3, 2), dtype=torch.float64)), "dt must be"),
    (dict(lam=torch.zeros(N + 1, dtype=torch.float64)), "lam and lift"),
    (dict(rhs0=torch.zeros((2, 3, N), dtype=torch.float64)), "equal strides"),
    (dict(g=torch.zeros((3, 1, N), dtype=torch.float64)), "g must have"),
    (dict(theta=0.0), "theta"),
    (dict(x0=torch.zeros((3, N), dtype=torch.int64)), "dtype"),
])
def test_theta_chain_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        heat_kernels.theta_chain(**_k2_args(**over))


def _k5_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(b=torch.zeros((3, NI, NI), **f), out=torch.empty((3, NI + 2, NI + 2), **f),
                Sx=torch.zeros((NI, NI), **f), Sy=torch.zeros((NI, NI), **f),
                lam=torch.zeros((NI, NI), **f), shift=1e-3,
                ring=torch.zeros((NI + 2, NI + 2), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(out=torch.empty((3, NI, NI), dtype=torch.float64)), "out has shape"),
    (dict(shift=None), "lam and shift"),
    (dict(lam=torch.zeros((NI, NI + 1), dtype=torch.float64)), "lam must be"),
    (dict(shift=torch.zeros(2, dtype=torch.float64)), "shift tensor"),
    (dict(ring=torch.zeros((NI, NI), dtype=torch.float64)), "ring must be"),
    (dict(Sy=torch.zeros((NI + 1, NI + 1), dtype=torch.float64)), "Sx and Sy"),
    (dict(g=torch.zeros((3, NI, NI), dtype=torch.float64)), "g has shape"),
    (dict(b=torch.zeros((3, NI, NI), dtype=torch.float32)), "dtype"),
])
def test_sine_solve2d_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        heat_kernels.sine_solve2d(**_k5_args(**over))


def _k6_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(xhat=torch.zeros((3, N), **f), A=torch.zeros((4, N), **f),
                G=torch.zeros((4, N), **f), out=torch.empty((3, 4, NI + 2, NI + 2), **f),
                Sx=torch.zeros((NI, NI), **f), Sy=torch.zeros((NI, NI), **f), r0=0,
                ring=torch.zeros((NI + 2, NI + 2), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(r0=1), "outside"),
    (dict(xhat=torch.zeros((3, N + 1), dtype=torch.float64)), "xhat has shape"),
    (dict(out=torch.empty((3, 4, NI, NI), dtype=torch.float64)), "out has shape"),
    (dict(dhat=torch.zeros((3, N), dtype=torch.float64)), "dhat and dscale"),
    (dict(seed=torch.zeros((3, NI + 2, NI + 2), dtype=torch.float64)), "seed and seed_out"),
    (dict(A=torch.zeros((N, 4), dtype=torch.float64).t()), "contiguous"),
])
def test_sine_affine2d_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        heat_kernels.sine_affine2d(**_k6_args(**over))


def _k7_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(u=torch.zeros((3, NI + 2, NI + 2), **f), out=torch.empty((3, NI, NI), **f),
                dt=1e-3, theta=1.0, fx=1.0, fy=1.0, rhs1=torch.zeros(N, **f).expand(3, N),
                rhs0=torch.zeros(N, **f).expand(3, N), lift=torch.zeros((NI, NI), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(out=torch.empty((3, NI + 2, NI + 2), dtype=torch.float64)), "out has shape"),
    (dict(theta=0.0, out=torch.empty((3, NI + 2, NI + 2), dtype=torch.float64)), "ring field"),
    (dict(lift=None), "lift"),
    (dict(rhs0=torch.zeros((3, N), dtype=torch.float64)), "equal strides"),
    (dict(theta=1.5), "theta"),
    (dict(dt=torch.zeros(2, dtype=torch.float64)), "dt tensor"),
    (dict(g=torch.zeros((3, NI, NI), dtype=torch.float64)), "FE steps only"),
])
def test_theta_rhs2d_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        theta_rhs.theta_rhs2d(**_k7_args(**over))


def _k8_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(A=torch.zeros((5, 3), **f), b=torch.zeros((1, 3), **f).expand(5, 3),
                x0=torch.zeros(3, **f), out=torch.empty((5, 3), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(A=torch.zeros((4, 3), dtype=torch.float64)), "A has shape"),
    (dict(b=torch.zeros((5, 2), dtype=torch.float64)), "b has shape"),
    (dict(g=torch.zeros((5, 4), dtype=torch.float64)), "g has shape"),
    (dict(x0=torch.zeros((2, 3), dtype=torch.float64)[:, 0]), "x0 must be"),
    (dict(out=torch.empty((3, 5), dtype=torch.float64).t()), "contiguous"),
    (dict(out=torch.empty((5, 3), dtype=torch.float32)), "dtype"),
    (dict(out=torch.empty(3, dtype=torch.float64).expand(5, 3)), "must not overlap"),
    (dict(x0=torch.zeros(3, dtype=torch.float64, device="meta")), "is on meta"),
])
def test_affine_prefix_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        prefix.affine_prefix(**_k8_args(**over))


def _k9_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(u=torch.zeros((6, 3), **f), A=torch.zeros((5, 3), **f),
                b=torch.zeros((1, 3), **f).expand(5, 3), g=torch.zeros((5, 3), **f),
                out=torch.empty((6, 3), **f), k=2)
    args.update(over)
    return args


_TUBE = torch.zeros((12, 3), dtype=torch.float64)


@pytest.mark.parametrize("over,match", [
    (dict(out=torch.empty((5, 3), dtype=torch.float64)), "out has shape"),
    (dict(g=torch.zeros((6, 3), dtype=torch.float64)), "g has shape"),
    (dict(A=torch.zeros((5, 4), dtype=torch.float64)), "A has shape"),
    (dict(k=0), "k = 0"),
    (dict(u=_TUBE[:6], out=_TUBE[5:11]), "must not overlap u"),
    (dict(u=_TUBE[:6], out=_TUBE[:6]), "must not overlap u"),
    (dict(g=torch.zeros((5, 3), dtype=torch.float32)), "dtype"),
    (dict(u=torch.zeros((6, 0), dtype=torch.float64)[:0]), "u has shape"),
])
def test_affine_windows_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        prefix.affine_windows(**_k9_args(**over))


def test_affine_windows_takes_disjoint_views_of_one_tube():
    """Lane p starts at u[max(0, p-3)] and adds g = 1 once per step."""
    tube = torch.arange(24, dtype=torch.float64).view(12, 2)
    one = torch.ones((5, 2), dtype=torch.float64)
    out = prefix.affine_windows(tube[:6], one, 0 * one, one, tube[6:], 4)
    u = np.arange(12, dtype=np.float64).reshape(6, 2)
    np.testing.assert_array_equal(out.numpy(), u[[0, 0, 0, 0, 1, 2]] + np.array([0, 1, 2, 3, 3, 3])[:, None])


def test_triton_wrappers_reject():
    a = torch.zeros((4, N), dtype=torch.float64)
    with pytest.raises(ValueError, match="must be equal"):
        row_norms.residual_row_norms(a, a[:3])
    for terms in (4, 5):        # K4 takes 1..3 terms (the solver's most), as K21
        with pytest.raises(ValueError, match="1..3 terms"):
            indexed.cpoint_combine(a, [a] * terms, [1.0] * terms)
    with pytest.raises(ValueError, match="overlaps"):
        tube = torch.zeros((9, N), dtype=torch.float64)
        indexed.cpoint_combine(tube[1:5], [tube[0:4]], [1.0])
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.zeros((4, N), device="meta")
        row_norms.residual_row_norms(m, m)
    # interleaved C- and F-rows of one tube do not overlap
    tube = torch.arange(9 * N, dtype=torch.float64).view(9, N)
    indexed.cpoint_combine(tube[2:9:2], [tube[1:9:2]], [1.0])
    np.testing.assert_array_equal(tube[2:9:2].numpy(), tube[1:9:2].numpy())


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# ---------------------------------------------------------------------------
# K10-K13 and the NaN semantics of the reductions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_dopri45_attempt_counts_on_card_match_plain(cuda):
    """K12 takes the plain version's accept/reject decisions: equal attempt
    counts lane by lane (the time arithmetic is free of FMA contraction)."""
    orbit = torch.tensor([0.994, 0.0, 0.0, -2.00158510637908], dtype=torch.float64, device=cuda)
    seed = orbit * (1 + 1e-6 * _rand((64, 4), torch.float64, cuda, 30))
    t = torch.linspace(0, 17.06521656015796, 64 * 4 + 1, dtype=torch.float64, device=cuda)
    tp, tc = t[:-1].view(4, 64).contiguous(), t[1:].view(4, 64).contiguous()
    counts = []
    for ops in (DISPATCH, PLAIN):
        att = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
        ops.dopri45_arenstorf(seed, tp, tc, torch.empty((64, 4, 4), dtype=torch.float64,
                                                        device=cuda), attempts=att)
        counts.append(att.cpu())
    assert torch.equal(counts[0], counts[1]) and int(counts[0].min()) >= 1


@pytest.mark.cuda
def test_reductions_keep_nan_on_card(cuda):
    """K3's row norms and K11's per-lane max|g| give NaN for a row holding a
    NaN (also beside an inf) and inf for an inf, as torch.amax and jnp.max:
    Triton's max would drop the NaN."""
    s = _rand((4, 300), torch.float64, cuda, 31)
    u = torch.zeros_like(s)
    s[1, 7], s[2, 250] = float("nan"), float("inf")
    s[3, 5], s[3, 290] = float("inf"), float("nan")
    k3 = DISPATCH.residual_row_norms(s, u)
    assert torch.equal(torch.isnan(k3), torch.isnan(PLAIN.residual_row_norms(s, u)))
    assert torch.isnan(k3[1]) and torch.isinf(k3[2]) and torch.isnan(k3[3])
    x = _rand((4, 33, 33), torch.float64, cuda, 32).clamp(-1, 1)
    rhs = torch.zeros_like(x)
    rhs[1, 3, 4], rhs[2, 0, 0] = float("nan"), float("inf")
    rhs[3, 1, 1], rhs[3, 32, 32] = float("inf"), float("nan")
    fac = torch.full((4,), 1e-3, dtype=torch.float64, device=cuda)
    _, gk = DISPATCH.allen_cahn_pointwise("residual", x, torch.empty_like(x), fac, 625.0,
                                          1.0 / 33 ** 2, 2, rhs=rhs)
    _, gp = PLAIN.allen_cahn_pointwise("residual", x, torch.empty_like(x), fac, 625.0,
                                       1.0 / 33 ** 2, 2, rhs=rhs)
    assert torch.isnan(gk[1]) and torch.isinf(gk[2]) and torch.isnan(gk[3])
    assert float(gk[0]) == float(gp[0])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["IMEX", "CN", "IMPL"])
def test_small_allen_cahn_solve_on_card_matches_cpu(cuda, method):
    """Three levels at nx = 16: K10 (and K11) on the card against the plain
    versions on the CPU, histories to rtol 1e-10 with an atol at the float64
    floor."""
    runs = []
    for device in ("cpu", cuda):
        a0 = P.AllenCahn(nx=16, method=method, t_start=0, t_stop=0.032, nt=65, device=device)
        problem = [a0] + [P.AllenCahn(nx=16, method=method, t_interval=a0.t[::s], device=device)
                          for s in (4, 16)]
        reset_launch_counts()
        mg = P.Mgrit(problem=problem, tol=1e-10, max_iter=10, logging_lvl=40)
        runs.append((mg.solve()["conv"], mg.u[0].cpu(), launch_counts()))
    (hc, uc, cc), (hg, ug, cg) = runs
    assert cg["periodic_solve2d"] > 0 and (cg["allen_cahn_pointwise"] > 0) == (method != "IMEX")
    fin = np.isfinite(hc)
    np.testing.assert_array_equal(fin, np.isfinite(hg))
    np.testing.assert_allclose(hg[fin], hc[fin], rtol=1e-10, atol=1e-13)
    assert float((ug - uc).abs().max()) <= 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["ArenstorfOrbit", "Brusselator"])
def test_small_ode_solve_on_card_matches_cpu(cuda, model):
    runs = []
    for device in ("cpu", cuda):
        p0 = getattr(P, model)(t_start=0, t_stop=12, nt=641, device=device)
        reset_launch_counts()
        mg = P.Mgrit(problem=[p0, getattr(P, model)(t_interval=p0.t[::20], device=device)],
                     tol=1e-7, logging_lvl=40)
        runs.append((mg.solve()["conv"], mg.u[0].cpu(), launch_counts()))
    (hc, uc, _), (hg, ug, cg) = runs
    kernel = "dopri45_arenstorf" if model == "ArenstorfOrbit" else "rk4_brusselator"
    assert cg[kernel] > 0
    # the chaotic orbit amplifies the kernels' contracted roundings
    rtol = 1e-5 if model == "ArenstorfOrbit" else 1e-10
    np.testing.assert_allclose(hg, hc, rtol=rtol, atol=1e-13)
    assert float((ug - uc).abs().max()) <= (1e-8 if model == "ArenstorfOrbit" else 1e-12)


def _k10_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(b=torch.zeros((3, 8, 8), **f), out=torch.empty((3, 8, 8), **f),
                H=torch.zeros((8, 8), **f), lam=torch.zeros((8, 8), **f),
                shift=torch.zeros(3, **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(b=torch.zeros((3, 8, 7), dtype=torch.float64)), "expected \\(B, n, n\\)"),
    (dict(out=torch.empty((3, 9, 9), dtype=torch.float64)), "out has shape"),
    (dict(g=torch.zeros((2, 8, 8), dtype=torch.float64)), "g has shape"),
    (dict(H=torch.zeros((7, 7), dtype=torch.float64)), "H and lam"),
    (dict(lam=torch.zeros((8, 16), dtype=torch.float64)[:, ::2]), "contiguous"),
    (dict(shift=torch.zeros(2, dtype=torch.float64)), "shift must be"),
    (dict(nu=-1), "nu must be"),
    (dict(lam=torch.zeros((8, 8), dtype=torch.float32)), "dtype"),
])
def test_periodic_solve2d_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        periodic.periodic_solve2d(**_k10_args(**over))


def _k11_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(mode="jacobian", u=torch.zeros((3, 8, 8), **f), out=torch.empty((3, 8, 8), **f),
                fac=torch.zeros(3, **f), inv_eps2=625.0, dx2=1.0, nu=2,
                x=torch.zeros((3, 8, 8), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(mode="lap"), "mode must be"),
    (dict(x=None), "needs x"),
    (dict(mode="residual"), "needs rhs"),
    (dict(fac=torch.zeros(2, dtype=torch.float64)), "fac must be"),
    (dict(nu=0), "nu must be"),
    (dict(x=torch.zeros((3, 8, 9), dtype=torch.float64)), "x has shape"),
    (dict(u=torch.zeros((3, 8, 9), dtype=torch.float64)), "expected \\(B, n, n\\)"),
])
def test_allen_cahn_pointwise_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        pointwise.allen_cahn_pointwise(**_k11_args(**over))


def _ode_args(d, **over):
    f = dict(dtype=torch.float64)
    args = dict(seed=torch.zeros((5, d), **f), tp=torch.zeros((3, 5), **f),
                tc=torch.zeros((3, 5), **f), out=torch.empty((5, 3, d), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(seed=torch.zeros((5, 3), dtype=torch.float64)), "seed has shape"),
    (dict(out=torch.empty((4, 3, 4), dtype=torch.float64)), "out has shape"),
    (dict(tp=torch.zeros((5, 3), dtype=torch.float64)), "tp and tc"),
    (dict(g=torch.zeros((5, 2, 4), dtype=torch.float64)), "g must have"),
    (dict(attempts=torch.zeros((3, 5), dtype=torch.int64)), "attempts must be"),
])
def test_dopri45_arenstorf_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        runge_kutta.dopri45_arenstorf(**_ode_args(4, **over))


@pytest.mark.parametrize("over,match", [
    (dict(seed=torch.zeros((5, 4), dtype=torch.float64)), "seed has shape"),
    (dict(out=torch.empty((5, 3, 4), dtype=torch.float64)), "out has shape"),
    (dict(tc=torch.zeros((3, 4), dtype=torch.float64)), "tp and tc"),
    (dict(g=torch.zeros((5, 3, 2), dtype=torch.float32)), "dtype"),
])
def test_rk4_brusselator_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        runge_kutta.rk4_brusselator(**_ode_args(2, **over))


# ---------------------------------------------------------------------------
# K14-K17 and K10's species axis
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_new_reductions_keep_nan_on_card(cuda):
    """K14's and K15's per-lane max |g| give NaN for a lane holding a NaN
    (also beside an inf) and inf for an inf; a K16 lane whose state holds a
    NaN stops at once (max|g| >= tol is False on NaN), its neighbours run
    on."""
    s = _rand((4, 2, 33, 33), torch.float64, cuda, 35).clamp(-1, 1)
    r = torch.zeros_like(s)
    r[1, 0, 3, 4], r[2, 1, 0, 0] = float("nan"), float("inf")
    r[3, 0, 1, 1], r[3, 1, 32, 32] = float("inf"), float("nan")
    dt = torch.full((4,), 1e-3, dtype=torch.float64, device=cuda)
    for name, args in (("gray_scott_pointwise", (8e-5, 4e-5, 0.024, 0.084, 1e-3)),
                       ("burgers2d_pointwise", (0.05, 1.0 / 33))):
        (_, gk), (_, gp) = (getattr(ops, name)("residual", s, torch.empty_like(s), dt, *args, r=r)
                            for ops in (DISPATCH, PLAIN))
        assert torch.isnan(gk[1]) and torch.isinf(gk[2]) and torch.isnan(gk[3]), name
        assert float(gk[0]) == float(gp[0]), name
    x = torch.arange(32, dtype=torch.float64, device=cuda) / 32
    seed = torch.sin(2 * np.pi * x).repeat(3, 1)
    seed[1, 5] = float("nan")
    iters = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    out = torch.empty((3, 2, 32), dtype=torch.float64, device=cuda)
    DISPATCH.burgers1d_newton(seed, torch.full((2, 3), 0.05, dtype=torch.float64, device=cuda),
                              out, nu=0.05, dx=1.0 / 32, iters=iters)
    assert iters[:, 1].tolist() == [0, 0] and int(iters[0, 0]) >= 2
    assert bool(torch.isnan(out[1]).any()) and bool(torch.isfinite(out[[0, 2]]).all())


def _pair_problem(model, device):
    if model == "GrayScott2D":
        p0 = P.GrayScott2D(nx=16, method="IMPL", t_start=0, t_stop=4.0, nt=17, device=device)
        return [p0, P.GrayScott2D(nx=16, method="IMPL", t_interval=p0.t[::4], device=device)]
    if model == "Burgers2D":
        p0 = P.Burgers2D(nx=16, nu=0.05, t_start=0, t_stop=0.5, nt=17, device=device)
        return [p0, P.Burgers2D(nx=16, nu=0.05, t_interval=p0.t[::4], device=device)]
    if model == "Burgers1D":
        p0 = P.Burgers1D(nx=64, nu=0.05, t_start=0, t_stop=1, nt=33, device=device)
        return [p0, P.Burgers1D(nx=64, nu=0.05, t_interval=p0.t[::4], device=device)]
    return [P.Advection1D(c=1, x_start=-1, x_end=1, nx=65, t_start=0, t_stop=2, nt=nt,
                          device=device) for nt in (65, 33)]


_MODEL_KERNELS = {"GrayScott2D": ("periodic_solve2d", "gray_scott_pointwise"),
                  "Burgers2D": ("periodic_solve2d", "burgers2d_pointwise"),
                  "Burgers1D": ("burgers1d_newton",), "Advection1D": ("circulant_solve1d",)}


@pytest.mark.cuda
@pytest.mark.parametrize("model", list(_MODEL_KERNELS))
def test_small_new_model_solve_on_card_matches_cpu(cuda, model):
    """Two-level solves of the new models: the kernels on the card against
    the plain versions on the CPU, histories to rtol 1e-10 with an atol at
    the float64 floor."""
    runs = []
    for device in ("cpu", cuda):
        reset_launch_counts()
        mg = P.Mgrit(problem=_pair_problem(model, device), tol=1e-9, max_iter=10, logging_lvl=40)
        mg.solve()
        # every iteration's residual (solve() drops an exact 0 at the end)
        runs.append((mg.conv[1:mg.solve_iter + 1].copy(), mg.u[0].cpu(), launch_counts()))
    (hc, uc, _), (hg, ug, cg) = runs
    assert all(cg[k] > 0 for k in _MODEL_KERNELS[model]), cg
    np.testing.assert_allclose(hg, hc, rtol=1e-10, atol=1e-13)
    assert float((ug - uc).abs().max()) <= 1e-11


def _pair_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(mode="jacobian", s=torch.zeros((3, 2, 8, 8), **f),
                out=torch.empty((3, 2, 8, 8), **f), dt=torch.zeros(3, **f),
                w=torch.zeros((3, 2, 8, 8), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(mode="lap"), "mode must be"),
    (dict(w=None), "needs w"),
    (dict(mode="residual"), "needs r"),
    (dict(dt=torch.zeros(2, dtype=torch.float64)), "dt must be"),
    (dict(s=torch.zeros((3, 3, 8, 8), dtype=torch.float64)), "expected \\(B, 2, n, n\\)"),
    (dict(w=torch.zeros((3, 2, 8, 9), dtype=torch.float64)), "w has shape"),
    (dict(mode="expl", g=torch.zeros((3, 2, 8, 8), dtype=torch.float32)), "dtype"),
])
@pytest.mark.parametrize("kernel", ["gray_scott_pointwise", "burgers2d_pointwise"])
def test_pair_pointwise_rejects(kernel, over, match):
    args = _pair_args(**over)
    if kernel == "gray_scott_pointwise":
        args.update(du=1e-4, dv=1e-4, a=0.02, b=0.08, dx2=1.0)
    else:
        if args["mode"] == "expl":
            args["mode"] = "lap"
            match = "mode must be"
        args.pop("g", None)
        args.update(nu=0.05, dx=0.1)
    with pytest.raises(ValueError, match=match):
        getattr(pointwise, kernel)(**args)


def test_gray_scott_g_is_for_expl_only():
    z = torch.zeros((2, 2, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="EXPL steps only"):
        pointwise.gray_scott_pointwise("jacobian", z, torch.empty_like(z),
                                       torch.zeros(2, dtype=torch.float64), 1e-4, 1e-4, 0.02,
                                       0.08, 1.0, w=z, g=z)


@pytest.mark.parametrize("over,match", [
    (dict(coef=torch.zeros(3, dtype=torch.float64)), "coef must be"),
    (dict(gray_scott=(0.02, 0.08)), "Gray-Scott prologue"),
    (dict(b=torch.zeros((3, 2, 8, 8), dtype=torch.float64)), "out has shape"),
    (dict(b=torch.zeros((3, 2, 8, 8), dtype=torch.float64),
          out=torch.empty((3, 2, 8, 8), dtype=torch.float64), gray_scott=(0.02, 0.08), nu=2),
     "Gray-Scott prologue"),
])
def test_periodic_solve2d_species_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        periodic.periodic_solve2d(**_k10_args(**over))


def _line_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(seed=torch.zeros((5, 8), **f), dt=torch.zeros((3, 5), **f),
                out=torch.empty((5, 3, 8), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(seed=torch.zeros(5, dtype=torch.float64)), "seed has shape"),
    (dict(out=torch.empty((4, 3, 8), dtype=torch.float64)), "out has shape"),
    (dict(dt=torch.zeros((5, 3), dtype=torch.float64)), "dt must be"),
    (dict(g=torch.zeros((5, 2, 8), dtype=torch.float64)), "g must have"),
    (dict(dt=torch.zeros((3, 5), dtype=torch.float32)), "dtype"),
])
@pytest.mark.parametrize("kernel", ["burgers1d_newton", "circulant_solve1d"])
def test_line_kernels_reject(kernel, over, match):
    fn = (dense_newton.burgers1d_newton if kernel == "burgers1d_newton"
          else periodic.circulant_solve1d)
    with pytest.raises(ValueError, match=match):
        fn(**_line_args(**over))


def test_burgers1d_newton_rejects_iters_and_narrow_states():
    with pytest.raises(ValueError, match="iters must be"):
        dense_newton.burgers1d_newton(**_line_args(), iters=torch.zeros((3, 5), dtype=torch.int64))
    with pytest.raises(ValueError, match="n >= 3"):
        dense_newton.burgers1d_newton(**_line_args(seed=torch.zeros((5, 2), dtype=torch.float64),
                                                   out=torch.empty((5, 3, 2), dtype=torch.float64)))


def test_burgers1d_newton_shared_memory_limit():
    """K16 keeps no n x n matrix in shared memory: its workspace is 8 n
    values a lane in device memory, so sides past the old shared-memory cap
    (n = 168 and wider) take the kernel."""
    ws = dense_newton.workspace(3, 4096, torch.zeros(1, dtype=torch.float64))
    assert tuple(ws.shape) == (3, dense_newton.WORKSPACE * 4096) and dense_newton.WORKSPACE == 8
    assert not hasattr(dense_newton, "SMEM_LIMIT")


def _k20_args(**over):
    f64 = dict(dtype=torch.float64)
    args = dict(x=torch.zeros((4, 5), **f64), out=torch.empty((4, 5), **f64),
                S=torch.zeros((5, 5), **f64), lam=torch.zeros(5, **f64), dt=torch.zeros(4, **f64),
                rhs=torch.zeros((4, 5), **f64))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(x=torch.zeros((4, 5), dtype=torch.float32)), "dtype"),
    (dict(out=torch.empty((4, 6), dtype=torch.float64)), "out has shape"),
    (dict(out=torch.empty((3, 2, 5), dtype=torch.float64)), "out has shape"),
    (dict(S=torch.zeros((5, 6), dtype=torch.float64)), "S must be"),
    (dict(dt=None), "go together"),
    (dict(lam=None, dt=None), "rhs needs"),
    (dict(dt=torch.zeros(3, dtype=torch.float64)), "dt must be"),
    (dict(rhs=torch.zeros((4, 6), dtype=torch.float64)), "rhs has shape"),
])
def test_sine_solve1d_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        heat_kernels.sine_solve1d(**_k20_args(**over))


def test_sine_solve1d_rejects_out_sharing_x():
    tube = torch.zeros((8, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="shares memory"):
        heat_kernels.sine_solve1d(tube[:4], tube[4:], torch.zeros((5, 5), dtype=torch.float64))


def _k21_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(out=torch.zeros((6, 4), **f), terms=[torch.zeros((3, 4), **f)], coeffs=[1.0],
                io=torch.as_tensor([0, 6, 2]))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(terms=[torch.zeros((3, 4), dtype=torch.float64)] * 4, coeffs=[1.0] * 4), "1..3 terms"),
    (dict(coeffs=[1.0, 2.0]), "one coefficient"),
    (dict(terms=[torch.zeros((3, 5), dtype=torch.float64)]), "one N"),
    (dict(terms=[torch.zeros((2, 4), dtype=torch.float64)]), "term0 has 2 rows"),
    (dict(io=torch.as_tensor([0, 1, 2], dtype=torch.int32)), "int64"),
    (dict(io=torch.as_tensor([0, 1])), "term0 has 3 rows, expected 2"),
    (dict(idx=[torch.as_tensor([0, 1])]), "idx0 has 2 rows"),
    (dict(terms=[torch.zeros((3, 4), dtype=torch.float32)]), "dtype"),
])
def test_indexed_combine_rejects(over, match):
    from pymgrit_tpu_torch.ops import indexed
    with pytest.raises(ValueError, match=match):
        indexed.indexed_combine(**_k21_args(**over))


# ---------------------------------------------------------------------------
# K1, K18, K19 and K21 (CUDA C++ row kernels): bit for bit against the plain
# versions at the layouts the main paths give them, and the launch plans the
# wrappers compute
# ---------------------------------------------------------------------------

NF = 65 * 65            # a ragged65 / spatial65 fine state (4225 points)


def _row_cases(dtype, dev):
    """(label, kernel, launches, run(ops) -> tensor) of K1, K18, K19 and
    K21: rows at an odd element offset (every other 4225-point float64 row
    off 16-byte alignment, every row of the offset tube off by 8 bytes from
    its aligned neighbour), strided C-row views (tube[m::m]), dropped rows,
    out as a term, float32-pair-shaped rows, R = 0 and N = 0, the 1D
    example's 15 -> 7 and spatial65's 65^2 -> 33^2; K1's four layouts of
    phase 3 (groups of 16 and of 4 intervals with a partial last group, and
    of 1 on few intervals)."""
    flat = _rand((9 * NF + 1,), dtype, dev, 60)
    odd = flat[1:].view(9, NF)
    src = _rand((9, NF), dtype, dev, 61)
    tube = _rand((13, NF), dtype, dev, 62)
    pick = torch.as_tensor([3, 0, 8, 3, 5, 2], device=dev)
    put = torch.as_tensor([1, 9, 4, 0, 9, 7], device=dev)       # 9 = the row count: dropped
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    pairs = _rand((8, 2, 127), dtype, dev, 63).view(8, 254)     # (rows, 2, n) pair states as rows

    def k21_gather_odd(ops):
        out = torch.zeros((6, NF), dtype=dtype, device=dev)
        return ops.indexed_combine(out, [odd], [1.0], idx=[pick])

    def k21_gather_into_odd(ops):
        f = torch.zeros(6 * NF + 1, dtype=dtype, device=dev)
        ops.indexed_combine(f[1:].view(6, NF), [src], [1.0], idx=[pick])
        return f

    def k21_scatter_drop(ops):
        f = flat.clone()
        ops.indexed_combine(f[1:].view(9, NF), [src[:6]], [1.0], io=put)
        return f

    def k21_weighted_in_place(ops):
        f = flat.clone()
        out = f[1:].view(9, NF)
        ops.indexed_combine(out, [src[:4], out], [0.7, 0.3], io=pick[2:], idx=[None, pick[2:]])
        return f

    def k21_three(ops):
        out = torch.zeros((5, NF), dtype=dtype, device=dev)
        return ops.indexed_combine(out, [odd, src[4:9], odd[::2]], [1.0, -1.0, 0.25],
                                   idx=[pick[:5]])

    def k21_c_rows(ops):
        t = tube.clone()
        ops.indexed_combine(t[4::4], [src[:3], t[4::4]], [1.0, -1.0])
        out = torch.zeros((4, NF), dtype=dtype, device=dev)
        ops.indexed_combine(out, [t[2::3]], [0.5], idx=[pick[[0, 1, 3, 5]]])
        return torch.cat([t.reshape(-1), out.reshape(-1)])

    def k21_pairs(ops):
        out = pairs.clone()
        io = torch.as_tensor([7, 2, 8, 0, 5], device=dev)     # 8 = the row count: dropped
        ops.indexed_combine(out, [pairs], [1.0], io=io, idx=[pick[1:] % 8])
        return out

    def k21_empty(ops):
        out = src.clone()
        ops.indexed_combine(out, [src[:0]], [1.0], io=none)
        ops.indexed_combine(out[:, :0], [src[:, :0]], [1.0])
        return out

    ft1, ct1 = _rand((13, 15), dtype, dev, 64), _rand((13, 7), dtype, dev, 65)
    ft2, ct2 = _rand((9, 65, 65), dtype, dev, 66), _rand((9, 33, 33), dtype, dev, 67)
    fodd = _rand((4 * NF + 1,), dtype, dev, 68)[1:].view(4, 65, 65)

    def k18(ft, ct, nterms, nadds, dim, m):
        R = (ct.shape[0] - 1) // m

        def run(ops):
            out = ct.clone()
            ops.restrict_combine(out[m::m][:R], [ft[k:k + R * m:m] for k in range(nterms)],
                                 [1.0, -1.0, 0.5][:nterms],
                                 [ct[k:k + R * m:m] for k in range(nadds)], [1.0, -1.0][:nadds],
                                 dim)
            return out
        return run

    def k18_odd(ops):
        out = torch.zeros((4, 33, 33), dtype=dtype, device=dev)
        return ops.restrict_combine(out, [fodd, ft2[1::2]], [1.0, -1.0], [out], [1.0], 2)

    def k18_empty(ops):
        out = ct2.clone()
        ops.restrict_combine(out[:0], [ft2[:0]], [1.0], dim=2)
        return out

    def k19(ft, ct, with_b, dim, m):
        R = (ft.shape[0] - 1) // m

        def run(ops):
            out = ft.clone()
            ops.interpolate_combine(out[m::m][:R], ct[1:R + 1], ct[2:R + 2] if with_b else None,
                                    dim)
            return out
        return run

    def k19_odd(ops):
        out = torch.zeros(4 * NF + 1, dtype=dtype, device=dev)
        ops.interpolate_combine(out[1:].view(4, 65, 65), ct2[:4], ct2[4:8], 2)
        return out

    def k19_empty(ops):
        out = ft2.clone()
        ops.interpolate_combine(out[:0], ct2[:0], None, 2)
        return out

    # K1: seeds (J, N) with N = 65^2 (odd: the tube's rows alternate in
    # 16-byte alignment) and tables (T, N)
    seeds, A, G = (_rand(shape, dtype, dev, 69 + k) for k, shape in
                   enumerate([(250, NF), (6, NF), (6, NF)]))

    def k1(J, T, layout, r0=0):
        def run(ops):
            x = seeds[:J]
            if layout == "row-major":
                out = torch.zeros((T, J, NF), dtype=dtype, device=dev)
                ops.interval_affine(x, A, G, out.transpose(0, 1), r0)
            elif layout == "interval-major":
                out = torch.zeros((J, T, NF), dtype=dtype, device=dev)
                ops.interval_affine(x, A, G, out, r0)
            else:                       # the tube's blocks, seeds copied into the C-rows
                m = T + 1
                out = torch.zeros((J * m + 1, NF), dtype=dtype, device=dev)
                blocks = out[:J * m].view(J, m, NF)
                ops.interval_affine(x, A, G, blocks[:, 1:], r0, blocks[:, 0])
            return out
        return run

    return [("K21 gather from rows at an odd offset", "indexed_combine", 1, k21_gather_odd),
            ("K21 gather into rows at an odd offset", "indexed_combine", 1, k21_gather_into_odd),
            ("K21 drop-scatter", "indexed_combine", 1, k21_scatter_drop),
            ("K21 weighted update, out as a term", "indexed_combine", 1, k21_weighted_in_place),
            ("K21 three terms, one gathered", "indexed_combine", 1, k21_three),
            ("K21 strided C-row views", "indexed_combine", 2, k21_c_rows),
            ("K21 pair rows", "indexed_combine", 1, k21_pairs),
            ("K21 R = 0 and N = 0", "indexed_combine", 0, k21_empty),
            ("K18 1D 15 -> 7 FAS, C-rows m = 4", "restrict_combine", 1, k18(ft1, ct1, 2, 2, 1, 4)),
            ("K18 1D 15 -> 7 restriction", "restrict_combine", 1, k18(ft1, ct1, 1, 0, 1, 1)),
            ("K18 1D three terms, one add", "restrict_combine", 1, k18(ft1, ct1, 3, 1, 1, 3)),
            ("K18 2D 65^2 -> 33^2 FAS, C-rows m = 2", "restrict_combine", 1,
             k18(ft2, ct2, 2, 2, 2, 2)),
            ("K18 2D restriction", "restrict_combine", 1, k18(ft2, ct2, 1, 0, 2, 1)),
            ("K18 2D three terms, one add", "restrict_combine", 1, k18(ft2, ct2, 3, 1, 2, 2)),
            ("K18 2D at an odd offset, out as its add", "restrict_combine", 1, k18_odd),
            ("K18 R = 0", "restrict_combine", 0, k18_empty),
            ("K19 1D 7 -> 15 correction, C-rows m = 4", "interpolate_combine", 1,
             k19(ft1, ct1, True, 1, 4)),
            ("K19 1D interpolation", "interpolate_combine", 1, k19(ft1, ct1, False, 1, 1)),
            ("K19 2D 33^2 -> 65^2 correction, C-rows m = 2", "interpolate_combine", 1,
             k19(ft2, ct2, True, 2, 2)),
            ("K19 2D interpolation", "interpolate_combine", 1, k19(ft2, ct2, False, 2, 1)),
            ("K19 2D into rows at an odd offset", "interpolate_combine", 1, k19_odd),
            ("K19 R = 0", "interpolate_combine", 0, k19_empty),
            ("K1 materialize J = 250 (groups of 16, the last partial)", "interval_affine", 1,
             k1(250, 5, "tube")),
            ("K1 row-major J = 130 (groups of 4, the last partial)", "interval_affine", 1,
             k1(130, 5, "row-major")),
            ("K1 interval-major J = 131, rows 1..4", "interval_affine", 1,
             k1(131, 4, "interval-major", 1)),
            ("K1 only_last J = 3 (groups of 1)", "interval_affine", 1, k1(3, 1, "row-major", 5)),
            ("K1 materialize J = 3", "interval_affine", 1, k1(3, 5, "tube"))]


N_ROW_CASES = 27


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", range(N_ROW_CASES))
def test_row_kernels_match_plain_bit_for_bit_on_card(cuda, dtype, case):
    label, name, launches, run = _row_cases(dtype, cuda)[case]
    before = launch_counts()[name]
    out_k = run(DISPATCH)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + launches, label
    assert torch.equal(out_k, run(PLAIN)), label
    assert torch.equal(out_k, run(DISPATCH)), label


@pytest.mark.parametrize("case", range(N_ROW_CASES))
def test_row_cases_take_the_plain_version_on_cpu(case):
    cases = _row_cases(torch.float64, torch.device("cpu"))
    assert len(cases) == N_ROW_CASES
    label, name, _, run = cases[case]
    reset_launch_counts()
    assert torch.equal(run(DISPATCH), run(PLAIN)), label
    assert launch_counts()[name] == 0


@pytest.mark.parametrize("es,vec", [
    (8, 2),      # float64: two a 16-byte vector
    (4, 4),      # float32 (the DD pair rows): four
])
def test_indexed_plan_vector_width(es, vec):
    # one width a dtype: the kernel decides row by row between it and
    # scalar loads (every operand at one offset from 16-byte alignment)
    from pymgrit_tpu_torch.ops import indexed
    assert indexed.plan(515, 4225, es, 1, 132)[0] == vec


@pytest.mark.parametrize("R,N,nt,es,segs,grid", [
    (515, 4225, 1, 8, 17, 528),    # ragged65's gather: 8755 warp items, 132 SMs x 4 blocks
    (515, 4225, 3, 8, 34, 528),    # two or three terms: 2 vectors a lane, segments of 128
    (514, 8450, 1, 4, 17, 528),    # float32 pair rows: 4 a vector
    (3, 7, 1, 8, 1, 1),
    (40, 300, 2, 8, 3, 15),        # two terms: segments of 128; 120 items, 8 warps a block
])
def test_indexed_plan_segments_and_grid(R, N, nt, es, segs, grid):
    from pymgrit_tpu_torch.ops import indexed
    assert indexed.plan(R, N, es, nt, 132)[1:] == (segs, grid)


def _ptxas_entry(mangled, regs, spills, smem=0):
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {spills[0]} bytes stack frame, {spills[0]} bytes spill stores, "
            f"{spills[1]} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, "
            + (f"{smem} bytes smem, " if smem else "") + "560 bytes cmem[0]\n")


@pytest.mark.parametrize("mangled,table,label,want", [
    ("_ZN12_GLOBAL__N_122indexed_combine_kernelIdLi3EEEvNS_6ParamsE", "row",
     "K21 f64 terms 3", (64, 64, 88, 0)),
    ("_ZN12_GLOBAL__N_123restrict_combine_kernelIfLi1ELi2ELi0EEEvNS_6ParamsE", "row",
     "K18 f32 dim 1 terms 2 adds 0", (36, 0, 0, 0)),
    ("_ZN12_GLOBAL__N_126interpolate_combine_kernelIdLi2ELb1EEEvNS_6ParamsE", "row",
     "K19 f64 dim 2 b 1", (40, 0, 0, 0)),
    ("_ZN12_GLOBAL__N_122interval_affine_kernelIfLi16EEEvPKflS2_S2_lllllPflS3_l", "row",
     "K1 f32 intervals 16", (40, 0, 0, 0)),
    ("_Z12tile_productIdLb0ELi64ELi8ELi16ELi3ELi2EEvPKdS1_Pdll", "tile",
     "K22 f64 64x8x16x3", (126, 0, 0, 8192)),
    ("_Z13reduce_slicesIdLb1EEvPKdPdll", "tile", "reduce dd", (40, 0, 0, 0)),
    ("_ZN11sine2d_dmma24sine_solve2d_dmma_kernelILi128EEEvNS_6ParamsE", "k35", "K5 f64 T=128",
     (128, 0, 0, 0)),
    ("_ZN12_GLOBAL__N_125residual_row_norms_kernelIfEEvPKT_S3_PS1_lll", "k35", "K3 f32",
     (32, 0, 0, 64)),
    ("_ZN11sine2d_dmma12band_productENS_8BandArgsE", "k35", "K5 f64 band", (126, 0, 0, 0)),
    ("_ZN11sine2d_dmma12band_productILb0EEEvNS_8BandArgsE", "k35", "K5 f64 band",
     (124, 0, 0, 0)),
    ("_ZN11sine2d_dmma12band_productILb1EEEvNS_8BandArgsE", "k35", "K6 f64 band split",
     (124, 0, 0, 0)),
    ("_ZN12_GLOBAL__N_125sine_affine2d_dmma_kernelILi64EEEvNS_4CallIdEE", "k35",
     "K6 f64 T=64", (116, 0, 0, 0)),
    ("_ZN12_GLOBAL__N_118theta_rhs2d_kernelIdLi1EEEvNS_4ArgsIT_EE", "k35", "K7 f64 CN",
     (66, 0, 0, 0)),
])
def test_ptxas_log_parser(mangled, table, label, want):
    # chip_smoke's [build] line: one parser of the ptxas log for K1, K18,
    # K19, K21, for the product tile and for K3 / K5 / K6 / K7; entries of
    # other kernels are skipped
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    regs, st, ld, sm = want
    log = (_ptxas_entry("_Z15theta_chain_f64PKdS0_Pdl", 40, (8, 8))
           + _ptxas_entry(mangled, regs, (st, ld), sm))
    name, lab = {"row": (chip_smoke.ROW_NAME, chip_smoke.row_label),
                 "tile": (chip_smoke.TILE_OR_REDUCE, chip_smoke.tile_label),
                 "k35": (chip_smoke.K3_K5_NAME, chip_smoke.k3_k5_label)}[table]
    assert chip_smoke.ptxas(log, name, lab) == {label: want}


@pytest.mark.parametrize("mangled,owner", [
    ("_ZN11sine2d_dmma24sine_solve2d_dmma_kernelILi16EEEvNS_6ParamsE", "sine_solve2d T=16"),
    ("_ZN12_GLOBAL__N_125sine_affine2d_dmma_kernelILi128EEEvNS_4CallIdEE",
     "sine_affine2d T=128"),
    ("_ZN11sine2d_dmma12band_productILb0EEEvNS_8BandArgsE", "sine_solve2d band"),
    ("_ZN11sine2d_dmma12band_productILb1EEEvNS_8BandArgsE", "sine_affine2d band split"),
    ("_Z12tile_productIdLb1ELi64ELi64ELi16ELi3ELi1EEvPKdS1_Pdll", "dd_matmul"),
])
def test_dmma_owner_by_instantiation(mangled, owner):
    # chip_smoke's [build] counts DMMA instructions by kernel instantiation:
    # K5's five and K6's five float64 kernels each need some
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    assert chip_smoke.tile_owner(mangled) == owner


@pytest.mark.parametrize("wrapper", ["indexed", "restrict", "interpolate"])
def test_row_wrappers_make_no_launch_on_cpu(wrapper):
    # the cached checks of a CPU call carry no launch (no library, no SM
    # count is asked for) and send the call to the plain version
    from pymgrit_tpu_torch.ops import indexed, transfer
    from pymgrit_tpu_torch.ops.heat_kernels import fact
    x = _rand((5, 9, 9), torch.float64, "cpu", 71)
    if wrapper == "indexed":
        out = torch.empty(4, 81, dtype=torch.float64)
        R, on_cpu, launch = indexed._checked((fact(out), fact(x.reshape(5, 81)[1:])), None,
                                             (None,))
        assert (R, on_cpu, launch) == (4, True, None)
    elif wrapper == "restrict":
        out = torch.empty(5, 5, 5, dtype=torch.float64)
        R, on_cpu, _, _, launch = transfer._restrict_checked(2, 1, (fact(out), fact(x)))
        assert (R, on_cpu, launch) == (5, True, None)
    else:
        coarse = torch.empty(5, 5, 5, dtype=torch.float64)
        on_cpu, es, empty, launch = transfer._interp_checked(2, (fact(x), fact(coarse)))
        assert (on_cpu, es, empty, launch) == (True, 8, (False, False), None)


def test_indexed_pack_layout():
    from pymgrit_tpu_torch.ops import indexed
    args = indexed.pack(1, (100, 200, 300), 400, (500, 0), (4225, 4225, 8450), 4097, 515, 4225,
                        2, (2, 17, 528))
    assert list(args) == [1, 100, 400, 200, 300, 0, 500, 0, 0, 4225, 4225, 8450, 0, 4097, 515,
                          4225, 17, 2, 2, 528]


@pytest.mark.parametrize("R,Pc,Qc,dim,sms", [
    (1024, 33, 33, 2, 132), (1025, 33, 33, 2, 132), (64, 1, 7, 1, 132), (37, 5, 6, 2, 1),
    (5, 1, 3, 1, 2),
])
def test_restrict_plan_walks_every_point_once(R, Pc, Qc, dim, sms):
    from pymgrit_tpu_torch.ops import transfer
    grid, dr, di, dj = transfer.restrict_plan(R, Pc, Qc, dim, sms)
    per_block = transfer.THREADS * transfer.UNROLL[dim]
    assert grid == max(1, min(sms * transfer.BLOCKS_PER_SM, -(-R * Pc * Qc // per_block)))
    assert (dr * Pc + di) * Qc + dj == grid * transfer.THREADS and 0 <= di < Pc and 0 <= dj < Qc
    # the kernel's walk (csrc/restrict_combine.cu): one division for a
    # thread's first point, then the stride added with carries
    t = np.arange(grid * transfer.THREADS)
    r, rem = np.divmod(t, Pc * Qc)
    i, j = np.divmod(rem, Qc)
    seen = np.zeros(R * Pc * Qc, dtype=np.int64)
    while (r < R).any():
        m = r < R
        np.add.at(seen, (r[m] * Pc + i[m]) * Qc + j[m], 1)
        j = j + dj
        i = i + (j >= Qc)
        j = np.where(j >= Qc, j - Qc, j)
        i = i + di
        r = r + (i >= Pc) + dr
        i = np.where(i >= Pc, i - Pc, i)
    assert (seen == 1).all()


@pytest.mark.parametrize("R,Pf,Qf,sms", [
    (1024, 65, 65, 132), (64, 1, 15, 132), (9, 17, 13, 1), (5, 1, 3, 2),
])
def test_interpolate_plan_walks_every_point_once(R, Pf, Qf, sms):
    # K19's walk of the fine points (csrc/interpolate_combine.cu ``advance``)
    from pymgrit_tpu_torch.ops import transfer
    grid, dr, dp, dq = transfer.interpolate_plan(R, Pf, Qf, sms)
    per_block = transfer.INTERP_THREADS * transfer.INTERP_UNROLL
    assert grid == max(1, min(sms * transfer.INTERP_BLOCKS_PER_SM, -(-R * Pf * Qf // per_block)))
    assert (dr * Pf + dp) * Qf + dq == grid * transfer.INTERP_THREADS
    t = np.arange(grid * transfer.INTERP_THREADS)
    r, rem = np.divmod(t, Pf * Qf)
    p, q = np.divmod(rem, Qf)
    seen = np.zeros(R * Pf * Qf, dtype=np.int64)
    while (r < R).any():
        m = r < R
        np.add.at(seen, (r[m] * Pf + p[m]) * Qf + q[m], 1)
        q = q + dq
        p = p + (q >= Qf)
        q = np.where(q >= Qf, q - Qf, q)
        p = p + dp
        r = r + (p >= Pf) + dr
        p = np.where(p >= Pf, p - Pf, p)
    assert (seen == 1).all()


def test_interpolate_pack_layout():
    from pymgrit_tpu_torch.ops import transfer
    # dst's, a's and b's row strides, then the shapes, whether b is given, the plan
    args = transfer.interpolate_pack(1, (8450, 1089, 2178), 1024, 33, 33, 65, 65, 2,
                                     (1056, 64, 0, 64))
    assert list(args) == [1, 8450, 1089, 2178, 1024, 33, 33, 65, 65, 2, 1, 1056, 64, 0, 64]
    args = transfer.interpolate_pack(0, (15, 7), 64, 1, 7, 1, 15, 1, (4, 68, 0, 4))
    assert list(args) == [0, 15, 7, 7, 64, 1, 7, 1, 15, 1, 0, 4, 68, 0, 4]


def test_restrict_pack_layout():
    from pymgrit_tpu_torch.ops import transfer
    # out, two terms, one add: pointers and row strides in that order
    args = transfer.restrict_pack(2, (10, 20, 30, 40), (12, 70, 35, 24), 2, 1, 4, 7, 3, 4, 2,
                                  (5, 1, 2, 3))
    assert list(args) == [2, 10, 20, 30, 0, 40, 0, 12, 70, 35, 0, 24, 0, 4, 7, 3, 4, 2, 2, 1,
                          5, 1, 2, 3]


def test_restrict_combine_out_as_the_same_view_of_an_add():
    from pymgrit_tpu_torch.ops import transfer
    ft, ct = _rand((8, 9, 11), torch.float64, "cpu", 69), _rand((8, 5, 6), torch.float64, "cpu", 70)
    want = transfer.restrict_combine_plain(torch.empty_like(ct[1::2]), [ft[::2]], [1.0],
                                           [ct[1::2]], [1.0], 2)
    transfer.restrict_combine(ct[1::2], [ft[::2]], [1.0], [ct[1::2]], [1.0], 2)
    assert torch.equal(ct[1::2], want)
    with pytest.raises(ValueError, match="out overlaps add0"):
        transfer.restrict_combine(ct[1:5], [ft[:4]], [1.0], [ct[2:6]], [1.0], 2)


def _k22_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(x=torch.zeros((3, 5), **f), out=torch.empty((3, 5), **f),
                W=torch.zeros((5, 5), **f), V=torch.zeros((5, 5), **f), lam=torch.zeros(5, **f),
                dt=torch.zeros(3, **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(out=torch.empty((3, 4), dtype=torch.float64)), "equal"),
    (dict(W=torch.zeros((5, 4), dtype=torch.float64)), "tables"),
    (dict(V=torch.zeros((5, 5), dtype=torch.float64).t()), "contiguous"),
    (dict(lam=torch.zeros(4, dtype=torch.float64)), "lam"),
    (dict(dt=torch.zeros(2, dtype=torch.float64)), "dt"),
    (dict(x=torch.zeros((3, 5), dtype=torch.float32)), "dtype"),
])
def test_eig_step_rejects(over, match):
    from pymgrit_tpu_torch.ops import eig_step
    with pytest.raises(ValueError, match=match):
        eig_step.eig_step(**_k22_args(**over))


def _k20_bdf2_args(**over):
    f = dict(dtype=torch.float64)
    v = torch.zeros(3, **f)
    args = dict(x=torch.zeros((3, NI), **f), out=torch.empty((3, NI), **f),
                S=torch.zeros((NI, NI), **f), lam=torch.zeros(NI, **f),
                rhs=torch.zeros((3, NI), **f), second=torch.zeros((3, NI), **f), c2=v, c1=v,
                coeff=v)
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(dt=torch.zeros(3, dtype=torch.float64)), "no dt"),
    (dict(second=None), "BDF2 takes"),
    (dict(coeff=None), "belong to BDF2"),
    (dict(c1=torch.zeros(2, dtype=torch.float64)), "c1 must be"),
    (dict(second=torch.zeros((2, NI), dtype=torch.float64)), "second has shape"),
])
def test_sine_solve1d_bdf2_rejects(over, match):
    with pytest.raises(ValueError, match=match):
        heat_kernels.sine_solve1d(**_k20_bdf2_args(**over))


# ---------------------------------------------------------------------------
# K23-K26: the double-double kernels (float32 pairs)
# ---------------------------------------------------------------------------
#
# K23-K25 execute the plain versions' float32 operations in their order,
# each rounded once (__fadd_rn & co., never contracted), so the card holds
# them bit for bit in hi and lo.  K26 accumulates float64 products in
# DMMA's k4 groups: within 1e-14 of max(|A| |B|) of the plain float64
# product.


def _dd(a, device):
    from pymgrit_tpu_torch.ops import dd
    return dd.from_f64(np.ascontiguousarray(a), device)


def _packed(a, device):
    x = _dd(a, device)
    return torch.stack([x.hi, x.lo], 1)


def _dd_cases(dev):
    """(kernel, run(ops) -> DD or float32 tensor) at small shapes, with the
    solver's packed (rows, 2, ...) views, wild scales and broadcasts."""
    from pymgrit_tpu_torch.ops import dd
    rng = np.random.default_rng(40)
    J, R, T = 3, 4, 5
    seeds = _packed(rng.standard_normal((J, N)), dev)
    A, G = _dd(rng.uniform(0, 1, (T, N)), dev), _dd(rng.standard_normal((T, N)), dev)
    tube = torch.zeros((J * R + 1, 2, N), dtype=torch.float32, device=dev)

    def k23(ops):
        out = dd.pair(tube[:J * R].view(J, R, 2, N), ops, 2)
        ops.dd_interval_affine(dd.pair(seeds, ops), A, G, out, 1, dd.pair(tube[0:J * R:R], ops))
        return dd.pair(tube, ops)

    L = 3
    x0 = _packed(rng.standard_normal((J, N)), dev)
    g = torch.stack([_packed(1e-3 * rng.standard_normal((J, N)), dev) for _ in range(L)], 1)
    dt = _dd(rng.uniform(0.01, 0.1, (L, J)), dev)
    lam, lift = _dd(rng.uniform(1, 1e3, N), dev), _dd(rng.standard_normal(N), dev)
    r1 = torch.as_tensor(rng.standard_normal((L, 1, N)), dtype=torch.float32,
                         device=dev).expand(L, J, N)
    r0 = torch.as_tensor(rng.standard_normal((L, 1, N)), dtype=torch.float32,
                         device=dev).expand(L, J, N)

    def k24(theta, with_g):
        def run(ops):
            out = torch.empty((J, L, 2, N), dtype=torch.float32, device=dev)
            ops.dd_theta_chain(dd.pair(x0, ops), dd.pair(out, ops, 2), dt, lam, lift, r1, r0,
                               theta, dd.pair(g, ops, 2) if with_g else None)
            return dd.pair(out, ops, 2)
        return run

    wild = rng.standard_normal((J, N)) * 10.0 ** rng.uniform(-20, 20, (J, N))
    xw, yw = _dd(wild, dev), _dd(np.abs(wild[::-1]) + 1e-30, dev)
    near = _dd(1.0 + 3.975e-12 * rng.uniform(0.5, 1.5, N), dev)
    rows = [_packed(rng.standard_normal((J, N)), dev) for _ in range(3)]

    def k25(op, *args, **kw):
        return lambda ops: ops.dd_arith(op, *args, **kw)

    def k25_packed(coeffs):
        def run(ops):
            out = torch.empty((J, 2, N), dtype=torch.float32, device=dev)
            return ops.dd_arith("combine", *[dd.pair(r, ops) for r in rows[:len(coeffs)]],
                                coeffs=coeffs, out=dd.pair(out, ops))
        return run

    def k25_scalar(ops):
        return ops.dd_arith("div", _dd(np.float64(0.7371), dev), dd.from_f64(1.0 + 0.05))

    S, _ = sine_eigenbasis(NI, (NI + 1.0) ** 2)
    Sd = _dd(S, dev)
    states = _dd(rng.standard_normal((7, NI + 2, NI + 2)), dev)

    def k26_two_sided(ops):
        Sb = Sd.expand(7, NI, NI)
        return ops.dd_matmul(ops.dd_matmul(Sb, states[:, 1:-1, 1:-1]), Sb)

    W = _dd(rng.standard_normal((70, 70)) / 8, dev)
    xe = _dd(rng.standard_normal((5, 70)), dev)
    return [("dd_interval_affine", k23),
            ("dd_theta_chain", k24(1.0, True)), ("dd_theta_chain", k24(0.5, False)),
            ("dd_arith", k25("add", xw, yw)), ("dd_arith", k25("sub", xw, yw)),
            ("dd_arith", k25("mul", xw, yw)), ("dd_arith", k25("div", xw, yw)),
            ("dd_arith", k25("sqrt", yw)), ("dd_arith", k25("neg", xw)),
            ("dd_arith", k25("sub", near, dd.from_f64(1.0))),
            ("dd_arith", k25("resid", xw, yw)), ("dd_arith", k25_packed([1.0, -1.0, 1.0])),
            ("dd_arith", k25_packed([1.3, 1.0 - 1.3])), ("dd_arith", k25_scalar),
            ("dd_matmul", k26_two_sided),
            ("dd_matmul", lambda ops: ops.dd_matmul(xe[None], W.T[None]))]


N_DD_CASES = 16


def _dd_parts(out):
    return (out.hi, out.lo) if hasattr(out, "hi") else (out,)


@pytest.mark.cuda
def test_dd_kernels_match_plain_on_card(cuda):
    for i, (name, run) in enumerate(_dd_cases(cuda)):
        reset_launch_counts()
        out_k = _dd_parts(run(DISPATCH))
        torch.cuda.synchronize()
        assert launch_counts()[name] >= 1, (i, name)
        out_p = _dd_parts(run(PLAIN))
        if name == "dd_matmul":
            k, p = (sum(t.double() for t in o) for o in (out_k, out_p))
            assert float((k - p).abs().max()) <= 1e-14 * float(p.abs().max()) * 8, (i, name)
            continue
        for a, b in zip(out_k, out_p):
            assert torch.equal(a.contiguous().view(torch.int32),
                               b.contiguous().view(torch.int32)), (i, name)


@pytest.mark.parametrize("case", range(N_DD_CASES))
def test_dd_cpu_tensors_take_the_plain_version(case):
    cases = _dd_cases(torch.device("cpu"))
    assert len(cases) == N_DD_CASES
    name, run = cases[case]
    reset_launch_counts()
    for a, b in zip(_dd_parts(run(DISPATCH)), _dd_parts(run(PLAIN))):
        np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))
    assert launch_counts() == {k: 0 for k in launch_counts()}


def _dd_kernel_args(kernel, **over):
    from pymgrit_tpu_torch.ops import dd
    z = lambda *shape: dd.from_f64(np.zeros(shape))
    f32 = torch.zeros((2, 3, N), dtype=torch.float32)
    args = {"dd_interval_affine": dict(x=z(3, N), A=z(4, N), G=z(4, N), out=z(3, 4, N), r0=0),
            "dd_theta_chain": dict(x0=z(3, N), out=z(3, 2, N), dt=z(2, 3), lam=z(N), lift=z(N),
                                   rhs1=f32, rhs0=f32, theta=1.0),
            "dd_matmul": dict(a=z(2, 3, 4), b=z(2, 4, 5))}[kernel]
    args.update(over)
    return args


def _dd_swap(key):
    from pymgrit_tpu_torch.ops import dd
    z = lambda *shape: dd.from_f64(np.zeros(shape))
    return {"narrow": z(2, 4, N), "dt": z(3, 2), "b": z(2, 3, 5), "2-D": z(3, 4),
            "f64": dd._raw(torch.zeros((4, N), dtype=torch.float64),
                           torch.zeros((4, N), dtype=torch.float64))}[key]


@pytest.mark.parametrize("kernel,over,match", [
    ("dd_interval_affine", dict(x=torch.zeros((3, N))), "DD pair"),
    ("dd_interval_affine", dict(r0=1), "outside"),
    ("dd_interval_affine", dict(out="narrow"), "expected"),
    ("dd_interval_affine", dict(A="f64"), "float32"),
    ("dd_theta_chain", dict(dt="dt"), "dt must be"),
    ("dd_theta_chain", dict(theta=0.0), "theta"),
    ("dd_theta_chain", dict(rhs1=torch.zeros((2, 3, N), dtype=torch.float64)), "float32"),
    ("dd_matmul", dict(b="b"), "do not chain"),
    ("dd_matmul", dict(a="2-D"), "3-D"),
])
def test_dd_wrappers_reject(kernel, over, match):
    from pymgrit_tpu_torch.ops import dd_matmul
    over = {k: _dd_swap(v) if isinstance(v, str) else v for k, v in over.items()}
    fn = dd_matmul.dd_matmul if kernel == "dd_matmul" else getattr(heat_kernels, kernel)
    with pytest.raises(ValueError, match=match):
        fn(**_dd_kernel_args(kernel, **over))


def test_dd_arith_rejects():
    from pymgrit_tpu_torch.ops import dd
    x = dd.from_f64(np.zeros((3, 4)))
    with pytest.raises(ValueError, match="unknown op"):
        dd.dd_arith("pow", x, x)
    with pytest.raises(ValueError, match="takes 2"):
        dd.dd_arith("add", x)
    with pytest.raises(ValueError, match="1-8 operands"):
        dd.dd_arith("combine", *[x] * 9, coeffs=[1.0] * 9)
    with pytest.raises(ValueError, match="DD pairs"):
        dd.dd_arith("add", x, torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="out has shape"):
        dd.dd_arith("add", x, x, out=dd.from_f64(np.zeros((3, 5))))
    with pytest.raises(ValueError, match="must lie on"):
        dd.dd_arith("add", x, dd.from_f64(np.zeros((3, 4)), "meta"))


def _small_dd_solve(device, basis):
    t = np.linspace(0, 1, 129)
    problem = [P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=17, ny=17, a=1.0,
                        rhs=lambda x, y, t: np.sin(np.pi * x) * np.sin(np.pi * y) + 0 * t,
                        init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                        t_interval=t[::s], basis=basis, device=device, precision="dd")
               for s in (1, 4, 16)]
    reset_launch_counts()
    mgrit = P.Mgrit(problem=problem, tol=1e-11, max_iter=8, logging_lvl=40)
    mgrit.solve()
    return mgrit.conv[1:mgrit.solve_iter + 1], mgrit.u[0].cpu(), launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["spectral", "physical"])
def test_small_dd_solve_on_card_matches_cpu(cuda, basis):
    """Heat2D 17^2 in DD on the card against the CPU: the spectral path
    (K23-K25, bit for bit with the plain versions, which round as the
    CPU's float32 ops do) gives the CPU's tube bit for bit; the physical
    one (K25, K26) agrees to 1e-12.  No float64 kernel runs."""
    (hc, tc, _), (hg, tg, cg) = (_small_dd_solve(d, basis) for d in ("cpu", cuda))
    np.testing.assert_allclose(hg, hc, rtol=1e-5)
    needed = ("dd_interval_affine", "dd_theta_chain") if basis == "spectral" else ("dd_matmul",)
    assert all(cg[k] > 0 for k in needed + ("dd_arith", "residual_row_norms")), cg
    assert all(cg[k] == 0 for k in ("interval_affine", "theta_chain", "cpoint_combine",
                                    "sine_solve2d", "sine_affine2d", "theta_rhs2d")), cg
    if basis == "spectral":
        assert torch.equal(tg.view(torch.int32), tc.view(torch.int32))
    else:
        assert float((tg.double() - tc.double()).abs().max()) <= 1e-12


# ---------------------------------------------------------------------------
# K22 and K26 on each regime of the shared FP64 product tile
# (ops/product_tile.py::product_plan): the skinny tiles with their split of
# the inner index, the wide tile with and without one, aligned (16-byte) and
# unaligned (8- and 4-byte) copies, K-major and row-major operands.  Held
# to K22's tolerance (normwise 1e-12 in float64, 1e-4 in float32: the
# products sum ~sqrt(N) roundings in another order than cuBLAS) and to
# K26's (1e-14 of max |A| |B|); a second launch of the same call gives the
# same bits (the slices are summed in order, no atomics).

EIG_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}
NE = 600               # table side: wide enough to split the inner index


def _eig_operands(dtype, dev, lanes, aligned):
    rng = np.random.default_rng(90 + lanes)
    W, V = (torch.as_tensor(rng.uniform(-1, 1, (NE, NE)) / NE ** 0.5, dtype=dtype, device=dev)
            for _ in range(2))
    lam = torch.as_tensor(rng.uniform(0, 2, NE), dtype=dtype, device=dev)
    dt = torch.as_tensor(rng.uniform(0.1, 1.0, lanes), dtype=dtype, device=dev)
    # strided lanes: every other row of a wider buffer; unaligned: an odd
    # row stride and a one-element offset (8-byte, float32 4-byte copies)
    buf = torch.as_tensor(rng.uniform(-1, 1, (2 * lanes, NE + 3)), dtype=dtype, device=dev)
    x = buf[::2, :NE] if aligned else buf[::2, 1:NE + 1]
    return x, W, V, lam, dt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes", [1, 3, 8, 16, 70, 128, 257])
@pytest.mark.parametrize("aligned", [True, False])
def test_eig_step_plans_on_card(cuda, dtype, lanes, aligned):
    from pymgrit_tpu_torch.ops import eig_step
    x, W, V, lam, dt = _eig_operands(dtype, cuda, lanes, aligned)
    plan = eig_step.plan(x, W, V)
    # the lanes' copies: 16 bytes where every lane row starts 16-byte aligned
    # (a float32 row stride of 1206 elements is only 8-byte aligned; one
    # lane has no stride), one element where the rows start off by one
    es = x.element_size()
    want_copy = (16 if lanes == 1 or es == 8 else 8) if aligned else es
    assert plan.swap and plan.copy[1] == want_copy, plan.describe()
    want = eig_step.eig_step_plain(x, torch.empty_like(x), W, V, lam, dt)
    before = eig_step.eig_step.launches
    got = eig_step.eig_step(x, torch.empty_like(x), W, V, lam, dt)
    again = eig_step.eig_step(x, torch.empty_like(x), W, V, lam, dt)
    x_in = x.clone()
    inplace = eig_step.eig_step(x, x, W, V, lam, dt)          # out = x
    torch.cuda.synchronize()
    assert eig_step.eig_step.launches == before + 3
    err = float((got - want).abs().max())
    assert err <= EIG_RTOL[dtype] * float(want.abs().max()), (plan.describe(), err)
    assert torch.equal(got, again), plan.describe()
    assert torch.equal(inplace, got), plan.describe()
    assert not torch.equal(x, x_in)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ne", [6, 24])
@pytest.mark.parametrize("aligned", [True, False])
def test_eig_step_lanes_past_the_table_on_card(cuda, dtype, ne, aligned):
    """64 lanes of a table 6 or 24 wide: the lanes are the long axis (no
    swap), so the tile's A side is the lanes and its B side the table, each
    copied at its own width (lanes off by one element: element copies)."""
    from pymgrit_tpu_torch.ops import eig_step
    lanes = 64
    rng = np.random.default_rng(92 + ne)
    W, V = (torch.as_tensor(rng.uniform(-1, 1, (ne, ne)) / ne ** 0.5, dtype=dtype, device=cuda)
            for _ in range(2))
    lam = torch.as_tensor(rng.uniform(0, 2, ne), dtype=dtype, device=cuda)
    dt = torch.as_tensor(rng.uniform(0.1, 1.0, lanes), dtype=dtype, device=cuda)
    buf = torch.as_tensor(rng.uniform(-1, 1, (lanes, ne + 2)), dtype=dtype, device=cuda)
    x = buf[:, :ne] if aligned else buf[:, 1:ne + 1]
    plan = eig_step.plan(x, W, V)
    assert not plan.swap and (aligned or plan.copy[0] == x.element_size()), plan.describe()
    want = eig_step.eig_step_plain(x, torch.empty_like(x), W, V, lam, dt)
    got = eig_step.eig_step(x, torch.empty_like(x), W, V, lam, dt)
    again = eig_step.eig_step(x, torch.empty_like(x), W, V, lam, dt)
    inplace = eig_step.eig_step(x, x, W, V, lam, dt)          # out = x
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= EIG_RTOL[dtype] * float(want.abs().max()), (plan.describe(), err)
    assert torch.equal(got, again) and torch.equal(inplace, got), plan.describe()


def _dd_product_cases(dev):
    """(label, a, b) DD operands: the 63-wide Heat2D products (rows 252 B,
    4-byte copies; S broadcast over the batch with stride 0; each block
    walks several entries; B row-major,
    b.sr != 1), Diffusion2D's table product at 1, 8 and 128 rows (b = W^T,
    b.sr == 1, split inner index), an inner length that is no multiple of a
    k-tile or of the ring, a row-major A and an operand with no unit
    stride (element copies)."""
    from pymgrit_tpu_torch.ops import dd
    rng = np.random.default_rng(91)

    def pair(a):
        return dd.from_f64(np.ascontiguousarray(a), dev)

    n2, Bn = 63, 900      # more entries than a wave of blocks: each block walks several
    S = pair(sine_eigenbasis(n2, (n2 + 1.0) ** 2)[0])
    states = pair(rng.uniform(-1, 1, (Bn, n2 + 2, n2 + 2)))
    W = pair(rng.uniform(-1, 1, (NE, NE)) / NE ** 0.5)
    cases = [("63-wide S @ states", S.expand(Bn, n2, n2), states[:, 1:-1, 1:-1]),
             ("63-wide states @ S", states[:, 1:-1, 1:-1], S.expand(Bn, n2, n2))]
    for rows in (1, 8, 128):
        cases.append((f"table {rows} rows", pair(rng.uniform(-1, 1, (1, rows, NE))), W.T[None]))
    odd = pair(rng.uniform(-1, 1, (3, 70, 37)))
    cases.append(("K = 37", odd, pair(rng.uniform(-1, 1, (3, 37, 50)))))
    at = pair(rng.uniform(-1, 1, (2, 300, 90)))
    cases.append(("row-major A", dd._raw(at.hi.transpose(1, 2), at.lo.transpose(1, 2)),
                  pair(rng.uniform(-1, 1, (2, 300, 20)))))
    wide = pair(rng.uniform(-1, 1, (2, 45, 2 * 33)))
    cases.append(("no unit stride", pair(rng.uniform(-1, 1, (2, 17, 45))), wide[:, :, ::2]))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(8))
def test_dd_matmul_plans_on_card(cuda, case):
    from pymgrit_tpu_torch.ops import dd_matmul
    label, a, b = _dd_product_cases(cuda)[case]
    plan = dd_matmul.plan(a, b)
    a64, b64 = (x.hi.double() + x.lo.double() for x in (a, b))
    scale = float(torch.matmul(a64.abs(), b64.abs()).max())
    want = dd_matmul.dd_matmul_plain(a, b)
    before = dd_matmul.dd_matmul.launches
    got, again = dd_matmul.dd_matmul(a, b), dd_matmul.dd_matmul(a, b)
    torch.cuda.synchronize()
    assert dd_matmul.dd_matmul.launches == before + 2
    k, p = (x.hi.double() + x.lo.double() for x in (got, want))
    err = float((k - p).abs().max())
    assert err <= 1e-14 * scale, (label, plan.describe(), err)
    assert torch.equal(got.hi, again.hi) and torch.equal(got.lo, again.lo), label
    if label.startswith("63-wide"):
        assert plan.copy == (4, 4) and plan.zblocks < 900, plan.describe()
