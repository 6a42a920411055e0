"""The port's kernels against their plain PyTorch versions, and the checks
their wrappers make.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc`` and
``triton``; they skip without one.  Run them on the card with

    python -m pytest tests/test_torch_kernels.py -q -m cuda

Tolerance on the card: normwise, max|kernel - plain| <= RTOL * max|plain|
with RTOL = 1e-13 (float64) and 1e-5 (float32).  The kernels contract
a*b + c into FMAs and K3 sums in another order, so they agree with the plain
versions to rounding (a few ulp per operation, at most L sequential steps).

The remaining tests run on the CPU: a CPU tensor goes to the plain version
without counting a launch, and every wrapper raises on operands its kernel
does not take.
"""

import numpy as np
import pytest
import torch

import pymgrit_tpu_torch as P
from pymgrit_tpu_torch.ops import (DISPATCH, PLAIN, _build, heat_kernels, launch_counts,
                                   reset_launch_counts, triton_kernels)

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
N = 15 * 15


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _agree(k, p, dtype):
    err = float((k - p).abs().max())
    assert err <= RTOL[dtype] * float(p.abs().max()), err


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

    return [("interval_affine", k1_rows), ("interval_affine", k1_tube),
            ("theta_chain", k2(1.0, True, False)), ("theta_chain", k2(0.5, True, True)),
            ("theta_chain", k2(1.0, False, True)), ("residual_row_norms", k3),
            ("cpoint_combine", k4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_on_card(cuda, dtype):
    for name, run in _cases(dtype, cuda):
        before = launch_counts()[name]
        out_k = run(DISPATCH)
        torch.cuda.synchronize()
        assert launch_counts()[name] == before + 1
        _agree(out_k, run(PLAIN), dtype)


@pytest.mark.cuda
def test_small_solve_on_card_matches_cpu(cuda):
    histories, tubes = [], []
    for device in ("cpu", cuda):
        t = np.linspace(0, 1, 129)
        problem = [P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=17, ny=17, a=1.0,
                            rhs=lambda x, y, t: np.sin(np.pi * x) * np.sin(np.pi * y) + 0 * t,
                            init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                            t_interval=t[::s], basis="spectral", device=device)
                   for s in (1, 4, 16)]
        reset_launch_counts()
        mgrit = P.Mgrit(problem=problem, tol=1e-10, max_iter=5, logging_lvl=40)
        histories.append(mgrit.solve_compiled()["conv"])
        tubes.append(mgrit.u[0].cpu())
        assert all(n > 0 for n in launch_counts().values()) == (device != "cpu")
    np.testing.assert_allclose(histories[1], histories[0], rtol=1e-10, atol=1e-14)
    assert float((tubes[1] - tubes[0]).abs().max()) <= 1e-10


# ---------------------------------------------------------------------------
# CPU: routing and the wrappers' checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(7))
def test_cpu_tensors_take_the_plain_version(case):
    name, run = _cases(torch.float64, torch.device("cpu"))[case]
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


def test_triton_wrappers_reject():
    a = torch.zeros((4, N), dtype=torch.float64)
    with pytest.raises(ValueError, match="must be equal"):
        triton_kernels.residual_row_norms(a, a[:3])
    with pytest.raises(ValueError, match="1..4 terms"):
        triton_kernels.cpoint_combine(a, [a] * 5, [1.0] * 5)
    with pytest.raises(ValueError, match="overlaps"):
        tube = torch.zeros((9, N), dtype=torch.float64)
        triton_kernels.cpoint_combine(tube[1:5], [tube[0:4]], [1.0])
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.zeros((4, N), device="meta")
        triton_kernels.residual_row_norms(m, m)
    # interleaved C- and F-rows of one tube do not overlap
    tube = torch.arange(9 * N, dtype=torch.float64).view(9, N)
    triton_kernels.cpoint_combine(tube[2:9:2], [tube[1:9:2]], [1.0])
    np.testing.assert_array_equal(tube[2:9:2].numpy(), tube[1:9:2].numpy())


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
