"""K2 ``theta_chain`` and K4 ``cpoint_combine`` (CUDA C++; K4 on K21's row
body) against their plain PyTorch versions, their wrappers' cached checks
and packed arguments, and the step-size tables K2 reads.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k2_k4.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'``.

Both kernels round each operation of their plain versions once, in its
order (no FMA contraction), so on the card they equal the plain versions
bit for bit, in float64 and float32, NaN included; a second launch repeats
the first.  The plain versions are held against the JAX package in
``tests/test_torch_heat2d.py`` (``test_k2_plain_matches_relaxation_scan``,
``test_k4_plain_matches_cpoint_phases``).

The CPU tests: a CPU tensor goes to the plain version without a launch,
the cached checks raise the same errors on every call and hit the cache on
a repeat, the launch arguments are packed as the C launchers read them at
the TOMS shapes, and a spectral heat solve copies each step-size table to
the device once.
"""

import numpy as np
import pytest
import torch

import pymgrit_tpu_torch as P
from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, heat_kernels, indexed, launch_counts
from pymgrit_tpu_torch.ops.heat_kernels import fact

torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = dict(dtype=torch.float64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed, scale=1.0):
    a = np.random.default_rng(seed).uniform(-scale, scale, shape)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _cuda_facts(ops, index=0):
    """The facts of these tensors as if they lay on CUDA device ``index``."""
    dev = torch.device("cuda", index)
    return tuple((t.dtype, dev, t.shape, t.stride()) for t in ops)


# ---------------------------------------------------------------------------
# K2 theta_chain
# ---------------------------------------------------------------------------


def _k2_run(dtype, dev, J, L, N, mode, seed=0):
    """run(ops) -> the tube one K2 call writes into: J chains of L steps
    reading their seeds from a level tube's C-rows (stride m = L + 1 rows
    of N, N odd: every other row off 16-byte alignment) and writing its
    F-rows.  mode: 'BE' or 'CN'; '+g'; '+rows' (a tabulated rhs: one row a
    (step, chain), else one row at strides 0); '+dt' (step sizes that vary
    along each chain and between chains, else uniform)."""
    theta = 1.0 if mode.startswith("BE") else 0.5
    m = L + 1
    nt = J * m + 1
    u = _rand((nt, N), dtype, dev, seed + 1)
    g = _rand((nt, N), dtype, dev, seed + 2, 1e-3)[1:].view(J, m, N)[:, :L] if "+g" in mode else None
    lam = _rand((N,), dtype, dev, seed + 3).abs() * 1e3
    lift = _rand((N,), dtype, dev, seed + 4)
    if "+rows" in mode:
        rows = _rand((2, L, J, N), dtype, dev, seed + 5)
        r1, r0 = rows[0], rows[1]
    else:
        rows = _rand((2, N), dtype, dev, seed + 5)
        r1, r0 = rows[0].expand(L, J, N), rows[1].expand(L, J, N)
    if "+dt" in mode:
        dt = torch.as_tensor(np.random.default_rng(seed + 6).uniform(1e-4, 1e-2, (L, J)),
                             dtype=dtype, device=dev)
    else:
        dt = torch.full((L, J), 1.0 / 512, dtype=dtype, device=dev)

    def run(ops):
        tube = torch.full((nt, N), float("nan"), dtype=dtype, device=dev)
        ops.theta_chain(u[0:nt - 1:m], tube[1:].view(J, m, N)[:, :L], dt, lam, lift, r1, r0,
                        theta, g)
        return tube
    return run


# (J, L, N, mode): the TOMS level-1 F-relaxation at a narrow width, CN, the
# coarsest solve (J = 1, L = 2), a one-step Phi (L = 1, no g), long chains
# past the ring's depth (L = 37: 4 and 2 slots), tabulated rhs rows,
# step sizes that vary, N below one thread's vector and not a multiple of it
K2_CASES = (
    (32, 15, 1023, "BE+g"), (32, 15, 1023, "CN+g"), (1, 2, 1023, "BE+g"), (32, 1, 1023, "BE"),
    (3, 37, 515, "BE+g"), (3, 37, 515, "CN+g+rows"), (5, 7, 515, "BE+rows+dt"),
    (5, 7, 515, "CN+g+dt"), (2, 5, 1, "CN+g"), (7, 3, 3, "BE+g+dt"), (4, 6, 4097, "CN+rows"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J,L,N,mode", K2_CASES)
def test_k2_matches_plain_bit_for_bit_on_card(cuda, dtype, J, L, N, mode):
    run = _k2_run(dtype, cuda, J, L, N, mode)
    before = launch_counts()["theta_chain"]
    out_k = run(DISPATCH)
    torch.cuda.synchronize()
    assert launch_counts()["theta_chain"] == before + 1
    out_p = run(PLAIN)
    assert torch.equal(out_k[1:].view(J, L + 1, N)[:, :L], out_p[1:].view(J, L + 1, N)[:, :L])
    # the C-rows are not written
    assert bool(torch.isnan(out_k[0:J * (L + 1) + 1:L + 1]).all())
    assert torch.equal(run(DISPATCH).nan_to_num(), out_k.nan_to_num())


@pytest.mark.parametrize("J,L,N,mode", K2_CASES[:4])
def test_k2_cpu_takes_the_plain_version(J, L, N, mode):
    run = _k2_run(torch.float64, CPU, J, L, N, mode)
    before = launch_counts()["theta_chain"]
    assert torch.equal(run(DISPATCH).nan_to_num(), run(PLAIN).nan_to_num())
    assert launch_counts()["theta_chain"] == before


def _k2_args(**over):
    N = 20
    args = dict(x0=torch.zeros((3, N), **F64), out=torch.empty((3, 2, N), **F64),
                dt=torch.zeros((2, 3), **F64), lam=torch.zeros(N, **F64),
                lift=torch.zeros(N, **F64), rhs1=torch.zeros(N, **F64).expand(2, 3, N),
                rhs0=torch.zeros(N, **F64).expand(2, 3, N), theta=1.0)
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(dt=torch.zeros((3, 2), **F64)), "dt must be"),
    (dict(dt=torch.zeros((3, 2), **F64).t()), "dt must be"),
    (dict(lam=torch.zeros(21, **F64)), "lam and lift"),
    (dict(rhs0=torch.zeros((2, 3, 20), **F64)), "equal strides"),
    (dict(g=torch.zeros((3, 1, 20), **F64)), "g must have"),
    (dict(theta=0.0), "theta"),
    (dict(x0=torch.zeros((3, 20), dtype=torch.int64)), "dtype"),
    (dict(lift=torch.zeros(20, dtype=torch.float32)), "lift has dtype"),
    (dict(out=torch.empty((3, 20, 2), **F64).transpose(1, 2)), "contiguous"),
    (dict(out=torch.empty((2, 2, 20), **F64)), "out has shape"),
    (dict(lam=torch.zeros(20, **F64, device="meta")), "lam is on meta"),
])
def test_k2_cached_checks_raise_on_every_call(over, match):
    """The same error on every call with the same facts (the cache holds no
    failed check), and a good call between them still runs."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            heat_kernels.theta_chain(**_k2_args(**over))
        heat_kernels.theta_chain(**_k2_args())


def test_k2_repeat_call_hits_the_cache():
    args = _k2_args(dt=torch.full((2, 3), 0.1, **F64))
    heat_kernels.theta_chain(**args)
    before = heat_kernels._chain_checked.cache_info()
    out = heat_kernels.theta_chain(**args)
    after = heat_kernels._chain_checked.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)
    assert out is args["out"]


def test_k2_cpu_checks_carry_no_launch():
    a = _k2_args()
    ops = [a[k] for k in ("x0", "out", "dt", "lam", "lift", "rhs1", "rhs0")]
    assert heat_kernels._chain_checked(tuple(map(fact, ops)), 1.0) == (True, None)


def test_k2_plan_at_toms_shapes():
    # TOMS level-1 F-relaxation (J = 32, N = 127^2): 32 segments of 512
    # float64 a chain, 1024 items, one block each; float32 1024
    # coefficients a segment; the coarsest solve J = 1: 32 items
    assert heat_kernels.theta_chain_plan(32, 16129, 8) == (2, 32, 1024)
    assert heat_kernels.theta_chain_plan(32, 16129, 4) == (4, 16, 512)
    assert heat_kernels.theta_chain_plan(1, 16129, 8) == (2, 32, 32)
    assert heat_kernels.theta_chain_plan(3, 1, 8) == (2, 1, 3)


def test_k2_pack_layout():
    args = heat_kernels.theta_chain_pack(1, (16, 2, 3, 4, 5, 6, 7), 32, 15, 16129, True, False,
                                         True, (2, 32, 1024))
    assert list(args) == [1] + [0] * 8 + [16, 2, 3, 4, 5, 6, 7, 32, 15, 16129, 32, 1024, 1, 0, 1,
                                          2]


@pytest.mark.parametrize("J,L,theta,with_g,tab", [(32, 15, 1.0, True, False),
                                                  (32, 15, 0.5, True, False),
                                                  (1, 2, 1.0, True, False),
                                                  (32, 1, 1.0, False, False),
                                                  (4, 3, 0.5, False, True)])
def test_k2_launch_the_checks_would_make(monkeypatch, J, L, theta, with_g, tab):
    """A CUDA-free look at the launch the cached checks build for a CUDA
    call on the TOMS level tube (N = 127^2): the seeds at the C-rows, the
    F-rows of each interval written, g the same rows of another tube, the
    rhs one row at strides 0 (or rows a (step, chain)); strides in the
    launcher's order, the plan, the variant flags."""
    monkeypatch.setattr(heat_kernels, "_launcher", lambda name, dt: (name, dt))
    heat_kernels._chain_checked.cache_clear()
    try:
        N, m = 16129, L + 1
        nt = J * m + 1
        tube = torch.empty((nt, N), **F64)      # never written: facts only
        x0, out = tube[0:nt - 1:m], tube[1:].view(J, m, N)[:, :L]
        g = torch.empty((nt, N), **F64)[1:].view(J, m, N)[:, :L]
        rhs = torch.empty((L, J, N), **F64) if tab else torch.empty(N, **F64).expand(L, J, N)
        ops = (x0, out, torch.empty((L, J), **F64), torch.empty(N, **F64),
               torch.empty(N, **F64), rhs, rhs) + ((g,) if with_g else ())
        on_cpu, (args, fn, index) = heat_kernels._chain_checked(_cuda_facts(ops, 2), theta)
        assert not on_cpu and fn == ("pm_theta_chain", torch.float64) and index == 2
        assert args[0] == 2 and list(args[1:9]) == [0] * 8
        r = (J * N, N) if tab else (0, 0)
        assert list(args[9:16]) == [m * N, m * N, N, m * N if with_g else 0, N if with_g else 0,
                                    r[0] if L > 1 else 0, r[1] if J > 1 else 0]
        assert list(args[16:]) == [J, L, N, *heat_kernels.theta_chain_plan(J, N, 8)[1:],
                                   int(theta != 1.0), int(with_g), int(tab), 2]
    finally:
        heat_kernels._chain_checked.cache_clear()


# ---------------------------------------------------------------------------
# The step-size tables K2 reads: made once a distinct table
# ---------------------------------------------------------------------------


def _spy_ops(seen):
    """DISPATCH with K2 recording the dt tensor of each call."""
    def theta_chain(x0, out, dt, *rest, **kw):
        seen.append(dt)
        return DISPATCH.theta_chain(x0, out, dt, *rest, **kw)
    return DISPATCH._replace(theta_chain=theta_chain)


def _tables_made_once(seen):
    """Each distinct dt table (by value) reached K2 as one tensor object."""
    by_value = {}
    for dt in seen:
        by_value.setdefault((tuple(dt.shape), dt.numpy().tobytes()), set()).add(id(dt))
    return all(len(ids) == 1 for ids in by_value.values()), len(by_value)


def test_heat2d_spectral_solve_makes_each_dt_table_once():
    seen = []
    ops = _spy_ops(seen)
    problem = [P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=9, ny=9, a=1.0,
                        rhs=lambda x, y, t: np.sin(np.pi * x) * np.sin(np.pi * y) + 0 * t,
                        init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                        t_start=0, t_stop=1, nt=nt, basis="spectral", device="cpu", ops=ops)
               for nt in (65, 17, 5)]
    P.Mgrit(problem=problem, tol=1e-300, max_iter=3, logging_lvl=40).solve()
    once, tables = _tables_made_once(seen)
    assert once and len(seen) > 2 * tables, (len(seen), tables)
    first = {id(dt) for dt in seen}
    seen.clear()
    P.Mgrit(problem=problem, tol=1e-300, max_iter=2, logging_lvl=40).solve_compiled()
    # a second solve on the same levels reads the tables the first made
    assert {id(dt) for dt in seen} <= first


def test_heat1d_spectral_solve_makes_each_dt_table_once():
    seen = []
    ops = _spy_ops(seen)
    problem = [P.Heat1D(x_start=0, x_end=2, nx=17, a=1.0,
                        init_cond=lambda x: 2 * np.sin(np.pi * x),
                        rhs=lambda x, t: -np.sin(np.pi * x) * (np.sin(t) - np.cos(t)),
                        t_start=0, t_stop=1, nt=nt, basis="spectral", device="cpu", ops=ops)
               for nt in (33, 9, 3)]
    P.Mgrit(problem=problem, tol=1e-300, max_iter=3, logging_lvl=40).solve()
    once, tables = _tables_made_once(seen)
    assert once and len(seen) > 2 * tables, (len(seen), tables)


# ---------------------------------------------------------------------------
# K4 cpoint_combine
# ---------------------------------------------------------------------------


def _k4_run(dtype, dev, R, N, mode, nt=3, seed=0):
    """run(ops) -> the tube one K4 call writes into.  mode: 'fresh' (out a
    fresh (R, N) tensor), 'inplace' (out is term 0, the C-rows of a tube),
    'interleaved' (out the C-rows of a tube, term 0 its F-rows), with
    '+nan' (NaN in a term)."""
    m = 4
    tube = _rand((R * m + 1, N), dtype, dev, seed + 1)
    if "+nan" in mode:       # in a row the call reads: term 0's first row
        tube[m if "inplace" in mode else m - 1, N // 2] = float("nan")
    others = [_rand((2 * R, N), dtype, dev, seed + 2 + k)[1::2] for k in range(nt)]
    coeffs = [1.0, -1.0, 1.0][:nt] if "weighted" not in mode else [1.3, -0.3, 0.25][:nt]

    def run(ops):
        t = tube.clone()
        if "inplace" in mode:
            out = t[m::m]
            terms = [out] + others[1:]
        elif "interleaved" in mode:
            out = t[m::m]
            terms = [t[m - 1:-1:m]] + others[1:]
        else:
            out = torch.full((R, N), float("nan"), dtype=dtype, device=dev)
            terms = others
            t = out
        ops.cpoint_combine(out, terms, coeffs)
        return t
    return run


K4_CASES = [(R, N, mode, nt) for R, N in ((512, 1023), (33, 4225), (5, 3), (7, 1))
            for mode, nt in (("fresh", 1), ("fresh weighted", 2), ("fresh", 3),
                             ("inplace", 2), ("inplace weighted", 3), ("interleaved", 2),
                             ("interleaved +nan", 3))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("R,N,mode,nt", K4_CASES)
def test_k4_matches_plain_bit_for_bit_on_card(cuda, dtype, R, N, mode, nt):
    run = _k4_run(dtype, cuda, R, N, mode, nt)
    before = launch_counts()["cpoint_combine"]
    out_k = run(DISPATCH)
    torch.cuda.synchronize()
    assert launch_counts()["cpoint_combine"] == before + 1
    out_p = run(PLAIN)
    same = torch.equal(out_k.nan_to_num(7.0), out_p.nan_to_num(7.0))
    assert same and torch.equal(torch.isnan(out_k), torch.isnan(out_p))
    if "+nan" in mode:       # the NaN reached out's first row
        assert bool(torch.isnan((out_k[4] if out_k.shape[0] > R else out_k[0])[N // 2]))
    assert torch.equal(run(DISPATCH).nan_to_num(7.0), out_k.nan_to_num(7.0))


@pytest.mark.parametrize("R,N,mode,nt", [c for c in K4_CASES if c[0] == 33])
def test_k4_cpu_matches_plain(R, N, mode, nt):
    """On the CPU the wrapper is the plain version (1-3 terms, in place, on
    interleaved C/F rows of one tube), and counts no launch."""
    run = _k4_run(torch.float64, CPU, R, N, mode, nt)
    before = launch_counts()["cpoint_combine"]
    out_w, out_p = run(DISPATCH), run(PLAIN)
    assert torch.equal(out_w.nan_to_num(7.0), out_p.nan_to_num(7.0))
    assert launch_counts()["cpoint_combine"] == before


def test_k4_in_place_is_the_sum():
    tube = torch.arange(9 * 5, **F64).view(9, 5)
    want = tube[2:9:2] + 2.0 * tube[1:9:2]
    indexed.cpoint_combine(tube[2:9:2], [tube[2:9:2], tube[1:9:2]], [1.0, 2.0])
    assert torch.equal(tube[2:9:2], want)


@pytest.mark.parametrize("make,match", [
    (lambda a, t: (a, [a] * 4, [1.0] * 4), "1..3 terms"),
    (lambda a, t: (a, [], []), "1..3 terms"),
    (lambda a, t: (a, [a, a], [1.0]), "1..3 terms"),
    (lambda a, t: (t[1:5], [t[0:4]], [1.0]), "overlaps term0"),
    (lambda a, t: (t[0:4], [a, t[0:8:2]], [1.0, 1.0]), "overlaps term1"),
    (lambda a, t: (a, [a.float()], [1.0]), "dtype"),
    (lambda a, t: (a, [a[:3]], [1.0]), "one shape"),
    (lambda a, t: (a, [torch.zeros((4, 5, 2), **F64)[..., 0]], [1.0]), "contiguous"),
    (lambda a, t: (a.view(4, 5, 1), [a.view(4, 5, 1)], [1.0]), "one shape"),
    (lambda a, t: (a, [torch.zeros((4, 5), **F64, device="meta")], [1.0]), "is on meta"),
])
def test_k4_cached_checks_raise_on_every_call(make, match):
    a, t = torch.zeros((4, 5), **F64), torch.zeros((9, 5), **F64)
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            indexed.cpoint_combine(*make(a, t))
        indexed.cpoint_combine(a, [torch.ones((4, 5), **F64)], [2.0])
    assert bool((a == 2.0).all())


def test_k4_interleaved_rows_do_not_overlap():
    # C- and F-rows of one tube: rows m::m and m-1::m, any m >= 2
    for m in (2, 4):
        tube = torch.arange(17 * 3, **F64).view(17, 3)
        want = tube[m - 1:-1:m].clone()
        indexed.cpoint_combine(tube[m::m], [tube[m - 1:-1:m]], [1.0])
        assert torch.equal(tube[m::m], want)


def test_k4_repeat_call_hits_the_cache():
    a, b = torch.zeros((4, 5), **F64), torch.ones((4, 5), **F64)
    indexed.cpoint_combine(a, [a, b], [1.0, 1.0])
    before = indexed._combine_checked.cache_info()
    indexed.cpoint_combine(a, [a, b], [1.0, 1.0])
    after = indexed._combine_checked.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)
    assert bool((a == 2.0).all())


def test_k4_launch_the_checks_would_make(monkeypatch):
    """A CUDA-free look at the launch the cached checks build for the FAS
    g_tail of the TOMS level 0 (512 C-rows of 127^2, three terms, rows of
    the condensed tube): K21's plan and argument array with no index
    (io and every idx 0), out's and each term's row strides, T = R."""
    monkeypatch.setattr(indexed, "_launcher", lambda name, dt: (name, dt))
    monkeypatch.setattr(indexed._build, "sm_count", lambda index: 132)
    indexed._combine_checked.cache_clear()
    try:
        R, N = 512, 16129
        tube = torch.empty((2 * R + 1, N), **F64)      # facts only
        ops = (torch.empty((R, N), **F64), tube[1::2], tube[0:-1:2], tube[2::2])
        on_cpu, (args, fn, index) = indexed._combine_checked(_cuda_facts(ops, 1))
        assert not on_cpu and fn == ("pm_cpoint_combine", torch.float64) and index == 1
        plan = indexed.plan(R, N, 8, 3, 132, indexed.K4_BLOCKS_PER_SM[3])
        assert plan == (2, 127, 396)
        assert list(args) == list(indexed.pack(1, (0,) * 4, 0, (0,) * 3, (N, 2 * N, 2 * N, 2 * N),
                                               R, R, N, 3, plan))
        assert list(args[1:9]) == [0] * 8 and list(args[13:]) == [R, R, N, 127, 3, 2, 396]
    finally:
        indexed._combine_checked.cache_clear()


def test_k4_contiguous_rows_launch_as_one_row(monkeypatch):
    """Where out and every term are contiguous blocks of rows (the FAS
    right-hand side of the condensed level 0: fresh tensors and rows 1..nc-1
    of the next level's tubes), the launch sees one row of R N elements."""
    monkeypatch.setattr(indexed, "_launcher", lambda name, dt: (name, dt))
    monkeypatch.setattr(indexed._build, "sm_count", lambda index: 132)
    indexed._combine_checked.cache_clear()
    try:
        R, N = 512, 16129
        tube = torch.empty((R + 1, N), **F64)
        ops = (torch.empty((R, N), **F64), tube[1:], tube[:R])
        _, (args, _, _) = indexed._combine_checked(_cuda_facts(ops))
        assert list(args[9:12]) == [N, N, N]
        plan = indexed.plan(1, R * N, 8, 2, 132, indexed.K4_BLOCKS_PER_SM[2])
        assert list(args[13:]) == [1, 1, R * N, plan[1], 2, 2, plan[2]]
    finally:
        indexed._combine_checked.cache_clear()


def test_k4_cpu_checks_carry_no_launch():
    a = torch.zeros((4, 5), **F64)
    assert indexed._combine_checked((fact(a), fact(a))) == (True, None)
