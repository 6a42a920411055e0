"""Cases of the sharded-executor tests and the gloo worlds that run them.

Not a test module (pytest collects ``test_*.py`` only).  It imports torch,
numpy and the port alone: ``torch.multiprocessing``'s spawn imports it again
in every child, and a child must not import jax.

A case is plain data (picklable): a problem builder and its arguments, the
solver (``ShardedMgrit`` / ``ShardedAtMgrit`` or one of the subclasses
below) with its arguments, the entry point (``solve`` or
``solve_compiled``) and the mesh: ``P`` time shards and ``S`` space shards
(1 where absent).  ``run_case`` runs a case with
either package: the builders take the package (``mod``) and a ``Side``
(the array module of its callables), so the JAX side (in the pytest
process) and the port's worlds build the same problem.

``start_world(size, cases, directory)`` spawns ``size`` processes in a gloo
world (or ``backend="nccl"``) with a file rendezvous in ``directory`` (60 s
timeout), each running
every case whose mesh it belongs to (a (P, S) case runs on ranks
0..P*S-1, cell (t, s) on rank t * S + s), in order, and writing each rank's
result as a pickle.  ``World.result(name)`` waits for a case's pickles, and fails at
once if a worker raised or died, or at the world's deadline (120 s after
its start unless the file gives another).
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import pickle
import time
import traceback
from typing import Callable

import numpy as np
import torch

JOIN_SECONDS = 120
INIT_TIMEOUT = datetime.timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class Side:
    """A package's array functions for the builders' callables: ``np`` for
    rhs and initial conditions, ``arr`` to make a float64 state leaf,
    ``sum`` over a leaf, ``maximum`` of two, ``kw`` for a model's
    constructor."""

    np: object
    arr: Callable
    sum: Callable
    maximum: Callable
    kw: dict


PORT = Side(np=np, arr=lambda a: torch.tensor(a, dtype=torch.float64), sum=torch.sum,
            maximum=torch.maximum, kw={"device": "cpu"})


# ---------------------------------------------------------------------------
# problem builders: (mod, side, **kw) -> (problem, transfer or None)
# ---------------------------------------------------------------------------

def dahlquist(mod, side, nts, t_stop=5.0, **kw):
    return [mod.Dahlquist(t_start=0, t_stop=t_stop, nt=nt, **kw, **side.kw) for nt in nts], None


def dahlquist_grid(mod, side, grids, **kw):
    return [mod.Dahlquist(t_interval=np.asarray(g, dtype=np.float64).copy(), **kw, **side.kw)
            for g in grids], None


def heat2d(mod, side, nts, nx=10, ny=12, t_stop=1.0, **kw):
    """Heat2D on the unit square with rhs sin(pi x) sin(pi y) and the same
    initial condition (JAX's ``test_shard_features.py``), over [0, t_stop]."""
    xp = side.np

    def rhs(x, y, t):
        return xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.ones_like(t * x * y)

    def ic(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    t = np.linspace(0, t_stop, nts[0])
    problem = []
    for nt in nts:
        stride = (nts[0] - 1) // (nt - 1)
        problem.append(mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=ny, a=1.0,
                                  rhs=rhs, init_cond=ic, t_interval=t[::stride], **kw,
                                  **side.kw))
    return problem, None


def heat2d_serial(mod, side, nt=65, m=4):
    """JAX's ``test_shard_solver.py::test_heat2d_matches_serial``: 17 x 19,
    rhs 5 x (1 - x) y (1 - y)."""
    xp = side.np

    def rhs(x, y, t):
        return 5 * x * (1 - x) * y * (1 - y) + 0 * t * xp.ones_like(x * y)

    h0 = mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=17, ny=19, a=1.0, rhs=rhs,
                    t_start=0, t_stop=1, nt=nt, **side.kw)
    h1 = mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=17, ny=19, a=1.0, rhs=rhs,
                    t_interval=h0.t[::m], **side.kw)
    return [h0, h1], None


def heat1d(mod, side, grids, nxs, x_end=2.0, spatial=False):
    """Heat1D with rhs -sin(pi x)(sin t - pi^2 cos t), u0 = sin(pi x), one
    level a grid; ``spatial``: GridTransferHeat between the first levels."""
    xp = side.np

    def rhs(x, t):
        return -xp.sin(xp.pi * x) * (xp.sin(t) - xp.pi ** 2 * xp.cos(t))

    problem = [mod.Heat1D(x_start=0, x_end=x_end, nx=nx, a=1, rhs=rhs,
                          init_cond=lambda x: np.sin(np.pi * x),
                          t_interval=np.asarray(g, dtype=np.float64).copy(), **side.kw)
               for g, nx in zip(grids, nxs)]
    transfer = None
    if spatial:
        transfer = [mod.GridTransferHeat()] + [mod.GridTransferCopy()
                                              for _ in range(len(grids) - 2)]
    return problem, transfer


def two_leaf(mod, side, kind="dict", nts=(33, 9), norm=False):
    """A two-leaf backward-Euler state (``tests/test_torch_pytree_states.py``'s
    application): a (3,) leaf decaying at rates 1..3 and a (2,) leaf forced
    by its sum and by t, as a dict (keys out of order) or a tuple;
    ``norm``: a ``state_norm`` hook (the largest |x| of the leaves)."""
    lam, mu = side.arr(np.linspace(1.0, 3.0, 3)), side.arr([0.5, 4.0])
    a0, b0 = np.linspace(1.0, -0.25, 3), np.array([0.3, -1.0])

    def pack(a, b):
        return (a, b) if kind == "tuple" else {"vel": b, "pos": a}

    def unpack(u):
        return u if kind == "tuple" else (u["pos"], u["vel"])

    class TwoLeaf(mod.Application):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.vector_template = pack(side.arr(0 * a0), side.arr(0 * b0))
            self.vector_t_start = pack(side.arr(a0), side.arr(b0))
            if norm:
                self.state_norm = self._max_norm

        def step(self, u, t_start, t_stop):
            a, b = unpack(u)
            dt = t_stop - t_start
            a1 = a / (1 + dt * lam)
            b1 = (b + dt * (0.5 * side.sum(a1) + t_stop)) / (1 + dt * mu)
            return pack(a1, b1)

        @staticmethod
        def _max_norm(u):
            a, b = unpack(u)
            return side.maximum(abs(a).max(), abs(b).max())

    t = np.linspace(0, 1, nts[0])
    return [TwoLeaf(t_interval=t[::(nts[0] - 1) // (nt - 1)]) for nt in nts], None


def bdf(mod, side, nts, nx=17, t_stop=2.0):
    """The BDF pair-state heat models (``tests/test_torch_heat1d_2pts.py``'s
    hierarchy): Heat1DBDF2 on level 0, Heat1DBDF1 on the levels below, on
    levels nts over [0, t_stop]."""
    xp = side.np

    def rhs(x, t):
        return -xp.sin(xp.pi * x) * (xp.sin(t) - xp.pi ** 2 * xp.cos(t))

    t = np.linspace(0, t_stop, nts[0])
    kw = dict(x_start=0, x_end=1, nx=nx, a=1, dtau=(t[1] - t[0]) / 2, rhs=rhs,
              init_cond=lambda x: np.sin(np.pi * x), **side.kw)
    return [(mod.Heat1DBDF2 if lvl == 0 else mod.Heat1DBDF1)(
        t_interval=t[::(nts[0] - 1) // (nt - 1)], **kw) for lvl, nt in enumerate(nts)], None


def zoo(mod, side, model, nts, t_stop, module=None, **kw):
    """A model of the zoo by class name (from its submodule ``module`` of
    the package where the package does not export it at its top) on
    levels nts over [0, t_stop], with the constructor's kw."""
    cls = getattr(mod, model, None)
    if cls is None:
        cls = getattr(importlib.import_module(f"{mod.__name__}.models.{module}"), model)
    t = np.linspace(0, t_stop, nts[0])
    return [cls(t_interval=t[::(nts[0] - 1) // (nt - 1)], **kw, **side.kw) for nt in nts], None


PERIODIC_T_STOP = {"AllenCahn": 0.024, "GrayScott2D": 8.0, "Burgers2D": 0.5}


def periodic(mod, side, model, nts, nx=16, t_stop=None, **kw):
    """One of the periodic Newton-Krylov models (``model``: AllenCahn,
    GrayScott2D or Burgers2D) at width nx on levels nts, over t_stop or the
    horizon chip_smoke runs it on (Allen-Cahn's IMPL/CN example, the
    Gray-Scott demo's, Burgers2D's with nu = 0.05 unless kw sets it)."""
    if model == "Burgers2D":
        kw.setdefault("nu", 0.05)
    t = np.linspace(0, PERIODIC_T_STOP[model] if t_stop is None else t_stop, nts[0])
    cls = getattr(mod, model, None)
    if cls is None:         # the JAX package exports Allen-Cahn alone at its top
        module = "gray_scott_2d" if model == "GrayScott2D" else "burgers"
        cls = getattr(importlib.import_module(f"{mod.__name__}.models.{module}"), model)
    return [cls(nx=nx, t_interval=t[::(nts[0] - 1) // (nt - 1)], **kw, **side.kw)
            for nt in nts], None


BUILDERS = {f.__name__: f for f in (dahlquist, dahlquist_grid, heat2d, heat2d_serial, heat1d,
                                    two_leaf, periodic, bdf, zoo)}


# ---------------------------------------------------------------------------
# solvers: subclasses of either package's ShardedMgrit
# ---------------------------------------------------------------------------

def rel_jump(base):
    """JAX's ``test_custom_convergence_criterion_subclass``: the built-in
    residual scaled by 1e4, each raw value kept."""

    class RelJump(base):
        def convergence_criterion(self, iteration):
            super().convergence_criterion(iteration)
            self._history = getattr(self, "_history", [])
            self._history.append(self.conv[iteration])
            self.conv[iteration] = self.conv[iteration] / 1e-4

    return RelJump


def max_jump(base):
    """A compiled criterion: the largest C-point change since the previous
    iteration (a per-rank max, then a max over ranks), the C-points carried
    in the aux, split over the ranks ("time").  (The JAX package's twin is
    ``torch_shard_jax.jax_max_jump``.)"""

    class MaxJump(base):
        def compiled_convergence_criterion(self, state, aux):
            c = state[0]["blocks"][:, 0]
            jump = self.comm.all_reduce((c - aux["c"]).abs().max(), "max")
            return jump, jump < self.tol, {"c": c.clone(), "n": aux["n"] + 1}

        def compiled_conv_aux_init(self):
            b = self.state[0]["blocks"]
            return {"c": torch.zeros((self.J_pad[0],) + tuple(b.shape[2:]), dtype=b.dtype,
                                     device=b.device),
                    "n": torch.zeros((), dtype=torch.float64, device=self.device)}

        def compiled_conv_aux_specs(self, aux0):
            return {"c": "time", "n": None}

    return MaxJump


SUBCLASSES = {"rel_jump": rel_jump, "max_jump": max_jump}


def solver_class(mod_parallel, kind, subclasses=SUBCLASSES):
    """(kind, subclass or None) -> the class."""
    name, sub = kind if isinstance(kind, tuple) else (kind, None)
    base = getattr(mod_parallel, name)
    return subclasses[sub](base) if sub else base


# ---------------------------------------------------------------------------
# running a case
# ---------------------------------------------------------------------------

def run_case(mod, side, mod_parallel, case, mesh, value, subclasses=SUBCLASSES, prepare=None):
    """Build the case's problem with ``mod``, run its sharded solver on
    ``mesh`` and return {conv, solve_iter, tube (numpy leaves), ...}.
    ``value`` turns a fine solution into a list of float64 numpy leaves;
    ``subclasses`` holds the package's criterion subclasses by name;
    ``prepare(problem)``, where given, returns a dict of counts that the
    result carries as ``calls_by_op``."""
    problem, transfer = BUILDERS[case["build"]](mod, side, **case.get("build_kw", {}))
    counted = prepare(problem) if prepare is not None else None
    kw = dict(case.get("solver_kw", {}), logging_lvl=30)
    calls, shapes = [], []
    if case.get("output_lvl") is not None:
        def hook(solver):
            leaves = value(solver.u[0])
            calls.append((solver.solve_iter, leaves[0].shape[0], len(solver.t[0])))
            shapes.append(leaves[0].shape)
        kw.update(output_fcn=hook, output_lvl=case["output_lvl"])
    if transfer is not None:
        kw["transfer"] = transfer
    cls = solver_class(mod_parallel, case.get("solver", "ShardedMgrit"), subclasses)
    args = (case["k"],) if "k" in case else ()
    solver = cls(*args, problem=problem, mesh=mesh, **kw)
    setup_calls = len(calls)
    info = getattr(solver, case.get("entry", "solve"))()
    out = {"conv": np.asarray(solver.conv, dtype=np.float64), "solve_iter": solver.solve_iter,
           "returned": np.asarray(info["conv"], dtype=np.float64),
           "tube": value(solver.fine_solution()), "calls": calls, "shapes": shapes,
           "setup_calls": setup_calls,
           "general": bool(solver._general), "cpts": np.asarray(solver.levels[0].cpts)}
    if counted is not None:
        out["calls_by_op"] = dict(counted)
    if hasattr(solver, "_history"):
        out["history"] = np.asarray(solver._history, dtype=np.float64)
    if hasattr(solver, "comm"):
        out["comm"] = dict(solver.comm.counts)
    if getattr(solver, "space_comm", None) is not None:
        out["space_comm"] = dict(solver.space_comm.counts)
    if all(hasattr(p, "stats") for p in problem):
        out["stats"] = [dict(p.stats) for p in problem]
    if getattr(solver, "_compiled_conv_aux", None) is not None and case.get("aux"):
        out["aux"] = value(solver._compiled_conv_aux["c"])
    return out


def _error(fn):
    """(type name, message) of what fn raises, or None."""
    try:
        fn()
    except Exception as e:              # the JAX package raises a bare Exception
        return type(e).__name__, str(e)
    return None


def mesh_errors(mesh):
    """The mesh factory's refusal and a (2, 2) mesh's shape; then on that
    mesh: a width n_space does not divide raises; an application without a
    space axis (Dahlquist, run replicated), Heat2D FE and spectral DD
    construct; physical DD, spatial coarsening and a host-coupled
    application raise."""
    import pymgrit_tpu_torch as P
    import pymgrit_tpu_torch.parallel as PP
    out = {"too_big": _error(lambda: PP.make_time_space_mesh(n_time=64, n_space=4))}
    grid = PP.make_time_space_mesh(n_time=2, n_space=2)
    out["space"] = grid.shape

    def solver(build, transfer=None, **kw):
        problem, _ = BUILDERS[build](P, PORT, **kw)
        return PP.ShardedMgrit(problem=problem, mesh=grid, transfer=transfer, logging_lvl=30)

    def callback():
        from pymgrit_tpu_torch.coupling import CallbackApplication
        t = np.linspace(0, 1, 17)
        zero = np.zeros(3)
        return [CallbackApplication(lambda u, t0, t1: u, zero, zero, t_interval=t[::m],
                                    **PORT.kw) for m in (1, 4)]

    out["indivisible"] = _error(lambda: solver("heat2d", nts=(17, 5), nx=9))
    out["replicated"] = _error(lambda: solver("dahlquist", nts=(17, 5)))
    out["fe"] = _error(lambda: solver("heat2d", nts=(17, 5), method="FE", t_stop=1e-3))
    out["dd_spectral"] = _error(lambda: solver("heat2d", nts=(17, 5), basis="spectral",
                                               precision="dd"))
    out["dd_physical"] = _error(lambda: solver("heat2d", nts=(17, 5), precision="dd"))
    out["spatial"] = _error(lambda: solver("heat2d", nts=(17, 5),
                                           transfer=[P.GridTransferHeat2D(9, 9)]))
    out["host"] = _error(lambda: PP.ShardedMgrit(problem=callback(), mesh=grid, logging_lvl=30))
    out["shape"] = mesh.shape
    return out


def comm_ops(mesh, device="cpu"):
    """Each of the four operations on tensors on ``device``, and the counts."""
    from pymgrit_tpu_torch.parallel.comm import Comm
    c = Comm(mesh.group, device)
    r = float(mesh.rank)
    x = torch.full((3, 2), r, dtype=torch.float64, device=device)
    b = torch.full((2,), r, device=device)
    out = {"shift": c.shift(x).cpu().numpy(),
           "broadcast": c.broadcast(b, mesh.size - 1).cpu().numpy(),
           "sum": c.all_reduce(torch.tensor(r + 1.0, dtype=torch.float64, device=device)).item(),
           "max": c.all_reduce(torch.tensor(r, dtype=torch.float64, device=device), "max").item(),
           "gather": c.all_gather(x[:1]).cpu().numpy()}
    out["counts"] = dict(c.counts)
    out["backend"], out["staged"] = c.backend, c.staged
    return out


def space_comm_ops(mesh):
    """The space group's all_to_all (uneven splits) and row halo, their
    counts, and the time group's size beside it."""
    from pymgrit_tpu_torch.parallel.comm import Comm
    c = Comm(mesh.space_group, "cpu")
    s, n = mesh.space_rank, mesh.n_space
    # rank s sends q + 1 values of 10 s + q to each rank q
    x = torch.cat([torch.full((q + 1,), 10.0 * s + q, dtype=torch.float64) for q in range(n)])
    got = c.all_to_all(x, [q + 1 for q in range(n)], [s + 1] * n)
    first = torch.full((2, 3), 100.0 + s, dtype=torch.float64)
    above, below = c.row_halo(first, first + 0.5)
    return {"a2a": got.numpy(), "above": above.numpy(), "below": below.numpy(),
            "counts": dict(c.counts), "time": mesh.size}


def pencil(mesh):
    """The physical Heat2D step (BE and CN, with g, and a ring off the
    Dirichlet data) and closed form (CN's a chunk of one interval at a
    time) of this rank's space slab, and of the whole states on the same
    rank (``Heat2D`` as it is built): this rank's rows of both, per
    method."""
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.models import heat_2d
    from pymgrit_tpu_torch.parallel.comm import Comm
    comm = Comm(mesh.space_group, "cpu")
    rng = np.random.default_rng(11)
    chunk = heat_2d._RELAX_CHUNK
    J, L, m = 3, 2, 5
    t = np.linspace(0.0, 0.1, J * (m - 1) + 1)
    tp = t[:-1][:J * L].reshape(J, L).T.copy()
    tc = t[1:][:J * L].reshape(J, L).T.copy()
    out = {}
    for method in ("BE", "CN"):
        (whole,), _ = heat2d(P, PORT, nts=(33,), method=method)
        (slab,), _ = heat2d(P, PORT, nts=(33,), method=method)
        slab._space_slab(mesh.space_rank, mesh.n_space, comm)
        R = slab.vector_template.shape[0]
        rows = slice(mesh.space_rank * R, (mesh.space_rank + 1) * R)
        x = torch.as_tensor(rng.uniform(-1, 1, (J, whole.nx, whole.ny)))
        g = torch.as_tensor(rng.uniform(-1, 1, (J, L, whole.nx, whole.ny)))
        ow = whole.step_chain(x, tp, tc, torch.empty_like(g), g)
        os_ = slab.step_chain(x[:, rows].clone(), tp, tc, torch.empty_like(g[:, :, rows]),
                              g[:, :, rows].clone())
        t0 = np.tile(t[:m - 1][:, None], (1, J))
        t1 = np.tile(t[1:m][:, None], (1, J))
        shape = (J, m - 1) + tuple(x.shape[1:])
        rw = whole.relax_interval(x, t0, t1, out=torch.empty(shape, dtype=torch.float64))
        # CN's closed form a interval at a time (its chunks), BE's at once
        heat_2d._RELAX_CHUNK = 1 if method == "CN" else chunk
        try:
            rs = slab.relax_interval(x[:, rows].clone(), t0, t1,
                                     out=torch.empty((J, m - 1, R, whole.ny), dtype=torch.float64))
        finally:
            heat_2d._RELAX_CHUNK = chunk
        out[method] = {"step": (os_.numpy(), ow[:, :, rows].numpy()),
                       "relax": (rs.numpy(), rw[:, :, rows].numpy())}
    return out


def periodic_halo(mesh):
    """The space group's periodic row halo (rank s sends first = 100 + s
    and last = 100.5 + s), the non-periodic one beside it, and the
    counts."""
    from pymgrit_tpu_torch.parallel.comm import Comm
    c = Comm(mesh.space_group, "cpu")
    first = torch.full((2, 3), 100.0 + mesh.space_rank, dtype=torch.float64)
    above, below = c.row_halo(first, first + 0.5, periodic=True)
    counts = dict(c.counts)
    ends = c.row_halo(first, first + 0.5)
    return {"above": above.numpy(), "below": below.numpy(), "counts": counts,
            "ends": [e.numpy() for e in ends], "n": mesh.n_space, "s": mesh.space_rank}


def nan_max(mesh):
    """``Comm.nan_max`` of three lanes (rank s: lane 0 holds s + 0.5, lane
    1 a NaN on space rank 1 only, lane 2 -inf on rank 0 and s elsewhere),
    float64 and float32; then Newton (``ops.cg.newton``) on three lanes
    whose residual holds a NaN in lane 1 on space rank 1 only, with and
    without the space reduction."""
    from pymgrit_tpu_torch.ops.cg import newton
    from pymgrit_tpu_torch.parallel.comm import Comm
    c = Comm(mesh.space_group, "cpu")
    s = mesh.space_rank
    x = torch.tensor([s + 0.5, float("nan") if s == 1 else 1.0,
                      -float("inf") if s == 0 else float(s)], dtype=torch.float64)
    out = {"f64": c.nan_max(x).numpy(), "f32": c.nan_max(x.float()).numpy(), "s": s}

    def residual(u):
        g = 0.5 * u
        if s == 1:
            g[1] = float("nan")
        return g, g.abs().amax(dim=1)

    def linear_solve(u, g):
        return g, torch.ones(u.shape[0], dtype=torch.int64)

    u0 = torch.ones((3, 4), dtype=torch.float64)
    for key, red in (("reduced", c), ("alone", None)):
        _, n, _ = newton(residual, linear_solve, u0, 1e-3, 50, red)
        out[key] = n.numpy()
    return out


def periodic_slab(mesh):
    """The slab routes of the three periodic models against their whole
    states (this rank's rows): the Hartley pencil solve of random states
    (one and two species: Allen-Cahn, Gray-Scott) against K10's plain
    version, and a chain of two steps with g of each method (the halo
    modes, the IMEX prologue and pencil, the Newton-Krylov loops with the
    space reductions) against the whole-state chain."""
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import periodic as per
    from pymgrit_tpu_torch.parallel.comm import Comm
    comm = Comm(mesh.space_group, "cpu")
    s, n = mesh.space_rank, mesh.n_space
    rng = np.random.default_rng(17)
    out = {}
    J, L, nx = 3, 2, 16
    R = nx // n
    rows = slice(s * R, (s + 1) * R)
    t = np.linspace(0.0, 0.004, J * L + 1)
    tp = t[:-1].reshape(J, L).T.copy()
    tc = t[1:].reshape(J, L).T.copy()
    for model, methods in (("AllenCahn", ("IMEX", "IMPL", "CN")),
                           ("GrayScott2D", ("IMEX", "IMPL", "EXPL")), ("Burgers2D", (None,))):
        for method in methods:
            kw = {} if method is None else {"method": method}
            (whole,), _ = periodic(P, PORT, model, (3,), nx=nx, **kw)
            (slab,), _ = periodic(P, PORT, model, (3,), nx=nx, **kw)
            slab._space_slab(s, n, comm)
            ax = 1 + slab.space_sharding_axis
            x = whole.vector_t_start[None].repeat((J,) + (1,) * whole.vector_t_start.dim())
            x = x + torch.as_tensor(rng.uniform(-0.05, 0.05, x.shape))
            g = torch.as_tensor(rng.uniform(-1e-3, 1e-3, (J, L) + tuple(x.shape[1:])))
            scale = 1e2 if model == "GrayScott2D" else 1.0      # Gray-Scott's slower time
            ow = whole.step_chain(x, tp * scale, tc * scale, torch.empty_like(g), g)
            xs = x.narrow(ax, s * R, R).clone()
            gs = g.narrow(ax + 1, s * R, R).clone()
            os_ = slab.step_chain(xs, tp * scale, tc * scale, torch.empty_like(gs), gs)
            out[f"{model} {method}"] = (os_.numpy(), ow.narrow(ax + 1, s * R, R).numpy())
        if model != "Burgers2D":
            b = torch.as_tensor(rng.uniform(-1, 1, (J,) + tuple(whole.vector_template.shape)))
            fac = torch.as_tensor(rng.uniform(0.001, 0.01, J))
            want = per.periodic_solve2d_plain(b, torch.empty_like(b), whole._H, whole._lam, fac,
                                              coef=whole._coef)
            got = slab._diffusion_solve(fac, b.narrow(ax, s * R, R).contiguous())
            out[f"{model} solve"] = (got.numpy(), want.narrow(ax, s * R, R).numpy())
    return out


def periodic_errors(mesh):
    """On a (2, 2) mesh: a periodic model whose width n_space does not
    divide, Burgers1D (no space axis: replicated), spatial coarsening of a
    periodic model, and a slab's ``compute_radius``."""
    import pymgrit_tpu_torch as P
    import pymgrit_tpu_torch.parallel as PP
    from pymgrit_tpu_torch.parallel.comm import Comm

    def solver(problem, transfer=None):
        return PP.ShardedMgrit(problem=problem, mesh=mesh, transfer=transfer, logging_lvl=30)

    out = {"indivisible": _error(lambda: solver(periodic(P, PORT, "GrayScott2D", (17, 5),
                                                         nx=9)[0])),
           "replicated": _error(lambda: solver([P.Burgers1D(nx=16,
                                                            t_interval=np.linspace(0, 1, n),
                                                            **PORT.kw) for n in (17, 5)])),
           "spatial": _error(lambda: solver(periodic(P, PORT, "AllenCahn", (17, 5))[0],
                                            [P.GridTransferHeat2D(9, 9)]))}
    (ac,), _ = periodic(P, PORT, "AllenCahn", (3,))
    ac._space_slab(mesh.space_rank, mesh.n_space, Comm(mesh.space_group, "cpu"))
    out["radius"] = _error(lambda: ac.compute_radius(ac.vector_t_start))
    return out


PROBES = {f.__name__: f for f in (mesh_errors, comm_ops, space_comm_ops, pencil, periodic_halo,
                                  nan_max, periodic_slab, periodic_errors)}


def port_value(x):
    """A port tube as float64 numpy leaves: a DD tube (nt, 2, ...) as hi +
    lo, a multi-leaf tube's leaves in JAX's order."""
    if isinstance(x, dict):
        return [port_value(x[k])[0] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [port_value(v)[0] for v in x]
    return [x.detach().cpu().numpy().astype(np.float64)]


def port_dd_value(x):
    a = x.detach().cpu().numpy()
    return [a[:, 0].astype(np.float64) + a[:, 1].astype(np.float64)]


def count_k21(problem):
    """Give each level that runs the dispatching kernel set the same set
    with K21 ``indexed_combine`` counted by call (a CPU tensor launches
    nothing, so its launch count stays 0); returns the counts."""
    from pymgrit_tpu_torch.ops import DISPATCH
    counts = {"indexed_combine": 0}

    def indexed_combine(*args, **kw):
        counts["indexed_combine"] += 1
        return DISPATCH.indexed_combine(*args, **kw)

    ops = DISPATCH._replace(indexed_combine=indexed_combine)
    for p in problem:
        if getattr(p, "ops", None) is DISPATCH:
            p.ops = ops
    return counts


def _worker(rank, size, store, cases, directory, backend):
    import torch.distributed as dist
    import pymgrit_tpu_torch as P
    import pymgrit_tpu_torch.parallel as PP

    torch.set_num_threads(1)
    if any(c.get("device", "cpu") != "cpu" for c in cases):
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method="file://" + store, rank=rank, world_size=size,
                            timeout=INIT_TIMEOUT)
    try:
        meshes = {(n, s): PP.make_time_space_mesh(n_time=n, n_space=s)
                  for n, s in sorted({(c["P"], c.get("S", 1)) for c in cases})}
        for case in cases:
            mesh = meshes[case["P"], case.get("S", 1)]
            if mesh is None:
                continue
            try:
                device = case.get("device", "cpu")
                if "probe" in case:
                    kw = {} if device == "cpu" else {"device": device}
                    res = PROBES[case["probe"]](mesh, **kw)
                else:
                    value = port_dd_value if case.get("dd") else port_value
                    side = dataclasses.replace(PORT, kw={"device": device})
                    res = run_case(P, side, PP, case, mesh, value, prepare=count_k21)
            except BaseException:
                path = os.path.join(directory, f"{case['name']}.rank{rank}.err")
                with open(path, "w") as f:
                    f.write(traceback.format_exc())
                raise
            tmp = os.path.join(directory, f".{case['name']}.rank{rank}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(res, f)
            os.replace(tmp, os.path.join(directory, f"{case['name']}.rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()


class World:
    """A running world: results by case name, and its teardown."""

    def __init__(self, ctx, directory, sizes, join_s=JOIN_SECONDS):
        self.ctx, self.directory, self.sizes = ctx, directory, sizes
        self.join_s = join_s
        self.deadline = time.monotonic() + join_s

    def _errors(self):
        return [n for n in os.listdir(self.directory) if n.endswith(".err")]

    def result(self, name):
        """The case's result on each of its ranks, in rank order."""
        size = self.sizes[name]
        paths = [os.path.join(self.directory, f"{name}.rank{r}.pkl") for r in range(size)]
        while not all(os.path.exists(p) for p in paths):
            errs = self._errors()
            if errs:
                text = open(os.path.join(self.directory, sorted(errs)[0])).read()
                raise RuntimeError(f"a worker raised ({sorted(errs)}):\n{text}")
            dead = [p.exitcode for p in self.ctx.processes if p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"a worker died (exit codes {dead}) before case {name}")
            if time.monotonic() > self.deadline:
                raise TimeoutError(f"case {name}: no result within the world's "
                                   f"{self.join_s} s")
            time.sleep(0.05)
        out = []
        for p in paths:
            with open(p, "rb") as f:
                out.append(pickle.load(f))
        return out

    def close(self):
        """Join the world within its deadline; kill what is left."""
        try:
            while not self.ctx.join(timeout=max(0.1, self.deadline - time.monotonic())):
                if time.monotonic() > self.deadline:
                    break
        except Exception:
            pass
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def start_world(size, cases, directory, backend="gloo", join_s=JOIN_SECONDS):
    """Spawn the world of ``size`` ranks (gloo, or NCCL on one GPU a rank)
    that runs ``cases``, all within ``join_s`` seconds of its start."""
    import torch.multiprocessing as mp

    store = os.path.join(str(directory), "rendezvous")
    ctx = mp.start_processes(_worker, args=(size, store, cases, str(directory), backend),
                             nprocs=size, join=False, start_method="spawn")
    return World(ctx, str(directory), {c["name"]: c["P"] * c.get("S", 1) for c in cases},
                 join_s)
