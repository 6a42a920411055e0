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
its start).
"""

from __future__ import annotations

import dataclasses
import datetime
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


def heat2d(mod, side, nts, nx=10, ny=12, **kw):
    """Heat2D on the unit square with rhs sin(pi x) sin(pi y) and the same
    initial condition (JAX's ``test_shard_features.py``)."""
    xp = side.np

    def rhs(x, y, t):
        return xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.ones_like(t * x * y)

    def ic(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    t = np.linspace(0, 1, nts[0])
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


BUILDERS = {f.__name__: f for f in (dahlquist, dahlquist_grid, heat2d, heat2d_serial, heat1d,
                                    two_leaf)}


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
    """The mesh factory's refusal and a (2, 2) mesh's shape; then the
    solver's refusals on that mesh: a width n_space does not divide, an
    application without a space route, double-double states, spatial
    coarsening."""
    import pymgrit_tpu_torch as P
    import pymgrit_tpu_torch.parallel as PP
    out = {"too_big": _error(lambda: PP.make_time_space_mesh(n_time=64, n_space=4))}
    grid = PP.make_time_space_mesh(n_time=2, n_space=2)
    out["space"] = grid.shape

    def solver(build, transfer=None, **kw):
        problem, _ = BUILDERS[build](P, PORT, **kw)
        return PP.ShardedMgrit(problem=problem, mesh=grid, transfer=transfer, logging_lvl=30)

    out["indivisible"] = _error(lambda: solver("heat2d", nts=(17, 5), nx=9))
    out["no_route"] = _error(lambda: solver("dahlquist", nts=(17, 5)))
    out["dd"] = _error(lambda: solver("heat2d", nts=(17, 5), basis="spectral", precision="dd"))
    out["fe"] = _error(lambda: solver("heat2d", nts=(17, 5), method="FE"))
    out["spatial"] = _error(lambda: solver("heat2d", nts=(17, 5),
                                           transfer=[P.GridTransferHeat2D(9, 9)]))
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


PROBES = {f.__name__: f for f in (mesh_errors, comm_ops, space_comm_ops, pencil)}


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

    def __init__(self, ctx, directory, sizes):
        self.ctx, self.directory, self.sizes = ctx, directory, sizes
        self.deadline = time.monotonic() + JOIN_SECONDS

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
                                   f"{JOIN_SECONDS} s")
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


def start_world(size, cases, directory, backend="gloo"):
    """Spawn the world of ``size`` ranks (gloo, or NCCL on one GPU a rank)
    that runs ``cases``."""
    import torch.multiprocessing as mp

    store = os.path.join(str(directory), "rendezvous")
    ctx = mp.start_processes(_worker, args=(size, store, cases, str(directory), backend),
                             nprocs=size, join=False, start_method="spawn")
    return World(ctx, str(directory), {c["name"]: c["P"] * c.get("S", 1) for c in cases})
