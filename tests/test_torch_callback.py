"""Port parity: ``CallbackApplication``, a stepper that runs on the host,
against ``pymgrit_tpu.coupling.CallbackApplication``.

The cases of ``tests/models/test_callback_coupling.py`` -- a scipy
sparse backward-Euler Heat1D step, a subprocess stepper, a stepper built
on torch's LU, and a foreign-layout mini KSP library with opaque
factorizations on a Heat2D problem -- plus a dict state.  One host
function drives both packages: it receives and returns numpy pytrees and
Python floats in each.  Each run records its calls (the step times and
the state handed over), and the two packages make the same calls in the
same order: the JAX package's ``vmap_method='sequential'`` calls the
function once per lane in lane order, the port's ``step_batched`` too.
Histories are held at rtol 1e-10 with the float64 floor (8 + 4 sqrt(n))
eps ||u_C||_2 as atol (n the state's size, u_C the C-point rows of the
port's level-0 tube), the level-0 tubes at rtol 1e-10 of their largest
entry, and against the port's native Heat1D / Heat2D as in the JAX tests.

On the card (``cuda``): the callback and the mock-GetDP induction machine
(on one mesh, and on two with ``GridTransferMachine``) with their states
on the card, against the same runs on the CPU.  Run them
with

    python -m pytest tests/test_torch_callback.py -q -m cuda --noconftest

(the JAX package is imported by the tests that compare with it, never by
the ``cuda`` ones).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve

import pymgrit_tpu_torch as P
from pymgrit_tpu_torch.coupling import CallbackApplication, callback

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-10
EPS = np.finfo(np.float64).eps


def _jax():
    import pymgrit_tpu
    return pymgrit_tpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


class Recorded:
    """A host step that records each call: the times and the state."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, u, t_start, t_stop):
        assert type(t_start) is float and type(t_stop) is float
        self.calls.append((t_start, t_stop, [np.array(x, copy=True) for x in _leaves(u)]))
        return self.fn(u, t_start, t_stop)


def _leaves(u):
    return [u[k] for k in sorted(u)] if isinstance(u, dict) else [u]


def _same_calls(a, b):
    """Both runs made the same calls in the same order: equal times, states
    within rtol 1e-10 of their largest entry."""
    assert len(a.calls) == len(b.calls) > 0
    for (t0, t1, xs), (s0, s1, ys) in zip(a.calls, b.calls):
        assert (t0, t1) == (s0, s1)
        for x, y in zip(xs, ys):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=RTOL * np.max(np.abs(y)))


def _floor(mgrit):
    """(8 + 4 sqrt(n)) eps ||u_C||_2 of a port solve's level-0 tube."""
    rows = mgrit._u[0][torch.as_tensor(mgrit.levels[0].cpts)]
    return (8 + 4 * np.sqrt(rows[0].numel())) * EPS * float(torch.linalg.vector_norm(rows))


def _tube(mgrit):
    u0 = mgrit.u[0]
    return ({k: np.asarray(v) for k, v in u0.items()} if isinstance(u0, dict)
            else np.asarray(u0.cpu() if isinstance(u0, torch.Tensor) else u0))


def _agree(mp, mj, hp, hj):
    assert hp.shape == hj.shape, (hp, hj)
    np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=_floor(mp))
    tp, tj = _tube(mp), _tube(mj)
    for a, b in (zip(tp.values(), (tj[k] for k in tp)) if isinstance(tp, dict) else [(tp, tj)]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.max(np.abs(b)))


def _both(make_step, make_apps, **kw):
    """The same host function through both packages: (port solver, JAX
    solver, port history, JAX history, port recorder, JAX recorder)."""
    J = _jax()
    out = []
    for mod in (P, J):
        rec = Recorded(make_step())
        mg = mod.Mgrit(problem=make_apps(mod, rec), logging_lvl=30, **kw)
        out.append((mg, np.asarray(mg.solve()["conv"]), rec))
    (mp, hp, rp), (mj, hj, rj) = out
    return mp, mj, hp, hj, rp, rj


def _app(mod, host_step, template, start, **grid):
    if mod is P:
        return CallbackApplication(host_step, template, start, device="cpu", **grid)
    from pymgrit_tpu.coupling import CallbackApplication as JaxCallbackApplication
    return JaxCallbackApplication(host_step, template, start, **grid)


def _heat_step(nx):
    """1D heat BE stepper implemented entirely with scipy on the host."""
    x = np.linspace(0, 2, nx)[1:-1]
    n = nx - 2
    fac = 1.0 / (x[1] - x[0]) ** 2
    L = sp.diags([2 * fac * np.ones(n), -fac * np.ones(n - 1), -fac * np.ones(n - 1)],
                 [0, -1, 1], format='csc')
    eye = sp.identity(n, format='csc')
    return lambda: (lambda u, t_start, t_stop: spsolve((t_stop - t_start) * L + eye, u))


def test_callback_app_matches_jax_and_native():
    nx = 33
    x = np.linspace(0, 2, nx)[1:-1]

    def apps(mod, rec):
        return [_app(mod, rec, np.zeros(nx - 2), np.sin(np.pi * x), t_start=0, t_stop=2, nt=nt)
                for nt in (33, 9, 3)]

    mp, mj, hp, hj, rp, rj = _both(_heat_step(nx), apps, max_iter=4, tol=1e-9)
    _same_calls(rp, rj)
    _agree(mp, mj, hp, hj)
    native = P.Mgrit(problem=[P.Heat1D(x_start=0, x_end=2, nx=nx, a=1,
                                       init_cond=lambda xx: np.sin(np.pi * xx), t_start=0,
                                       t_stop=2, nt=nt, device="cpu") for nt in (33, 9, 3)],
                     max_iter=4, logging_lvl=30, tol=1e-9)
    hn = np.asarray(native.solve()['conv'])
    assert hn.shape == hp.shape
    np.testing.assert_allclose(hp, hn, rtol=1e-6, atol=1e-14)


@pytest.mark.parametrize("solver,kw", [
    ("Mgrit", dict(cycle_type="F", cf_iter=0, nested_iteration=False)),
    ("Mgrit", dict(weight_c=0.5, conv_crit=1)),
    ("AtMgrit", dict(k=2))], ids=["fcycle", "weighted-jump", "at-mgrit"])
def test_callback_every_route(solver, kw):
    """Every route to the step -- F- and C-relaxation, the FAS residual,
    the coarsest forward solve, nested iteration, AT-MGRIT's windows --
    reaches host_step with float times, in JAX's call order."""
    nx = 17
    x = np.linspace(0, 2, nx)[1:-1]
    t = np.linspace(0, 2, 33)

    def apps(mod, rec):
        return [_app(mod, rec, np.zeros(nx - 2), np.sin(np.pi * x), t_interval=t[::s])
                for s in (1, 4, 8)]

    J = _jax()
    out = []
    for mod in (P, J):
        rec = Recorded(_heat_step(nx)())
        mg = getattr(mod, solver)(problem=apps(mod, rec), logging_lvl=30, max_iter=3,
                                  tol=1e-12, **kw)
        out.append((mg, np.asarray(mg.solve()["conv"]), rec))
    (mp, hp, rp), (mj, hj, rj) = out
    _same_calls(rp, rj)
    _agree(mp, mj, hp, hj)


def test_callback_subprocess_stepper():
    """The GetDP pattern: the stepper shells out to a process per step."""

    def make():
        def host_step(u, t_start, t_stop):
            code = ("import sys; dt, u = map(float, sys.stdin.read().split()); "
                    "print(repr(u / (1 + dt)))")
            out = subprocess.run([sys.executable, "-S", "-c", code],
                                 input=f"{t_stop - t_start} {float(u)}",
                                 capture_output=True, text=True, check=True)
            return np.float64(out.stdout.strip())
        return host_step

    def apps(mod, rec):
        a0 = _app(mod, rec, np.zeros(1)[0], np.ones(1)[0], t_start=0, t_stop=5, nt=9)
        return [a0, _app(mod, rec, np.zeros(1)[0], np.ones(1)[0], t_interval=a0.t[::2])]

    mp, mj, hp, hj, rp, rj = _both(make, apps, tol=1e-10, max_iter=5)
    _same_calls(rp, rj)
    np.testing.assert_array_equal(hp, hj)
    dt = mp.problem[0].t[1] - mp.problem[0].t[0]
    np.testing.assert_allclose(_tube(mp), (1.0 / (1.0 + dt)) ** np.arange(9), atol=1e-12)
    np.testing.assert_array_equal(_tube(mp), _tube(mj))


def test_callback_thirdparty_torch_lu():
    """PyTorch as the black-box stepper: a cached LU factorization a step
    size, numpy arrays at the boundary."""
    nx, nt = 33, 33
    x = np.linspace(0, 2, nx)[1:-1]
    n = nx - 2
    fac = 1.0 / (x[1] - x[0]) ** 2
    L = (np.diag(2 * fac * np.ones(n)) + np.diag(-fac * np.ones(n - 1), -1)
         + np.diag(-fac * np.ones(n - 1), 1))
    caches = []

    def make():
        lu_cache = {}
        caches.append(lu_cache)
        L_t, eye_t = torch.from_numpy(L), torch.eye(n, dtype=torch.float64)

        def host_step(u, t_start, t_stop):
            dt = round(float(t_stop - t_start), 14)
            if dt not in lu_cache:
                lu_cache[dt] = torch.linalg.lu_factor(eye_t + dt * L_t)
            LU, piv = lu_cache[dt]
            b = torch.from_numpy(np.array(u)).reshape(n, 1)
            return torch.linalg.lu_solve(LU, piv, b).numpy().ravel()
        return host_step

    t = np.linspace(0, 2, nt)

    def apps(mod, rec):
        return [_app(mod, rec, np.zeros(n), np.sin(np.pi * x), t_interval=t[::s])
                for s in (1, 4, 16)]

    mp, mj, hp, hj, rp, rj = _both(make, apps, max_iter=4, tol=1e-9)
    _same_calls(rp, rj)
    _agree(mp, mj, hp, hj)
    assert [len(c) for c in caches] == [3, 3]


class _MiniKSPLib:
    """A stand-in third-party solver stack with a foreign data layout and
    opaque handles (``tests/models/test_callback_coupling.py``'s): unknowns
    in a private column-major buffer, the operator an opaque SuperLU
    factorization, re-factorized only when dt changes."""

    class Vec:
        def __init__(self, buf):
            self._buf = buf

        def get_array_2d(self, shape):
            return self._buf.reshape(shape, order='F').copy()

        @classmethod
        def from_array_2d(cls, arr):
            return cls(np.asarray(arr).flatten(order='F'))

    def __init__(self, nx, ny, x, y, a, rhs):
        self.shape = (nx - 2, ny - 2)
        self.xi = x[1:-1][:, None]
        self.yi = y[None, 1:-1]
        fx = a / (x[1] - x[0]) ** 2
        fy = a / (y[1] - y[0]) ** 2
        n, m = self.shape
        Dxx = sp.diags([2 * fx * np.ones(n), -fx * np.ones(n - 1), -fx * np.ones(n - 1)],
                       [0, -1, 1])
        Dyy = sp.diags([2 * fy * np.ones(m), -fy * np.ones(m - 1), -fy * np.ones(m - 1)],
                       [0, -1, 1])
        self.L = (sp.kron(sp.identity(m), Dxx) + sp.kron(Dyy, sp.identity(n))).tocsc()
        self.rhs = rhs
        self._lu_cache = {}
        self.factorizations = 0

    def _operator(self, dt):
        key = round(float(dt), 14)
        if key not in self._lu_cache:
            from scipy.sparse.linalg import splu
            self._lu_cache[key] = splu((sp.identity(self.L.shape[0], format='csc')
                                        + dt * self.L).tocsc())
            self.factorizations += 1
        return self._lu_cache[key]

    def solve_be(self, vec, t_start, t_stop):
        dt = t_stop - t_start
        b2d = vec.get_array_2d(self.shape) + dt * self.rhs(self.xi, self.yi, t_stop)
        return self.Vec(self._operator(dt).solve(b2d.flatten(order='F')))


def test_callback_foreign_layout_ksp():
    """The mini KSP library behind both packages' CallbackApplication, and
    against the port's native Heat2D."""
    nx = ny = 17
    x, y = np.linspace(0, 1, nx), np.linspace(0, 1, ny)

    def rhs(x, y, t):
        # x/y-asymmetric: a layout or orientation mix-up breaks the parity
        return np.sin(np.pi * x) * y * (1 - y) * (1.0 + 0 * t)

    def ic(xx, yy):
        return np.sin(np.pi * xx) * np.sin(2 * np.pi * yy)

    libs = []

    def make():
        lib = _MiniKSPLib(nx, ny, x, y, a=1.0, rhs=rhs)
        libs.append(lib)

        def host_step(u, t_start, t_stop):
            out = lib.solve_be(_MiniKSPLib.Vec.from_array_2d(u[1:-1, 1:-1]), t_start, t_stop)
            full = np.zeros((nx, ny))
            full[1:-1, 1:-1] = out.get_array_2d(lib.shape)
            return full
        return host_step

    u0 = np.zeros((nx, ny))
    u0[1:-1, 1:-1] = ic(x[1:-1][:, None], y[None, 1:-1])
    t = np.linspace(0, 1, 33)

    def apps(mod, rec):
        return [_app(mod, rec, np.zeros((nx, ny)), u0, t_interval=t[::s]) for s in (1, 4, 16)]

    mp, mj, hp, hj, rp, rj = _both(make, apps, max_iter=4, tol=1e-12)
    _same_calls(rp, rj)
    _agree(mp, mj, hp, hj)
    assert [lib.factorizations for lib in libs] == [3, 3]
    native = P.Mgrit(problem=[P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=ny,
                                       a=1.0, rhs=rhs, init_cond=ic, t_interval=t[::s],
                                       device="cpu") for s in (1, 4, 16)],
                     max_iter=4, logging_lvl=30, tol=1e-12)
    hn = np.asarray(native.solve()['conv'])
    assert hn.shape == hp.shape
    np.testing.assert_allclose(hp, hn, rtol=1e-6, atol=1e-13)


def _dict_step():
    lam, mu = np.array([1.0, 2.5, 4.0]), np.array([0.5, 3.0])

    def host_step(u, t_start, t_stop):
        dt = t_stop - t_start
        pos = (u["pos"] + dt * t_stop) / (1 + dt * lam)
        return {"vel": (u["vel"] + dt * np.sum(pos)) / (1 + dt * mu), "pos": pos}
    return host_step


def test_callback_dict_state():
    """A dict state crosses as a dict of numpy arrays, in both packages."""
    t = np.linspace(0, 1, 33)
    start = {"pos": np.array([1.0, -0.5, 0.25]), "vel": np.array([0.3, -1.0])}
    template = {"pos": np.zeros(3), "vel": np.zeros(2)}

    def apps(mod, rec):
        return [_app(mod, rec, template, start, t_interval=t[::s]) for s in (1, 4)]

    mp, mj, hp, hj, rp, rj = _both(lambda: _dict_step(), apps, max_iter=8, tol=1e-12)
    _same_calls(rp, rj)
    _agree(mp, mj, hp, hj)


def test_step_batched_moves_the_batch_once(monkeypatch):
    """step_batched: one copy to the host and one back a call, host_step
    once a lane in lane order with float times; the result on the batch's
    device and dtype.  step: one state."""
    moves = {"to_host": 0, "to_device": 0}
    for name in moves:
        fn = getattr(callback, name)

        def counted(*a, _fn=fn, _name=name):
            moves[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(callback, name, counted)
    rec = Recorded(lambda u, t0, t1: {"pos": u["pos"] * (t1 - t0), "vel": u["vel"] + t1})
    app = CallbackApplication(rec, {"pos": np.zeros(3), "vel": np.zeros(2)},
                              {"pos": np.ones(3), "vel": np.ones(2)}, t_start=0, t_stop=1, nt=5,
                              device="cpu")
    rng = np.random.default_rng(0)
    u = {"pos": torch.tensor(rng.standard_normal((4, 3))), "vel": torch.tensor(rng.random((4, 2)))}
    t0, t1 = torch.tensor([0.0, 0.25, 0.5, 0.75]), torch.tensor([0.25, 0.5, 0.75, 1.0])
    out = app.step_batched(u, t0, t1)
    assert moves == {"to_host": 1, "to_device": 1}
    assert [c[:2] for c in rec.calls] == list(zip(t0.tolist(), t1.tolist()))
    for i, (_, _, xs) in enumerate(rec.calls):
        np.testing.assert_array_equal(xs[0], u["pos"][i].numpy())
    assert out["pos"].dtype == torch.float64 and out["pos"].shape == (4, 3)
    torch.testing.assert_close(out["pos"], u["pos"] * (t1 - t0)[:, None], rtol=0, atol=0)
    torch.testing.assert_close(out["vel"], u["vel"] + t1[:, None], rtol=0, atol=0)
    one = app.step({"pos": u["pos"][1], "vel": u["vel"][1]}, 0.25, torch.tensor(0.5))
    torch.testing.assert_close(one["pos"], out["pos"][1], rtol=0, atol=0)
    assert moves == {"to_host": 2, "to_device": 2}


def test_templates_are_tensors_on_the_asked_device():
    app = CallbackApplication(lambda u, a, b: u, np.zeros((2, 3)), np.ones((2, 3)), t_start=0,
                              t_stop=1, nt=3, device="cpu")
    assert isinstance(app.vector_t_start, torch.Tensor)
    assert app.vector_t_start.device.type == "cpu" and app.vector_t_start.dtype == torch.float64


def _callback_run(device):
    cfg = dict(chip_smoke.CALLBACK, nx=33, nt=65)
    x = np.linspace(0, 2, cfg["nx"])[1:-1]
    t = np.linspace(0, cfg["t_stop"], cfg["nt"])
    step = chip_smoke.host_heat1d_step(cfg["nx"], 2.0)
    mg = P.Mgrit(problem=[CallbackApplication(step, np.zeros(x.size), np.sin(np.pi * x),
                                              t_interval=t[::s], device=device)
                          for s in (1, 4, 16)], tol=cfg["tol"], max_iter=cfg["max_iter"],
                 logging_lvl=30)
    return np.asarray(mg.solve_compiled()["conv"]), mg.u[0].cpu()


@pytest.mark.cuda
def test_callback_on_card_equals_cpu(cuda):
    hc, uc = _callback_run(cuda)
    hh, uh = _callback_run("cpu")
    assert hc.shape == hh.shape
    np.testing.assert_allclose(hc, hh, rtol=1e-9, atol=0)
    torch.testing.assert_close(uc, uh, rtol=1e-12, atol=1e-14)


def _machine_run(device, tmp):
    from pymgrit_tpu_torch.models.induction_machine import InductionMachine, MgritMachineConvJl
    tmp.mkdir()
    env, _ = chip_smoke.machine_env(tmp)
    cfg = chip_smoke.MACHINE
    mg = MgritMachineConvJl(problem=[InductionMachine(**env, t_start=0.0, t_stop=cfg["t_stop"],
                                                      nt=nt, device=device)
                                     for nt in cfg["nts"]],
                            tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30)
    mg.solve_compiled()
    return mg.conv[:mg.solve_iter + 1], {k: v.cpu() for k, v in mg.u[0].items()}


@pytest.mark.cuda
def test_mock_machine_on_card_equals_cpu(cuda, tmp_path):
    hc, uc = _machine_run(cuda, tmp_path / "card")
    hh, uh = _machine_run("cpu", tmp_path / "cpu")
    np.testing.assert_array_equal(hc, hh)
    for k in uh:
        torch.testing.assert_close(uc[k], uh[k], rtol=1e-12, atol=0)


def _two_mesh_run(device, tmp):
    from pymgrit_tpu_torch.models.induction_machine import GridTransferMachine, InductionMachine
    tmp.mkdir()
    kws, path = chip_smoke.two_mesh_env(tmp)
    mg = chip_smoke.two_mesh_machine(P.Mgrit, InductionMachine, GridTransferMachine, kws, path,
                                     chip_smoke.TWO_MESH_JAX.size, device=device)
    return np.asarray(mg.solve()["conv"]), {k: v.cpu() for k, v in mg.u[0].items()}


@pytest.mark.cuda
def test_two_mesh_machine_on_card_equals_cpu(cuda, tmp_path):
    """GridTransferMachine between the machine's meshes, on the card."""
    hc, uc = _two_mesh_run(cuda, tmp_path / "card")
    hh, uh = _two_mesh_run("cpu", tmp_path / "cpu")
    np.testing.assert_allclose(hc, hh, rtol=1e-12, atol=0)
    for k in uh:
        torch.testing.assert_close(uc[k], uh[k], rtol=1e-12, atol=1e-15)
