"""Port parity: the solver's observability surface, against ``pymgrit_tpu``.

The cases of ``tests/core/test_compiled_solve.py`` (Dahlquist in
``solve_compiled`` against ``solve``, the jump criterion, a Heat1D
F-cycle, a user criterion in the compiled loop) and of
``tests/core/test_observability.py`` (``profile_phases``,
``solve_profiled``), each built in both packages from the same numbers.
Histories are held at rtol 1e-10: within the port, ``solve_compiled``
against ``solve`` (no atol), and port against JAX with the repo's float64
history floor (8 + 4 sqrt(n)) eps ||u_C||_2 as atol (n the state's size,
u_C the C-point rows of the port's level-0 tube): the two packages round
the last iterations differently (Dahlquist's tail, 3.98e-12, differs by
2.5e-18).  The condensed level-0 carry declines
with the JAX package's reason when only the compiled criterion is set.
``profile_phases`` returns the JAX package's keys and leaves the solver as
it found it: a solve after it gives the history and the tube of a solve
without it, bit for bit.  ``solve_profiled`` writes a trace into its
directory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core import vector as jvector

torch.set_num_threads(1)

RTOL = 1e-10
EPS = np.finfo(np.float64).eps


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


def _dahlquist(mod, level=2):
    return mod.simple_setup_problem(problem=mod.Dahlquist(t_start=0, t_stop=5, nt=101,
                                                          **_cpu(mod)),
                                    level=level, coarsening=2)


def _heat_fcycle(mod):
    xp = jnp if mod is J else np

    def rhs(x, t):
        return -xp.sin(xp.pi * x) * (xp.sin(t) - 1 * xp.pi ** 2 * xp.cos(t))

    return [mod.Heat1D(x_start=0, x_end=1, nx=129, a=1, rhs=rhs,
                       init_cond=lambda x: np.sin(np.pi * x), t_start=0, t_stop=2, nt=nt,
                       **_cpu(mod)) for nt in (65, 33, 17, 9, 5)]


def _heat_spectral(mod):
    """A Heat1D hierarchy the condensed carry takes (spectral basis)."""
    t = np.linspace(0, 1, 65)
    return [mod.Heat1D(x_start=0, x_end=2, nx=17, a=0.5, init_cond=lambda x: np.sin(np.pi * x / 2),
                       t_interval=t[::s], basis="spectral", **_cpu(mod)) for s in (1, 4, 16)]


def _hist(info):
    return np.asarray(info["conv"])


def _floor(mgrit):
    """(8 + 4 sqrt(n)) eps ||u_C||_2 of a port solve's level-0 tube."""
    u_c = mgrit.u[0][torch.as_tensor(mgrit.levels[0].cpts)]
    return (8 + 4 * np.sqrt(u_c[0].numel())) * EPS * float(torch.linalg.vector_norm(u_c))


def _agree(a, b, atol=0.0):
    assert a.shape == b.shape, (a, b)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


def _solve(mgrit, entry="solve"):
    return mgrit, _hist(getattr(mgrit, entry)())


@pytest.mark.parametrize("conv_crit", [0, 1])
def test_compiled_matches_host_loop(conv_crit):
    kw = dict(tol=1e-10, conv_crit=conv_crit, logging_lvl=30)
    ref = _hist(J.Mgrit(problem=_dahlquist(J), **kw).solve())
    mp, host = _solve(P.Mgrit(problem=_dahlquist(P), **kw))
    dev = _hist(P.Mgrit(problem=_dahlquist(P), **kw).solve_compiled())
    _agree(host, ref, _floor(mp))
    _agree(dev, host)


def test_compiled_fcycle_heat():
    kw = dict(tol=1e-8, cf_iter=1, cycle_type='F', nested_iteration=False, max_iter=10,
              logging_lvl=30)
    ref = _hist(J.Mgrit(problem=_heat_fcycle(J), **kw).solve_compiled())
    mp, host = _solve(P.Mgrit(problem=_heat_fcycle(P), **kw))
    dev = _hist(P.Mgrit(problem=_heat_fcycle(P), **kw).solve_compiled())
    _agree(host, ref, _floor(mp))
    _agree(dev, host)


def _max_jump(mod):
    """The largest change of a C-point value from the previous iterate, as
    an eager and a compiled criterion (the documented subclassing pattern,
    reference examples/example_convergence_criterion.py:13-61)."""
    if mod is J:
        class MaxJumpMgrit(J.Mgrit):
            def convergence_criterion(self, iteration):
                u_c = np.asarray(jvector.take(self.u[0], self.levels[0].cpts))
                if getattr(self, "_prev", None) is None:
                    self._prev = np.zeros_like(u_c)
                conv = np.max(np.abs(u_c - self._prev))
                self.conv[iteration] = conv
                self._all_below = conv < self.tol
                self._prev = u_c

            def compiled_convergence_criterion(self, state, aux):
                u_c = jvector.take(state[0][0], jnp.asarray(self.levels[0].cpts))
                conv = jnp.max(jnp.abs(u_c - aux))
                return conv, conv < self.tol, u_c

            def compiled_conv_aux_init(self):
                return jnp.zeros_like(jvector.take(self.u[0], jnp.asarray(self.levels[0].cpts)))
        return MaxJumpMgrit

    class MaxJumpTorch(P.Mgrit):
        def _cpts(self):
            return torch.as_tensor(self.levels[0].cpts, device=self.device)

        def convergence_criterion(self, iteration):
            u_c = self.u[0][self._cpts()].cpu().numpy()
            if getattr(self, "_prev", None) is None:
                self._prev = np.zeros_like(u_c)
            conv = np.max(np.abs(u_c - self._prev))
            self.conv[iteration] = conv
            self._all_below = conv < self.tol
            self._prev = u_c

        def compiled_convergence_criterion(self, state, aux):
            u_c = state[0][0][self._cpts()]
            conv = torch.max(torch.abs(u_c - aux))
            return conv, conv < self.tol, u_c

        def compiled_conv_aux_init(self):
            return torch.zeros_like(self.u[0][self._cpts()])
    return MaxJumpTorch


@pytest.mark.parametrize("build", [_dahlquist, _heat_spectral], ids=["dahlquist", "heat_spectral"])
def test_compiled_custom_criterion(build):
    kw = dict(tol=1e-9, max_iter=20, logging_lvl=30)
    runs = {(mod, entry): _solve(_max_jump(mod)(problem=build(mod), **kw), entry)
            for mod in (J, P) for entry in ("solve", "solve_compiled")}
    floor = _floor(runs[P, "solve"][0])
    _agree(runs[P, "solve_compiled"][1], runs[P, "solve"][1])
    _agree(runs[P, "solve"][1], runs[J, "solve"][1], floor)
    _agree(runs[P, "solve_compiled"][1], runs[J, "solve_compiled"][1], floor)


def test_compiled_criterion_keeps_its_aux_on_the_device():
    """The aux is a pytree of tensors carried across iterations; the last
    one is kept as ``_compiled_conv_aux``."""
    class Counting(P.Mgrit):
        def compiled_convergence_criterion(self, state, aux):
            conv, _ = self._residual_conv_fn()
            aux = {"n": aux["n"] + 1, "first": torch.where(aux["n"] == 0, conv, aux["first"])}
            return conv, conv < self.tol, aux

        def compiled_conv_aux_init(self):
            zero = torch.zeros((), dtype=torch.float64, device=self.device)
            return {"n": zero, "first": zero}

    m = Counting(problem=_dahlquist(P), tol=1e-10, logging_lvl=30)
    conv = _hist(m.solve_compiled())
    aux = m._compiled_conv_aux
    assert isinstance(aux["n"], torch.Tensor) and float(aux["n"]) == m.solve_iter == conv.size
    assert float(aux["first"]) == conv[0]
    _agree(conv, _hist(P.Mgrit(problem=_dahlquist(P), tol=1e-10, logging_lvl=30).solve()))


def test_default_compiled_aux_is_a_cached_zero():
    m = P.Mgrit(problem=_dahlquist(P), tol=1e-10, logging_lvl=30)
    aux = m.compiled_conv_aux_init()
    assert aux.shape == () and aux.dtype == torch.float64 and float(aux) == 0.0
    assert m.compiled_conv_aux_init() is aux
    m.solve_compiled()
    assert m._compiled_conv_aux is aux


def test_compiled_hook_alone_declines_the_condensed_carry():
    """Only the compiled criterion set: both packages keep the full level-0
    tube and give the same reason; without it the carry is condensed."""
    def hooked(mod):
        class Hooked(mod.Mgrit):
            def compiled_convergence_criterion(self, state, aux):
                u0 = state[0][0]
                conv = (jnp if mod is J else torch).max(
                    (jnp if mod is J else torch).abs(u0[-1]))
                return conv, conv < self.tol, aux
        return Hooked

    reasons = []
    for mod in (J, P):
        plain = mod.Mgrit(problem=_heat_spectral(mod), logging_lvl=30)
        assert plain._condensed0 and plain._cnd_decline_reason is None
        m = hooked(mod)(problem=_heat_spectral(mod), logging_lvl=30, tol=1e-300, max_iter=3)
        assert not m._condensed0
        reasons.append(m._cnd_decline_reason)
        if mod is P:
            assert m._u[0].shape[0] == m.levels[0].nt
            m.solve_compiled()
            assert m.solve_iter == 3
    assert reasons[0] == reasons[1] == (
        "a custom convergence criterion reads the raw level-0 state and needs the full fine tube")


@pytest.mark.parametrize("build,level", [(_dahlquist, 3), (_heat_spectral, 3)],
                         ids=["dahlquist", "heat_spectral"])
def test_profile_phases_keys_and_values(build, level):
    mj = J.Mgrit(problem=build(J) if build is _heat_spectral else _dahlquist(J, level),
                 tol=1e-10, logging_lvl=30)
    mp = P.Mgrit(problem=build(P) if build is _heat_spectral else _dahlquist(P, level),
                 tol=1e-10, logging_lvl=30)
    rj, rp = mj.profile_phases(repeats=2), mp.profile_phases(repeats=2)
    assert set(rp) == set(rj)
    assert "f_relax[0]" in rp and "full_iteration" in rp
    assert all(v >= 0 for v in rp.values())


@pytest.mark.parametrize("build,entry", [(_dahlquist, "solve"), (_heat_spectral, "solve_compiled"),
                                         (_heat_spectral, "solve")],
                         ids=["dahlquist-solve", "condensed-compiled", "condensed-solve"])
def test_profile_phases_leaves_the_next_solve_unchanged(build, entry):
    kw = dict(tol=1e-10, logging_lvl=30)
    a = P.Mgrit(problem=build(P), **kw)
    a.profile_phases(repeats=2)
    b = P.Mgrit(problem=build(P), **kw)
    ha, hb = _hist(getattr(a, entry)()), _hist(getattr(b, entry)())
    assert np.array_equal(ha, hb)
    assert torch.equal(a.u[0], b.u[0])


def test_profile_phases_after_a_solve_leaves_the_state_as_found():
    """After a solve the level-0 tube is materialized: profile_phases
    re-condenses a copy, and leaves the tubes (the same tensors, the same
    values), ``conv`` and the next solve as they were."""
    m = P.Mgrit(problem=_heat_spectral(P), tol=1e-10, logging_lvl=30, max_iter=2)
    m.solve()
    tubes = [list(t) for t in (m._u, m._v, m._g)]
    values = [[None if x is None else x.clone() for x in t] for t in tubes]
    conv = m.conv.copy()
    m.profile_phases(repeats=1)
    for t, now, before in zip(tubes, (m._u, m._v, m._g), values):
        for x, y, z in zip(t, now, before):
            assert x is y
            assert (x is None and z is None) or torch.equal(x, z)
    assert np.array_equal(m.conv, conv)
    twin = P.Mgrit(problem=_heat_spectral(P), tol=1e-10, logging_lvl=30, max_iter=2)
    twin.solve()
    m.iter_max = twin.iter_max = 4
    m.conv, twin.conv = np.zeros(5), np.zeros(5)
    assert np.array_equal(_hist(m.solve()), _hist(twin.solve()))
    assert torch.equal(m.u[0], twin.u[0])


def test_solve_profiled(tmp_path):
    trace_dir = tmp_path / "trace"
    m = P.Mgrit(problem=_dahlquist(P, 3), tol=1e-8, logging_lvl=30)
    info = m.solve_profiled(str(trace_dir))
    assert info['conv'][-1] < 1e-8
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    ref = J.Mgrit(problem=_dahlquist(J, 3), tol=1e-8, logging_lvl=30).solve_profiled(
        str(tmp_path / "jax_trace"))
    _agree(_hist(info), _hist(ref), _floor(m))
