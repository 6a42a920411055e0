"""The pytest side of the sharded-executor tests: a world fixture, the JAX
package's sharded run of a case (in this process, on the virtual CPU
devices of ``tests/conftest.py``), the port's serial run, and the checks.

Not a test module.  ``check(world, case)`` holds the port's ranks against
one another bit for bit (history, iteration count, fine tube), against
JAX's ``ShardedMgrit`` / ``ShardedAtMgrit`` at the same shard count and
against the port's serial ``Mgrit`` / ``AtMgrit``: histories at rtol 1e-9
with the float64 floor (8 + 4 sqrt(n)) eps ||u_C||_2 of the C-point values
as atol, the fine tube within 1e-12 of its largest entry; in DD the
histories at rtol 1e-5 plus a quarter of the DD floor (the last iteration,
at the floor, only below the tolerance) and the tube at rtol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as PS

import pymgrit_tpu as J
import pymgrit_tpu.parallel.shard_solver as JS
from pymgrit_tpu.parallel.sharding import make_time_space_mesh
import pymgrit_tpu_torch as P
from pymgrit_tpu.ops import dd as jdd

import torch_shard_workers as W

EPS = np.finfo(np.float64).eps
RTOL, TUBE_RTOL, DD_RTOL = 1e-9, 1e-12, 1e-5

JAX = W.Side(np=jnp, arr=lambda a: jnp.asarray(a, dtype=jnp.float64), sum=jnp.sum,
             maximum=jnp.maximum, kw={})


def world_fixture(cases, size=4):
    """A module-scoped fixture: the file's gloo world, started once."""

    @pytest.fixture(scope="module")
    def world(tmp_path_factory):
        w = W.start_world(size, cases, tmp_path_factory.mktemp("world"))
        yield w
        w.close()

    return world


def jax_value(x):
    """A JAX tube as float64 numpy leaves (DD as hi + lo, a dict's leaves
    by sorted key)."""
    if isinstance(x, jdd.DD):
        return [np.asarray(x.hi, dtype=np.float64) + np.asarray(x.lo, dtype=np.float64)]
    if isinstance(x, dict):
        return [jax_value(x[k])[0] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [jax_value(v)[0] for v in x]
    return [np.asarray(x, dtype=np.float64)]


def jax_max_jump(base):
    """``torch_shard_workers.max_jump`` for the JAX package: the same
    criterion inside shard_map (pmax over 'time'), its C-point aux sharded
    on 'time'."""

    class MaxJump(base):
        def compiled_convergence_criterion(self, state, aux):
            c = state[0]["blocks"][:, 0]
            jump = jax.lax.pmax(jnp.max(jnp.abs(c - aux["c"])), "time")
            return jump, jump < self.tol, {"c": c, "n": aux["n"] + 1}

        def compiled_conv_aux_init(self):
            b = self.state[0]["blocks"]
            return {"c": jnp.zeros((self.J_pad[0],) + tuple(b.shape[2:]), dtype=b.dtype),
                    "n": jnp.zeros(())}

        def compiled_conv_aux_specs(self, aux0):
            return {"c": PS("time", *([None] * (aux0["c"].ndim - 1))), "n": PS()}

    return MaxJump


JAX_SUBCLASSES = {**W.SUBCLASSES, "max_jump": jax_max_jump}


_JAX_RUNS = {}      # repr(case) -> JAX's result (two tests may check one case)


def jax_run(case):
    """JAX's sharded run of the case on its mesh: ('time',) with P devices,
    or JAX's ('time', 'space') mesh of P x S devices, or the case's
    ``jax_mesh`` (n_time, n_space) where JAX cannot run the port's (XLA's
    SPMD partitioner refuses a mesh of one time shard and a space axis)."""
    key = repr(case)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    P, S_ = case.get("jax_mesh", (case["P"], case.get("S", 1)))
    if S_ > 1:
        mesh = make_time_space_mesh(n_time=P, n_space=S_)
    else:
        mesh = Mesh(np.array(jax.devices()[:P]), ("time",))
    _JAX_RUNS[key] = W.run_case(J, JAX, JS, case, mesh, jax_value, JAX_SUBCLASSES)
    return _JAX_RUNS[key]


def serial_run(case):
    """The port's serial solver on the case's problem."""
    problem, transfer = W.BUILDERS[case["build"]](P, W.PORT, **case.get("build_kw", {}))
    name, sub = (case.get("solver", "ShardedMgrit"), None)
    if isinstance(name, tuple):
        name, sub = name
    base = P.AtMgrit if name == "ShardedAtMgrit" else P.Mgrit
    cls = W.SUBCLASSES[sub](base) if sub else base
    args = (case["k"],) if "k" in case else ()
    kw = dict(case.get("solver_kw", {}), logging_lvl=30)
    if transfer is not None:
        kw["transfer"] = transfer
    m = cls(*args, problem=problem, **kw)
    getattr(m, case.get("entry", "solve"))()
    value = W.port_dd_value if case.get("dd") else W.port_value
    return {"conv": m.conv, "solve_iter": m.solve_iter, "tube": value(m.u[0])}


def floor(tube, cpts):
    """(8 + 4 sqrt(n)) eps ||u_C||_2 over the level-0 C-points, n a state's
    size."""
    c = np.concatenate([x[cpts].reshape(len(cpts), -1) for x in tube], axis=1)
    return (8 + 4 * np.sqrt(c.shape[1])) * EPS * float(np.linalg.norm(c))


def agree(port, ref, case, what):
    it = port["solve_iter"]
    assert ref["solve_iter"] == it, (what, port["conv"][1:it + 1], ref["conv"])
    hp, hr = port["conv"][1:it + 1], ref["conv"][1:it + 1]
    assert len(port["tube"]) == len(ref["tube"])
    if case.get("dd"):
        tol = case.get("solver_kw", {}).get("tol", 1e-7)
        body = slice(None, -1) if hr[-1] < tol else slice(None)
        np.testing.assert_allclose(hp[body], hr[body], rtol=DD_RTOL,
                                   atol=0.25 * min(hr[-1], hp[-1]), err_msg=what)
        assert (hp[-1] < tol) == (hr[-1] < tol), (what, hp, hr)
        for a, b in zip(port["tube"], ref["tube"]):
            np.testing.assert_allclose(a, b, rtol=DD_RTOL, atol=DD_RTOL * np.abs(b).max(),
                                       err_msg=what)
        return
    np.testing.assert_allclose(hp, hr, rtol=RTOL, atol=floor(ref["tube"], port["cpts"]),
                               err_msg=what)
    for a, b in zip(port["tube"], ref["tube"]):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=TUBE_RTOL, atol=TUBE_RTOL * np.abs(b).max(),
                                   err_msg=what)


def check(world, case, serial=True):
    """The case's ranks against rank 0 bit for bit, against JAX's sharded
    run and (``serial``) against the port's serial run; returns (rank
    results, JAX's result)."""
    ranks = world.result(case["name"])
    assert len(ranks) == case["P"] * case.get("S", 1)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["solve_iter"] == r0["solve_iter"]
        assert np.array_equal(r["conv"], r0["conv"])
        for a, b in zip(r["tube"], r0["tube"]):
            assert np.array_equal(a, b)
    jx = jax_run(case)
    assert jx["general"] == r0["general"]
    agree(r0, jx, case, "port vs JAX sharded")
    if serial:
        agree(r0, serial_run(case), case, "port sharded vs port serial")
    return ranks, jx
