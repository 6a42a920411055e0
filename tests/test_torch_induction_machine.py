"""Port parity: the induction machine (``models/induction_machine``),
against ``pymgrit_tpu.models.induction_machine``.

* The GetDP and gmsh parsers and the transfer factors on the committed
  fixtures (``tests/models/fixtures/im/``) equal the JAX package's, bit for
  bit (both are numpy and scipy).
* ``GridTransferMachine``'s restriction and interpolation on the fixture
  pair equal JAX's at rtol 1e-14 of the largest entry, one state and a
  batch of rows alike; ``machine_norm`` excludes the scalars.
* Against the mock GetDP of ``tests/models/test_induction_machine_e2e.py``
  (backward Euler on u' = -u + 1, written by ``chip_smoke.machine_env``):
  one step, sub-steps, ``MgritMachineConvJl`` in ``solve`` and
  ``solve_compiled`` and ``MgritMachine``'s PWM switch, each in both
  packages: histories at rtol 1e-9, final states at rtol 1e-10 of the
  sequential march, both mocks' argv logs with the same -pre and -restart
  calls (the same PWM flags on each).  ``chip_smoke.MACHINE_JAX`` is the
  JAX package's history of ``chip_smoke.MACHINE``.
* A two-mesh machine (the fixture meshes, a mock a mesh) with
  ``GridTransferMachine`` between its levels: the middle leaf has 64
  unknowns on level 0 and 32 on level 1; its JAX history is
  ``chip_smoke.TWO_MESH_JAX``.  A JAX solver state carried over
  with ``interop.state_from_numpy`` (JAX's leaf order: back, front,
  middle, scalars, as the port's ``Layout``) and one more iteration in
  both packages agree at rtol 1e-12.
"""

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.models.induction_machine import application as j_app
from pymgrit_tpu.models.induction_machine import grid_transfer_machine as j_gtm
from pymgrit_tpu.models.induction_machine import io_getdp as j_io
from pymgrit_tpu.models.induction_machine import machine_state as j_ms
from pymgrit_tpu.models.induction_machine import solvers as j_solvers
from pymgrit_tpu_torch.interop import state_from_numpy
from pymgrit_tpu_torch.models import induction_machine as p_pkg
from pymgrit_tpu_torch.models.induction_machine import application as p_app
from pymgrit_tpu_torch.models.induction_machine import grid_transfer_machine as p_gtm
from pymgrit_tpu_torch.models.induction_machine import io_getdp as p_io
from pymgrit_tpu_torch.models.induction_machine import machine_state as p_ms
from pymgrit_tpu_torch.models.induction_machine import solvers as p_solvers

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

FIX = str(ROOT / "tests" / "models" / "fixtures" / "im") + os.sep
EXTRA = 8 + 15                      # further unknowns front and back
H_RTOL, MARCH_RTOL, CARRY_RTOL = 1e-9, 1e-10, 1e-12
MODS = {"jax": (j_app, j_solvers, {}), "torch": (p_app, p_solvers, {"device": "cpu"})}


def test_all_is_the_jax_packages():
    import pymgrit_tpu.models.induction_machine as j_pkg
    assert p_pkg.__all__ == j_pkg.__all__


# ---------------------------------------------------------------------------
# parsers, transfer factors, transfer, norm
# ---------------------------------------------------------------------------

def _equal(a, b, where=""):
    """Bit for bit: arrays of the same dtype and values, dicts, lists."""
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b and type(a) is type(b), where


@pytest.mark.parametrize("grid", ["machine_coarse", "machine_fine"])
def test_parsers_equal_jax(grid):
    for fn, args in (("check_version", (FIX + grid + ".msh",)),
                     ("get_nodes", (FIX + grid + ".msh",)),
                     ("get_elements", (FIX + grid + ".msh",)),
                     ("pre_file", (FIX + grid + ".pre",)),
                     ("get_preresolution", (FIX + grid + ".pre",))):
        _equal(getattr(p_io, fn)(*args), getattr(j_io, fn)(*args), fn)
    start = 0 if grid == "machine_coarse" else 32
    _equal(p_io.compute_data(FIX + grid + ".pre", FIX + grid + ".msh", start),
           j_io.compute_data(FIX + grid + ".pre", FIX + grid + ".msh", start), "compute_data")


def test_result_files_equal_jax(tmp_path):
    _equal(p_io.getdp_read_resolution(FIX + "machine.res", 32),
           j_io.getdp_read_resolution(FIX + "machine.res", 32))
    _equal(p_io.get_values_from(FIX + "resJL.dat"), j_io.get_values_from(FIX + "resJL.dat"))
    u = np.random.default_rng(5).standard_normal(32)
    for io, name in ((p_io, "p.res"), (j_io, "j.res")):
        io.set_resolution(str(tmp_path / name), 0.125, u, 32)
    assert (tmp_path / "p.res").read_text() == (tmp_path / "j.res").read_text()


def _data(io):
    dc = io.compute_data(FIX + "machine_coarse.pre", FIX + "machine_coarse.msh", 0)
    df = io.compute_data(FIX + "machine_fine.pre", FIX + "machine_fine.msh", len(dc['corToUn']))
    return dc, df


def test_interpolation_factors_equal_jax():
    _equal(p_io.interpolation_factors(*_data(p_io)), j_io.interpolation_factors(*_data(j_io)))
    rng = np.random.default_rng(0)
    coarse = np.vstack([rng.random((30, 2)), [[0, 0], [0, 1], [1, 0], [1, 1]]])
    fine = 0.1 + 0.8 * rng.random((50, 2))
    _equal(p_io.interp_weights(coarse, fine, tol=1e-12), j_io.interp_weights(coarse, fine,
                                                                             tol=1e-12))


def _close(p, j, rtol=1e-14):
    p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    j = np.asarray(j)
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def test_mesh_transfer_equals_jax():
    dc, df = _data(p_io)
    fac = p_io.interpolation_factors(dc, df)
    vals = np.random.default_rng(1).standard_normal(dc['unknownComInner'].shape[0] - 8)
    for dif, dif2 in ((8, 0), (8, 3)):
        got = p_io.compute_mesh_transfer(torch.tensor(vals), fac['vtxInner'], fac['wtsInner'],
                                         dif, dif2)
        _close(got, j_io.compute_mesh_transfer(vals, fac['vtxInner'], fac['wtsInner'], dif, dif2))
    wts = fac['wtsInner'].copy()
    wts[2, 1] = -0.5
    got = p_io.compute_mesh_transfer(torch.tensor(vals), fac['vtxInner'], wts, 8, 0)
    ref = np.asarray(j_io.compute_mesh_transfer(vals, fac['vtxInner'], wts, 8, 0))
    assert np.isnan(got[2].item()) and np.isnan(ref[2])
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))


def _state(mod, middle, seed=3, lead=()):
    rng = np.random.default_rng(seed)
    leaves = [rng.standard_normal(lead + (n,)) for n in (8, middle, 15, 8)]
    if mod is j_ms:
        return j_ms.MachineState(*leaves)
    return p_ms.MachineState(*[torch.tensor(x) for x in leaves])


def test_grid_transfer_machine_equals_jax():
    tp = p_gtm.GridTransferMachine("machine_coarse", "machine_fine", FIX)
    tj = j_gtm.GridTransferMachine("machine_coarse", "machine_fine", FIX)
    assert tp.batched
    _equal(tp.transfer_data, tj.transfer_data)
    for method, middle in (("interpolation", 32), ("restriction", 64)):
        up, uj = _state(p_ms, middle), _state(j_ms, middle)
        outp, outj = getattr(tp, method)(up), getattr(tj, method)(uj)
        for k in ("front", "middle", "back", "scalars"):
            _close(outp[k], outj[k])
        # a batch of rows, as the solver hands a tube: each row the state's
        rows = _state(p_ms, middle, seed=4, lead=(5,))
        out_rows = getattr(tp, method)(rows)
        for r in range(5):
            one = getattr(tj, method)(j_ms.MachineState(*[rows[k][r].numpy() for k in
                                                          ("front", "middle", "back",
                                                           "scalars")]))
            for k in ("front", "middle", "back", "scalars"):
                _close(out_rows[k][r], one[k])


def test_machine_norm_excludes_scalars():
    u = p_ms.MachineState(torch.ones(3, dtype=torch.float64), torch.ones(4, dtype=torch.float64),
                          torch.ones(5, dtype=torch.float64),
                          scalars=torch.full((8,), 100.0, dtype=torch.float64))
    assert abs(float(p_ms.machine_norm(u)) - np.sqrt(12)) < 1e-12
    up, uj = _state(p_ms, 32), _state(j_ms, 32)
    # the sums of squares add in another order than XLA's reduction
    np.testing.assert_allclose(float(p_ms.machine_norm(up)), float(j_ms.machine_norm(uj)),
                               rtol=4 * np.finfo(np.float64).eps)
    rows = _state(p_ms, 32, lead=(4,))
    torch.testing.assert_close(torch.vmap(p_ms.machine_norm)(rows),
                               torch.stack([p_ms.machine_norm({k: v[r] for k, v in rows.items()})
                                            for r in range(4)]), rtol=0, atol=0)


def test_zero_state_and_get_values():
    z = p_ms.zero_state(2, 3, 4, device="cpu")
    assert sorted(z) == ["back", "front", "middle", "scalars"]
    assert z["scalars"].shape == (8,) and z["middle"].dtype == torch.float64
    np.testing.assert_array_equal(p_ms.get_values(_state(p_ms, 5)).numpy(),
                                  np.asarray(j_ms.get_values(_state(j_ms, 5))))


# ---------------------------------------------------------------------------
# the mock GetDP, end to end
# ---------------------------------------------------------------------------

def _env(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return chip_smoke.machine_env(d)


def _calls(log):
    restarts, pres = chip_smoke.getdp_calls(log)
    return pres, [ln.split()[-1] for ln in restarts]


def _last(mg):
    u0 = mg.u[0]
    return {k: np.asarray(v)[-1] for k, v in u0.items()}


def test_step_round_trip(tmp_path):
    """One step: the same DOF vector, scalars and GetDP calls in both
    packages, one backward-Euler step of the mock's dynamics."""
    rng = np.random.default_rng(3)
    leaves = [rng.random(n) for n in (8, chip_smoke.MACHINE_MIDDLE, 15)]
    out = {}
    for name, (app, _, dev) in MODS.items():
        env, log = _env(tmp_path, name)
        a = app.InductionMachine(**env, t_start=0.0, t_stop=0.2, nt=5, pwm=1, **dev)
        assert a.nx == chip_smoke.MACHINE_MIDDLE + EXTRA
        u0 = (j_ms.MachineState(*leaves) if name == "jax"
              else p_ms.MachineState(*[torch.tensor(x) for x in leaves]))
        res = a.step(u0, a.t[0], a.t[1])
        out[name] = ({k: np.asarray(v) for k, v in res.items()}, _calls(log))
    for k in out["jax"][0]:
        np.testing.assert_array_equal(out["torch"][0][k], out["jax"][0][k])
    assert out["torch"][1] == out["jax"][1] == (1, ["1"])
    expected = (np.concatenate(leaves) + 0.05) / 1.05
    got = out["torch"][0]
    np.testing.assert_allclose(np.concatenate([got["front"], got["middle"], got["back"]]),
                               expected, rtol=1e-12)
    np.testing.assert_allclose(got["scalars"], [np.sum(expected ** 2), 1, 2, 3, 4, 5, 6, 7],
                               rtol=1e-12)


def test_steps_per_solve_substeps(tmp_path):
    env, _ = _env(tmp_path, "torch")
    a = p_app.InductionMachine(**env, t_start=0.0, t_stop=0.2, nt=5, steps_per_solve=2,
                               device="cpu")
    u0 = p_ms.MachineState(*[torch.ones(n, dtype=torch.float64)
                             for n in (8, chip_smoke.MACHINE_MIDDLE, 15)])
    out = a.step(u0, a.t[0], a.t[1])
    expected = np.ones(chip_smoke.MACHINE_MIDDLE + EXTRA)
    for _ in range(2):
        expected = (expected + 0.025) / 1.025
    np.testing.assert_allclose(p_ms.get_values(out).numpy(), expected, rtol=1e-12)


def _conv_jl(name, tmp_path, method, cfg=chip_smoke.MACHINE):
    app, solvers, dev = MODS[name]
    env, log = _env(tmp_path, f"{name}_{method}")
    apps = [app.InductionMachine(**env, t_start=0.0, t_stop=cfg["t_stop"], nt=nt, **dev)
            for nt in cfg["nts"]]
    mg = solvers.MgritMachineConvJl(problem=apps, tol=cfg["tol"], max_iter=cfg["max_iter"],
                                    logging_lvl=30, nested_iteration=True)
    info = getattr(mg, method)()
    return mg, info, _calls(log)


@pytest.mark.parametrize("method", ["solve", "solve_compiled"])
def test_mgrit_machine_conv_jl_end_to_end(tmp_path, method):
    """Both packages stop at the same iteration with the same history and
    the same GetDP calls; the final state is the sequential march's."""
    mp, ip, cp = _conv_jl("torch", tmp_path, method)
    mj, ij, cj = _conv_jl("jax", tmp_path, method)
    assert mp.solve_iter == mj.solve_iter < chip_smoke.MACHINE["max_iter"]
    hp, hj = mp.conv[:mp.solve_iter + 1], mj.conv[:mj.solve_iter + 1]
    np.testing.assert_allclose(hp, hj, rtol=H_RTOL, atol=0)
    np.testing.assert_allclose(hj, chip_smoke.MACHINE_JAX, rtol=H_RTOL, atol=0)
    assert list(ip["conv"]) == [c for c in mp.conv if c != 0]
    assert cp == cj and cp[0] > 0
    nts = chip_smoke.MACHINE["nts"]
    ref = chip_smoke.machine_march(nts[0] - 1, chip_smoke.MACHINE["t_stop"] / (nts[0] - 1))
    for mg in (mp, mj):
        last = _last(mg)
        np.testing.assert_allclose(np.concatenate([last["front"], last["middle"], last["back"]]),
                                   ref, rtol=MARCH_RTOL)
        np.testing.assert_allclose(last["scalars"][0], np.sum(ref ** 2), rtol=MARCH_RTOL)
    for k in ("front", "middle", "back", "scalars"):
        np.testing.assert_allclose(np.asarray(mp.u[0][k]), np.asarray(mj.u[0][k]),
                                   rtol=MARCH_RTOL)


def test_solve_and_solve_compiled_agree(tmp_path):
    s, _, cs = _conv_jl("torch", tmp_path, "solve")
    c, _, cc = _conv_jl("torch", tmp_path, "solve_compiled")
    assert s.solve_iter == c.solve_iter and cs == cc
    np.testing.assert_array_equal(s.conv[:s.solve_iter + 1], c.conv[:c.solve_iter + 1])
    assert not s._condensed0 and s._cnd_decline_reason.startswith("a custom convergence")
    np.testing.assert_array_equal(c.last_it, c._compiled_conv_aux.numpy())


def test_mgrit_machine_pwm_nested_iteration(tmp_path):
    """Nested iteration runs every GetDP call with Flag_PWM 0, the cycle
    with the flag restored, in both packages alike."""
    seen = {}
    for name, (app, solvers, dev) in MODS.items():
        env, log = _env(tmp_path, name)
        apps = [app.InductionMachine(**env, t_start=0.0, t_stop=0.8, nt=nt, pwm=1, **dev)
                for nt in (5, 3)]
        Path(log).write_text("")
        solver = solvers.MgritMachine(problem=apps, max_iter=1, tol=1e-12, logging_lvl=30,
                                      nested_iteration=True)
        nested = _calls(log)
        solver.solve()
        assert apps[0].fopt[-1] == 1 and apps[1].fopt[-1] == 1
        seen[name] = (nested, _calls(log))
    assert seen["torch"] == seen["jax"]
    (pre_n, nested), (_, both) = seen["torch"]
    assert nested and all(v == "0" for v in nested)
    assert all(v in ("1", "1.0") for v in both[len(nested):]) and len(both) > len(nested)


# ---------------------------------------------------------------------------
# two meshes: GridTransferMachine between the levels, a JAX state carried over
# ---------------------------------------------------------------------------

def _two_mesh_solver(name, tmp_path, max_iter):
    """``chip_smoke.two_mesh_machine`` in one package, its mocks and meshes
    in a directory of its own."""
    d = tmp_path / f"two_mesh_{name}_{max_iter}"
    d.mkdir()
    kws, path = chip_smoke.two_mesh_env(d)
    app, _, dev = MODS[name]
    gtm = j_gtm if name == "jax" else p_gtm
    return chip_smoke.two_mesh_machine((J if name == "jax" else P).Mgrit, app.InductionMachine,
                                       gtm.GridTransferMachine, kws, path, max_iter, **dev)


def _leaves_np(tubes):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tubes)]


def test_two_mesh_solve_and_carried_state(tmp_path):
    iters = chip_smoke.TWO_MESH_JAX.size
    mj = _two_mesh_solver("jax", tmp_path, iters)
    mp = _two_mesh_solver("torch", tmp_path, iters)
    # the port's row layout visits the leaves in JAX's order on each level
    for lvl, middle in ((0, 64), (1, 32)):
        assert mp._layouts[lvl].sizes == [15, 8, middle, 8]
        assert [x.shape[1:] for x in jax.tree_util.tree_leaves(mj.u[lvl])] == \
            [(15,), (8,), (middle,), (8,)]
    hj, hp = np.asarray(mj.solve()["conv"]), np.asarray(mp.solve()["conv"])
    assert hp.shape == hj.shape == chip_smoke.TWO_MESH_JAX.shape
    np.testing.assert_allclose(hp, hj, rtol=H_RTOL, atol=0)
    np.testing.assert_allclose(hj, chip_smoke.TWO_MESH_JAX, rtol=H_RTOL, atol=0)
    for lvl in (0, 1):
        for a, b in zip(_leaves_np(mp.u[lvl]), _leaves_np(mj.u[lvl])):
            np.testing.assert_allclose(a, b, rtol=CARRY_RTOL, atol=CARRY_RTOL * np.max(np.abs(b)))

    # JAX's state into a fresh port solver, then one more iteration in both
    fresh = _two_mesh_solver("torch", tmp_path, 1)
    state_from_numpy(fresh, _leaves_np(mj._get_state()))
    for lvl in (0, 1):
        for a, b in zip(_leaves_np(fresh.u[lvl]), _leaves_np(mj.u[lvl])):
            np.testing.assert_array_equal(a, b)
    for mg in (fresh, mj):
        mg.iter_max, mg.conv = 1, np.zeros(2)
    cj, cp = np.asarray(mj.solve()["conv"]), np.asarray(fresh.solve()["conv"])
    np.testing.assert_allclose(cp, cj, rtol=CARRY_RTOL, atol=0)
    for lvl in (0, 1):
        for a, b in zip(_leaves_np(fresh.u[lvl]), _leaves_np(mj.u[lvl])):
            np.testing.assert_allclose(a, b, rtol=CARRY_RTOL, atol=CARRY_RTOL * np.max(np.abs(b)))
