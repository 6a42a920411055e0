"""Port parity: host-side setup (levels, hierarchy, validation) and the
port's import hygiene.

The level structure is pure numpy in both packages, so every field must be
EQUAL (no tolerance); validation messages must be the same strings.
"""

import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core.levels import build_level_infos as j_build
from pymgrit_tpu_torch.core.levels import build_level_infos as p_build

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


_GRIDS = {
    "uniform_2lvl": [np.linspace(0, 5, 101), np.linspace(0, 5, 101)[::2]],
    "uniform_3lvl": [np.linspace(0, 1, 129), np.linspace(0, 1, 129)[::4],
                     np.linspace(0, 1, 129)[::16]],
    "toms_5lvl": [np.linspace(0, 1, 16385)[::s] for s in (1, 32, 512, 2048, 8192)],
    "nonuniform": [np.linspace(0, 1, 11), np.linspace(0, 1, 11)[[0, 1, 4, 10]]],
    "single": [np.linspace(0, 1, 17)],
}


def _fields_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if hasattr(x, "__dataclass_fields__"):
            _fields_equal(x, y)
        elif x is None or y is None:
            assert x is None and y is None, f
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)


@pytest.mark.parametrize("name", sorted(_GRIDS))
def test_build_level_infos_equal(name):
    for a, b in zip(j_build(_GRIDS[name]), p_build(_GRIDS[name])):
        _fields_equal(a, b)


@pytest.mark.parametrize("level,coarsening", [(2, 2), (3, 2), (4, 4)])
def test_simple_setup_problem_equal(level, coarsening):
    pj = J.simple_setup_problem(J.Dahlquist(t_start=0, t_stop=5, nt=101), level, coarsening)
    pp = P.simple_setup_problem(P.Dahlquist(t_start=0, t_stop=5, nt=101, device="cpu"), level,
                                coarsening)
    assert len(pj) == len(pp) == level
    for a, b in zip(pj, pp):
        np.testing.assert_array_equal(a.t, b.t)
        assert (a.t_start, a.t_end, a.nt) == (b.t_start, b.t_end, b.nt)


def test_simple_setup_problem_warns_alike():
    msgs = []
    for mod in (J, P):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            mod.simple_setup_problem(mod.Dahlquist(t_start=0, t_stop=1, nt=5, **_cpu(mod)), 3, 4)
        msgs.append([str(w.message) for w in rec])
    assert msgs[0] == msgs[1] and msgs[0]


_BAD_KWARGS = [dict(cycle_type='X'), dict(t_norm=4), dict(conv_crit=5),
               dict(output_lvl=7), dict(cf_iter=[]), dict(cf_iter=1.5)]


def _error(fn):
    with pytest.raises(Exception) as exc:
        fn()
    return type(exc.value).__name__, str(exc.value)


@pytest.mark.parametrize("kw", _BAD_KWARGS, ids=lambda kw: next(iter(kw)) + "=" + repr(next(iter(kw.values()))))
def test_validation_messages_equal(kw):
    errs = [_error(lambda: mod.Mgrit(problem=mod.simple_setup_problem(
        mod.Dahlquist(t_start=0, t_stop=5, nt=101, **_cpu(mod)), 2, 2), logging_lvl=30, **kw))
        for mod in (J, P)]
    assert errs[0] == errs[1]


def test_hierarchy_validation_messages_equal():
    for grids in ([np.linspace(0, 1, 11), np.linspace(0, 1, 7)],
                  [np.linspace(0, 1, 5), np.linspace(0, 1, 9)]):
        errs = []
        for mod in (J, P):
            problem = [mod.Dahlquist(t_interval=g, **_cpu(mod)) for g in grids]
            errs.append(_error(lambda: mod.Mgrit(problem=problem, logging_lvl=30)))
        assert errs[0] == errs[1]
    t = np.linspace(0, 1, 11)
    errs = [_error(lambda: mod.Mgrit(problem=[mod.Dahlquist(t_interval=t, **_cpu(mod))] * 2,
                                     transfer=[], logging_lvl=30)) for mod in (J, P)]
    assert errs[0] == errs[1]


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "A7"), (dict(lazy_f_relax=True), "not to port")])
def test_unported_options_raise(kw, item):
    problem = P.simple_setup_problem(P.Dahlquist(t_start=0, t_stop=5, nt=101, device="cpu"), 2, 2)
    with pytest.raises(NotImplementedError, match=item):
        P.Mgrit(problem=problem, logging_lvl=30, **kw)


def test_mesh_names_the_sharded_executor():
    """``Mgrit(mesh=...)`` points at the port's time-sharded executor and at
    the unported 'space' axis (ROADMAP A7b)."""
    problem = P.simple_setup_problem(P.Dahlquist(t_start=0, t_stop=5, nt=101, device="cpu"), 2, 2)
    with pytest.raises(NotImplementedError) as err:
        P.Mgrit(problem=problem, logging_lvl=30, mesh=object())
    assert "pymgrit_tpu_torch.parallel.ShardedMgrit" in str(err.value)
    assert "A7b" in str(err.value)


def test_import_leaves_jax_out():
    """The port and chip_smoke.py import no jax module and nothing of the
    JAX package, and the plots module no matplotlib (checked in a fresh
    interpreter: this test process has jax loaded already)."""
    code = ("import sys, torch; d = torch.get_default_dtype(); "
            "t32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32); "
            "import pymgrit_tpu_torch, pymgrit_tpu_torch.interop; "
            "import pymgrit_tpu_torch.ops.runge_kutta, pymgrit_tpu_torch.ops._build; "
            "import pymgrit_tpu_torch.core.partition, pymgrit_tpu_torch.coupling; "
            "import pymgrit_tpu_torch.utils.plots, pymgrit_tpu_torch.models.induction_machine; "
            "import pymgrit_tpu_torch.parallel, pymgrit_tpu_torch.parallel.shard_solver; "
            "sys.path.insert(0, 'tests'); import torch_shard_workers; "
            "import chip_smoke; "
            "bad = [m for m in sys.modules if m in ('jax', 'pymgrit_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'pymgrit_tpu.'))]; "
            "assert not bad, bad; assert 'triton' not in sys.modules; "
            "assert 'matplotlib' not in sys.modules; "
            "assert torch.get_default_dtype() == d; "
            "assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == t32; "
            "print('ok')")
    env = {"PATH": "/usr/bin:/bin", "PYTHONNOUSERSITE": "1"}
    out = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
                         env={**env, "PYTHONPATH": ":".join(p for p in sys.path if p)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


_MODELS = {
    "Heat2D": dict(x_start=0, x_end=1, y_start=0, y_end=1, nx=5, ny=5, a=1.0,
                   rhs=lambda x, y, t: 0 * x * y * t),
    "Heat1D": dict(x_start=0, x_end=1, nx=5, a=1.0, init_cond=lambda x: np.sin(np.pi * x)),
    "Dahlquist": {},
    "AllenCahn": dict(nx=8),
    "ArenstorfOrbit": {},
    "Brusselator": {},
    "GrayScott2D": dict(nx=8),
    "Burgers1D": dict(nx=8),
    "Burgers2D": dict(nx=8),
    "Advection1D": dict(c=1, x_start=-1, x_end=1, nx=9),
}


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_models_default_to_the_card_and_raise_without_one(model, monkeypatch):
    """With no device given a model builds on the CUDA card; without a CUDA
    device it raises instead of running on the CPU; device='cpu' asks for
    the CPU."""
    cls, kw = getattr(P, model), dict(_MODELS[model], t_start=0, t_stop=1, nt=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(**kw)
    app = cls(**kw, device="cpu")
    assert app.device == torch.device("cpu") and app.vector_t_start.device.type == "cpu"
