"""Port parity: the partition arithmetic (``core/partition.py``) and
``MgritWithPlots`` (``utils/plots.py``), against ``pymgrit_tpu``.

``split_into``, ``split_points`` and ``rank_partition`` are numpy in both
packages: every field of every rank's view equals the JAX package's, for
nt in {9, 33, 101, 129} on one to eight ranks.  The three plots write
non-empty files, and the lines they draw (read from the figure before it
is shown) equal the JAX package's: the distribution and cycle plots
exactly, the convergence plot's history at rtol 1e-10 with the float64
floor (8 + 4 sqrt(n)) eps ||u_C||_2 as atol.  matplotlib is needed for the
plots (``pytest.importorskip``); the partition tests run without it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core import partition as j_part
from pymgrit_tpu_torch.core import partition as p_part

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps


def _grids(nt):
    """A three-level hierarchy of nt points (coarsening 2, then 4 where it
    divides), as simple_setup_problem builds them."""
    t = np.linspace(0, 1, nt)
    grids = [t, t[::2]]
    if (grids[1].size - 1) % 4 == 0:
        grids.append(grids[1][::4])
    return grids


@pytest.mark.parametrize("nt", [9, 33, 101, 129])
def test_split_equal_jax(nt):
    for ranks in range(1, 9):
        np.testing.assert_array_equal(p_part.split_into(nt, ranks), j_part.split_into(nt, ranks))
        for rank in range(ranks):
            a, b = p_part.split_points(nt, ranks, rank), j_part.split_points(nt, ranks, rank)
            assert a == b and [type(x) for x in a] == [type(x) for x in b]


@pytest.mark.parametrize("nt", [9, 33, 101, 129])
def test_rank_partition_equal_jax(nt):
    grids = _grids(nt)
    for ranks in range(1, 9):
        for rank in range(ranks):
            for vp, vj in zip(p_part.rank_partition(grids, ranks, rank),
                              j_part.rank_partition(grids, ranks, rank)):
                for f in dataclasses.fields(vj):
                    a, b = getattr(vp, f.name), getattr(vj, f.name)
                    if isinstance(b, np.ndarray):
                        assert a.dtype == b.dtype, f.name
                        np.testing.assert_array_equal(a, b, err_msg=f.name)
                    else:
                        assert a == b and type(a) is type(b), f.name


def test_split_golden():
    """The reference's golden values (tests/core/test_mgrit.py:33-57)."""
    np.testing.assert_equal(p_part.split_into(10, 3), np.array([4, 3, 3]))
    assert p_part.split_points(10, 3, 0) == (4, 0)
    assert p_part.split_points(10, 3, 1) == (3, 4)
    assert p_part.split_points(10, 3, 2) == (3, 7)


def _solver(mod):
    from pymgrit_tpu.utils.plots import MgritWithPlots as JaxPlots
    from pymgrit_tpu_torch.utils.plots import MgritWithPlots as TorchPlots
    extra = {"device": "cpu"} if mod is P else {}
    cls = TorchPlots if mod is P else JaxPlots
    m = cls(problem=mod.simple_setup_problem(
        problem=mod.Dahlquist(t_start=0, t_stop=5, nt=101, **extra), level=3, coarsening=2),
        tol=1e-10, cycle_type='F', logging_lvl=30)
    m.solve()
    return m


def test_plots_write_files(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use('Agg')
    m = _solver(P)
    paths = [tmp_path / name for name in ("conv.png", "dist.png", "cycle.png")]
    m.plot_convergence(save_name=str(paths[0]))
    m.plot_parallel_distribution(time_procs=4, save_name=str(paths[1]))
    m.plot_cycle(iterations=1, save_name=str(paths[2]))
    for p in paths:
        assert p.exists() and p.stat().st_size > 0


def _drawn(monkeypatch, m, method, **kw):
    """The lines a plot draws: (x, y, marker, color) of each, read when the
    plot shows its figure."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    lines = []

    def show():
        fig = plt.gcf()
        for ax in fig.axes:
            for ln in ax.get_lines():
                lines.append((np.asarray(ln.get_xdata(), dtype=np.float64),
                              np.asarray(ln.get_ydata(), dtype=np.float64),
                              ln.get_marker(), ln.get_color()))
        plt.close(fig)
    monkeypatch.setattr(plt, "show", show)
    getattr(m, method)(**kw)
    assert lines
    return lines


@pytest.mark.parametrize("method,kw", [("plot_parallel_distribution", dict(time_procs=4)),
                                       ("plot_parallel_distribution", dict(time_procs=7)),
                                       ("plot_cycle", dict(iterations=2)),
                                       ("plot_convergence", {})],
                         ids=["distribution-4", "distribution-7", "cycle", "convergence"])
def test_plotted_lines_equal_jax(monkeypatch, method, kw):
    mp, mj = _solver(P), _solver(J)
    lp, lj = _drawn(monkeypatch, mp, method, **kw), _drawn(monkeypatch, mj, method, **kw)
    assert len(lp) == len(lj)
    u_c = mp.u[0][torch.as_tensor(mp.levels[0].cpts)]
    floor = (8 + 4 * np.sqrt(u_c[0].numel())) * EPS * float(torch.linalg.vector_norm(u_c))
    for (xp, yp, mkp, cp), (xj, yj, mkj, cj) in zip(lp, lj):
        assert (mkp, str(cp)) == (mkj, str(cj))
        np.testing.assert_array_equal(xp, xj)
        if method == "plot_convergence":
            np.testing.assert_allclose(yp, yj, rtol=1e-10, atol=floor)
        else:
            np.testing.assert_array_equal(yp, yj)
