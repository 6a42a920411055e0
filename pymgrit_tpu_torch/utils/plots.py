"""Observability: convergence, distribution, and cycle plots.

Counterpart of ``pymgrit_tpu/utils/plots.py`` (reference
src/pymgrit/core/mgrit_with_plots.py:9-183): ``MgritWithPlots`` with
plot_convergence, plot_parallel_distribution and plot_cycle.  The
distribution plot reads the partition arithmetic of ``core/partition.py``
instead of live ranks, so any shard count can be drawn from one process.
Every plot reads host data only (``conv``, the numpy level grids).
matplotlib is imported inside each method: importing this module needs
none.
"""

from __future__ import annotations

import numpy as np

from pymgrit_tpu_torch.core.partition import rank_partition
from pymgrit_tpu_torch.core.solver import Mgrit


class MgritWithPlots(Mgrit):
    """MGRIT solver with plotting helpers."""

    def plot_convergence(self, save_name=None, fig_size_x=6.4, fig_size_y=4.8, dpi=100):
        import matplotlib.pyplot as plt

        conv = self.conv[np.where(self.conv != 0)]
        fig = plt.figure(figsize=(fig_size_x, fig_size_y), dpi=dpi)
        plt.semilogy(np.arange(1, len(conv) + 1), conv, 'o-')
        plt.xlabel('iteration')
        plt.ylabel('residual norm')
        plt.grid(True, which='both', alpha=0.3)
        if save_name is not None:
            plt.savefig(save_name, bbox_inches='tight')
            plt.close(fig)
        else:
            plt.show()

    def plot_parallel_distribution(self, time_procs: int, text_size: int = 9,
                                   save_name=None, fig_size_x=6.4, fig_size_y=4.8,
                                   dpi=100):
        """Time-point-to-shard distribution diagram (reference
        mgrit_with_plots.py:44-113), computed from partition arithmetic."""
        import matplotlib.pyplot as plt

        t_grids = [li.t for li in self.levels]
        fig = plt.figure(figsize=(fig_size_x, fig_size_y), dpi=dpi)
        colors = plt.cm.tab20(np.linspace(0, 1, max(time_procs, 2)))
        for rank in range(time_procs):
            views = rank_partition(t_grids, time_procs, rank)
            for lvl in range(self.lvl_max):
                v = views[lvl]
                owned = v.t_local[v.index_local] if v.index_local.size else np.array([])
                if owned.size:
                    plt.plot(owned, np.full(owned.size, -lvl), 'o',
                             color=colors[rank], markersize=4)
        for lvl in range(self.lvl_max):
            cpt_t = self.levels[lvl].t[self.levels[lvl].cpts] if self.levels[lvl].cpts is not None \
                else self.levels[lvl].t
            plt.plot(cpt_t, np.full(len(cpt_t), -lvl), 'k.', markersize=2)
        plt.yticks(-np.arange(self.lvl_max), [f'level {l}' for l in range(self.lvl_max)],
                   fontsize=text_size)
        plt.xlabel('time')
        plt.title(f'distribution over {time_procs} time shards')
        if save_name is not None:
            plt.savefig(save_name, bbox_inches='tight')
            plt.close(fig)
        else:
            plt.show()

    def plot_cycle(self, iterations: int = 1, save_name=None, fig_size_x=6.4,
                   fig_size_y=4.8, dpi=100):
        """Cycle-structure diagram (reference mgrit_with_plots.py:115-183):
        walk the same recursion as the solver and record level visits."""
        import matplotlib.pyplot as plt

        visits = []

        def walk(lvl, cycle_type, first_f):
            if lvl == self.lvl_max - 1:
                visits.append(lvl)
                return
            visits.append(lvl)
            walk(lvl + 1, cycle_type, True)
            visits.append(lvl)
            if lvl != 0 and cycle_type == 'F':
                walk(lvl, 'V', False)

        for _ in range(iterations):
            walk(0, self.cycle_type, True)

        fig = plt.figure(figsize=(fig_size_x, fig_size_y), dpi=dpi)
        plt.plot(np.arange(len(visits)), [-v for v in visits], 'o-', color='k',
                 markersize=5)
        plt.yticks(-np.arange(self.lvl_max), [f'level {l}' for l in range(self.lvl_max)])
        plt.xticks([])
        plt.title(f'{self.cycle_type}-cycle structure')
        if save_name is not None:
            plt.savefig(save_name, bbox_inches='tight')
            plt.close(fig)
        else:
            plt.show()
