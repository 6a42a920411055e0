"""AT-MGRIT: asynchronous-truncated coarsest-level solves.

Counterpart of ``pymgrit_tpu/core/at_mgrit.py`` (the reference's
"distance-k" algorithm of Hahne et al.): instead of the sequential
coarsest-grid forward solve, every coarsest point p re-integrates only its
own window, from the snapshot value at ``max(0, p-k+1)`` through at most k-1
steps ``x <- g_i + Phi_i(x)``.

Where the coarsest application has ``affine_coeffs`` (Dahlquist, the
spectral heat models), one launch of kernel K9 ``affine_windows`` computes
every window.  Any other application runs k-1 masked steps of its batched
step over all nt lanes, as the JAX package does (physical Heat2D: K7 + K5
per step).
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.solver import Mgrit, _rows


class AtMgrit(Mgrit):
    """MGRIT variant with truncated local coarse grids (distance k)."""

    def __init__(self, k: int, conv_crit: int = 0, *args, **kwargs):
        self.k = k
        if conv_crit not in [0, 1]:
            raise Exception(
                'Local convergence criteria are not implemented for AT-MGRIT. Please select a global criterion.')
        super().__init__(conv_crit=conv_crit, *args, **kwargs)

    def _forward_solve(self, lvl, u, g):
        """Truncated local solves on the coarsest level of a hierarchy.
        Lanes read each other's window starts, so the windows are computed
        into a fresh buffer and then copied into u."""
        if lvl != self.lvl_max - 1 or self.lvl_max == 1:
            return super()._forward_solve(lvl, u, g)
        nt = self.levels[lvl].nt
        out = torch.empty_like(u)
        if getattr(self.problem[lvl], "affine_coeffs", None) is not None:
            A, b = self._affine_rows(lvl, u[1:nt].shape)
            self.ops.affine_windows(_rows(u), A, b, _rows(g)[1:nt], _rows(out), self.k)
        else:
            self._masked_windows(lvl, u, g, out)
        u.copy_(out)
        return u

    def _masked_windows(self, lvl, u, g, out):
        """k-1 masked steps over all lanes: lane p starts from
        u[max(0, p-k+1)] and steps x <- g[i] + Phi(x) while i <= p."""
        t = self.levels[lvl].t
        nt = t.size
        pts = np.arange(nt)
        window_start = np.maximum(0, pts - self.k + 1)
        active_shape = (nt,) + (1,) * (u.dim() - 1)
        x = u[torch.as_tensor(window_start, device=u.device)]
        for s in range(1, min(self.k, nt)):
            idx = np.minimum(window_start + s, nt - 1)
            stepped = torch.empty_like(x)
            self._chain(lvl, x, t[idx - 1][None], t[idx][None], stepped[:, None],
                        g[torch.as_tensor(idx, device=u.device)][:, None])
            active = torch.as_tensor(window_start + s <= pts, device=u.device)
            x = torch.where(active.view(active_shape), stepped, x)
        out.copy_(x)
