"""1D and 2D spatial transfers between nested heat grids.

Counterpart of ``pymgrit_tpu/models/grid_transfer_heat.py``:

* ``GridTransferHeat`` (1D): full-weighting restriction [1/4, 1/2, 1/4] and
  linear interpolation between nested interior-point Dirichlet grids (fine
  n -> coarse (n - 1) / 2), the transfer of the reference's
  examples/example_spatial_coarsening.py;
* ``GridTransferHeat2D`` (2D): injection restriction and bilinear
  interpolation between nested vertex grids with their ring (fine 2n - 1 <->
  coarse n), the PETSc DMDA transfer of the reference's
  petsc/heat_2D_petsc.py; it matches the physical ``Heat2D`` state.

``restriction`` / ``interpolation`` compute JAX's values on the trailing
spatial axes, so they take one state, as in the JAX package, or a batch of
states; both classes declare ``batched = True`` and the solver hands them
whole tube views.  Both methods and the fused hooks ``restrict_combine`` /
``interpolate_combine`` (``core/grid_transfer.py``) run kernels K18 / K19
(``ops/transfer.py``) through the solver's kernel set.

A double-double state (``precision='dd'``, a ``DD`` pair) takes the DD
route, the JAX package's DD expressions through K25 ``dd_arith`` (the
kernel set of the state): restriction u[:-2:2]/4 + u[1:-1:2]/2 + u[2::2]/4
as one DD combine; interpolation's scatter-adds (ret[2i] += u[i]/2,
ret[2i+2] += u[i]/2) as DD sums of u[i]/2 and u[i-1]/2.  K18 and K19
take no DD state, and ``GridTransferHeat2D`` none at all, as the JAX
package's takes none.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.core.grid_transfer import GridTransfer
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops import dd as _dd
from pymgrit_tpu_torch.ops import transfer as _transfer


class _HeatTransfer(GridTransfer):
    batched = True
    _dim = 1

    def _apply(self, u, shape_of, run):
        """run(out, batch) on u as an (R, ...) batch of contiguous states;
        one state in, one state out."""
        one = u.dim() == self._dim
        x = _transfer.contiguous_states(u[None] if one else u)
        out = torch.empty((x.shape[0],) + shape_of(tuple(x.shape[1:]), self._dim),
                          dtype=x.dtype, device=x.device)
        run(out, x)
        return out[0] if one else out

    def restriction(self, u, ops: Ops = DISPATCH):
        """R(u) of one state or a (rows, ...) batch (K18; a DD state: K25)."""
        if isinstance(u, _dd.DD):
            return self._dd_restriction(u)
        return self._apply(u, _transfer.coarse_shape,
                           lambda out, x: ops.restrict_combine(out, [x], [1.0], dim=self._dim))

    def interpolation(self, u, ops: Ops = DISPATCH):
        """P(u) of one state or a (rows, ...) batch (K19; a DD state: K25)."""
        if isinstance(u, _dd.DD):
            return self._dd_interpolation(u)
        return self._apply(u, _transfer.fine_shape,
                           lambda out, x: ops.interpolate_combine(out, x, None, self._dim))

    def _dd_restriction(self, u):
        raise TypeError(f"{type(self).__name__} takes no double-double state")

    _dd_interpolation = _dd_restriction

    def restrict_combine(self, out, terms, coeffs, adds=(), add_coeffs=(), ops: Ops = DISPATCH):
        """out = R(sum_k coeffs[k] terms[k]) + sum_j add_coeffs[j] adds[j] (K18)."""
        return ops.restrict_combine(out, terms, coeffs, adds, add_coeffs, self._dim)

    def interpolate_combine(self, dst, a, b=None, ops: Ops = DISPATCH):
        """dst += P(a - b), or dst = P(a) without b (K19)."""
        return ops.interpolate_combine(dst, a, b, self._dim)


class GridTransferHeat(_HeatTransfer):
    """Full-weighting / linear-interpolation transfer for interior-point
    Dirichlet grids: ret[i] = u[2i]/4 + u[2i+1]/2 + u[2i+2]/4, and the
    scatter-adds ret[2i] += u[i]/2, ret[2i+1] = u[i], ret[2i+2] += u[i]/2."""

    _dim = 1

    @staticmethod
    def _dd_restriction(u):
        return u.ops.dd_arith("combine", u[..., :-2:2], u[..., 1:-1:2], u[..., 2::2],
                              coeffs=[0.25, 0.5, 0.25])

    @staticmethod
    def _dd_interpolation(u):
        n = u.shape[-1]
        lead = tuple(u.shape[:-1])
        out = _dd._raw(torch.empty(lead + (2 * n + 1,), dtype=u.dtype, device=u.device),
                       torch.empty(lead + (2 * n + 1,), dtype=u.dtype, device=u.device), u.ops)
        out.hi[..., 1::2] = u.hi
        out.lo[..., 1::2] = u.lo
        comb = u.ops.dd_arith
        comb("combine", u[..., :1], coeffs=[0.5], out=out[..., :1])
        comb("combine", u[..., 1:], u[..., :-1], coeffs=[0.5, 0.5], out=out[..., 2:-1:2])
        comb("combine", u[..., -1:], coeffs=[0.5], out=out[..., -1:])
        return out


class GridTransferHeat2D(_HeatTransfer):
    """Injection restriction / bilinear interpolation between nested 2D
    vertex-centered grids (boundary ring included), fine (2n-1) x (2m-1)
    <-> coarse n x m (DMDA ``createInjection`` / ``createInterpolation``):
    coarse[i, j] = fine[2i, 2j]."""

    _dim = 2

    def __init__(self, nx_fine: int, ny_fine: int):
        if nx_fine % 2 == 0 or ny_fine % 2 == 0:
            raise Exception(
                "GridTransferHeat2D needs odd fine dimensions (nested "
                "vertex-centered grids: fine = 2*coarse - 1); got "
                f"({nx_fine}, {ny_fine})")
        self.nx_fine = nx_fine
        self.ny_fine = ny_fine
        self.nx_coarse = (nx_fine + 1) // 2
        self.ny_coarse = (ny_fine + 1) // 2
