"""The pencil exchange of a space shard: a batch of 2D arrays held as row
slabs (each shard some rows, all columns) becomes column slabs (each shard
some columns, all rows) and back, over the space group's ``all_to_all``.

A space shard's solve with a separable basis (Heat2D's sine transforms,
the periodic models' Hartley transform) applies the basis along y to the
rows it holds, changes to columns, applies it along x to the columns,
changes back and applies it along y again (``models/heat_2d.py``
``_Pencil``, ``models/periodic_newton.py`` ``_PeriodicSlab``).  JAX's GSPMD
inserts the same all-to-alls for the dense products of a state split over
'space'.

Shard t holds ``rows[t]`` rows from row ``roff[t]`` on (the splits may be
uneven: a physical Heat2D level's interior rows) and, between the passes,
the columns [c0[t], c0[t + 1]).  Each shard's values travel in one
``all_to_all`` each way (``Comm.all_to_all``, uneven splits), packed by
destination in the receiver's layout.
"""

from __future__ import annotations

import torch


class PencilExchange:
    """The row <-> column slab exchange of shard s (module docstring) over
    ``comm`` (the space group's ``Comm``)."""

    def __init__(self, comm, s: int, rows, roff, c0):
        self.comm, self.s = comm, s
        self.rows, self.roff, self.c0 = list(rows), list(roff), list(c0)
        self.cols = [self.c0[t + 1] - self.c0[t] for t in range(len(self.rows))]
        self.nrows = sum(self.rows)

    def to_cols(self, y, J):
        """(J * rows, columns) rows of J arrays -> (J * columns, rows): each
        array's columns of this shard's slab, whole in x."""
        s, nt = self.s, len(self.cols)
        rm, cm = self.rows[s], self.cols[s]
        y3 = y.view(J, rm, -1)
        send = torch.empty(y.numel(), dtype=y.dtype, device=y.device)
        sizes, off = [], 0
        for t in range(nt):
            k = J * self.cols[t] * rm
            send[off:off + k].view(J, self.cols[t], rm).copy_(
                y3[:, :, self.c0[t]:self.c0[t + 1]].transpose(1, 2))
            sizes.append(k)
            off += k
        recv = self.comm.all_to_all(send, sizes, [J * cm * self.rows[t] for t in range(nt)])
        del send
        X = torch.empty((J, cm, self.nrows), dtype=y.dtype, device=y.device)
        off = 0
        for t in range(nt):
            k = J * cm * self.rows[t]
            X[:, :, self.roff[t]:self.roff[t] + self.rows[t]] = recv[off:off + k].view(
                J, cm, self.rows[t])
            off += k
        return X.view(J * cm, -1)

    def to_rows(self, X, J):
        """The inverse of ``to_cols``: (J * columns, rows) -> (J * rows,
        columns)."""
        s, nt = self.s, len(self.cols)
        rm, cm = self.rows[s], self.cols[s]
        X3 = X.view(J, cm, -1)
        send = torch.empty(J * cm * self.nrows, dtype=X.dtype, device=X.device)
        sizes, off = [], 0
        for t in range(nt):
            k = J * cm * self.rows[t]
            send[off:off + k].view(J, cm, self.rows[t]).copy_(
                X3[:, :, self.roff[t]:self.roff[t] + self.rows[t]])
            sizes.append(k)
            off += k
        recv = self.comm.all_to_all(send, sizes, [J * self.cols[t] * rm for t in range(nt)])
        del send
        Y = torch.empty((J, rm, self.c0[-1]), dtype=X.dtype, device=X.device)
        off = 0
        for t in range(nt):
            k = J * self.cols[t] * rm
            Y[:, :, self.c0[t]:self.c0[t + 1]] = recv[off:off + k].view(
                J, self.cols[t], rm).transpose(1, 2)
            off += k
        return Y.view(J * rm, -1)
