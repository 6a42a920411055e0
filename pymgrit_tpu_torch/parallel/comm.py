"""The sharded executor's communicating operations, over one
``torch.distributed`` process group (one ``Comm`` a group: the time axis's,
and the space axis's where the mesh has one).

``pymgrit_tpu``'s executor runs inside ``shard_map`` and communicates with
``ppermute``, masked ``psum`` broadcasts, ``psum`` / ``pmax`` and
``all_gather``.  Here each time shard is a process and ``Comm`` gives the
same four operations:

* ``shift(x)``: rank r sends x to rank r + 1 and receives rank r - 1's x
  (``batch_isend_irecv``); rank 0 receives zeros (``ppermute`` with the
  permutation [(i, i + 1)]);
* ``broadcast(x, src)``: the owner's value on every rank (the masked
  ``psum``: adding zeros is exact, so the bits are the owner's);
* ``all_reduce(x, op)``: the sum or the maximum over ranks (``psum``,
  ``pmax``);
* ``all_gather(x)``: the ranks' slabs concatenated on axis 0 in rank order
  (``all_gather(tiled=True)``).

The space axis has no ``shard_map`` counterpart (GSPMD inserts its
collectives); its group takes ``all_reduce`` and ``all_gather`` and two
operations of its own:

* ``all_to_all(x, send, recv)``: rank r sends x's ``send[q]`` values after
  the first ``sum(send[:q])`` to rank q and receives ``recv[q]`` values
  from each rank q, in rank order (``all_to_all_single`` with uneven
  splits; the pencil transforms' change between row and column slabs);
* ``row_halo(first, last, periodic=False)``: rank r sends ``first`` to rank
  r - 1 and ``last`` to rank r + 1 and receives rank r - 1's ``last`` and
  rank r + 1's ``first`` (a stencil's ghost rows): zeros at the ends, or,
  ``periodic``, around the ring (rank 0's r - 1 is the last rank).  At two
  ranks both neighbours are one process: each direction has its own tag,
  and the operations are issued so that a backend that matches a pair's
  messages in order (NCCL) pairs them alike.

Two reductions serve a space shard's Krylov loops: ``all_reduce`` of
several per-lane values stacked into one tensor (one collective for all),
and ``nan_max(x)``, the largest of non-negative values over ranks with a
NaN on any rank giving NaN, as ``jnp.max`` does: the values' bit patterns
reduce as integers under MAX (a float MAX does not promise to keep NaN).

The route is fixed when the ``Comm`` is built, from the group's backend and
the tensors' device, never on an error: NCCL takes CUDA tensors as they
are, gloo takes CPU tensors as they are, and gloo with CUDA tensors copies
them into pinned host buffers, communicates and copies back (PyTorch's gloo
moves CUDA tensors for ``broadcast`` and ``all_reduce`` only, so one staging
route serves them all).  NCCL refuses two ranks on one GPU: a world of
several ranks on one card runs gloo with staging.

``counts`` holds the operations, the bytes moved and the bytes staged
through the host by this rank.  The bytes moved are the payload this rank
sends and receives: ``shift`` the state sent plus the state received,
``broadcast`` and ``all_reduce`` the tensor, ``all_gather`` the gathered
tensor, ``all_to_all`` and ``row_halo`` what goes to and comes from the
other ranks.  The bytes staged are the device-to-host plus host-to-device
copies.  A world of one moves nothing (its collectives still run).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# row_halo's tags: the row sent towards rank r - 1, and towards r + 1
_TAG_UP, _TAG_DOWN = 1, 2


class Comm:
    """The collectives of one process group (the default group where
    ``group`` is None) for tensors on ``device``."""

    def __init__(self, group, device):
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(self.group))
        on_cuda = self.device.type == "cuda"
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {self.backend!r}: the executor takes nccl or gloo")
        if self.backend == "nccl" and not on_cuda:
            raise ValueError("an NCCL group communicates CUDA tensors; the solver's tensors are on "
                             f"{self.device}")
        self.staged = self.backend == "gloo" and on_cuda
        # point-to-point operations and broadcast sources address global ranks
        self._ranks = list(dist.get_process_group_ranks(self.group))
        self._prev = self._ranks[self.rank - 1] if self.rank > 0 else None
        self._next = self._ranks[self.rank + 1] if self.rank + 1 < self.size else None
        # the ring's neighbours (the periodic row halo)
        self._ring = (self._ranks[(self.rank - 1) % self.size],
                      self._ranks[(self.rank + 1) % self.size])
        self.reset_counts()

    def reset_counts(self) -> None:
        self.counts = {"ops": 0, "bytes": 0, "staged": 0}

    def _count(self, moved: int, staged: int) -> None:
        self.counts["ops"] += 1
        self.counts["bytes"] += moved if self.size > 1 else 0
        self.counts["staged"] += staged if self.staged else 0

    def _buffer(self, x, fill=True):
        """What the backend communicates for x: a pinned host copy (of x's
        values where ``fill``) on the staging route, else x made
        contiguous."""
        if not self.staged:
            return x.contiguous()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        if fill:
            h.copy_(x)
        return h

    @staticmethod
    def _nbytes(x) -> int:
        return x.numel() * x.element_size()

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Rank r - 1's x (zeros on rank 0), as a fresh tensor."""
        out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        nb = self._nbytes(x)
        ops = []
        if self._next is not None:
            ops.append(dist.P2POp(dist.isend, self._buffer(x), self._next, self.group))
        recv = None
        if self._prev is not None:
            recv = self._buffer(out, fill=False)
            ops.append(dist.P2POp(dist.irecv, recv, self._prev, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if recv is not None and recv is not out:
            out.copy_(recv)
        moved = nb * len(ops)
        self._count(moved, moved)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank src's x on every rank, written into x (returned); on the
        other ranks x is only a buffer of the right shape."""
        nb = self._nbytes(x)
        buf = self._buffer(x, fill=self.rank == src)
        dist.broadcast(buf, src=self._ranks[src], group=self.group)
        if buf is not x and self.rank != src:
            x.copy_(buf)
        self._count(nb, nb)
        return x

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum or maximum of x over ranks, written into x (returned)."""
        nb = self._nbytes(x)
        buf = self._buffer(x)
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        if buf is not x:
            x.copy_(buf)
        self._count(nb, 2 * nb)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size * n, ...) from every rank's (n, ...) x, in rank order."""
        shape = (self.size * x.shape[0],) + tuple(x.shape[1:])
        buf = self._buffer(x)
        out = torch.empty(shape, dtype=x.dtype, device=buf.device, pin_memory=self.staged)
        dist.all_gather_into_tensor(out, buf, group=self.group)
        nb = self._nbytes(out)
        if self.staged:
            out = out.to(self.device)
        self._count(nb, nb + self._nbytes(x))
        return out

    def all_to_all(self, x: torch.Tensor, send, recv) -> torch.Tensor:
        """The 1-D concatenation, in rank order, of the ``recv[q]`` values
        each rank q sends this rank; x is the 1-D concatenation of the
        ``send[q]`` values for each rank q (split sizes in values, the same
        on both sides of each pair)."""
        send, recv = [int(n) for n in send], [int(n) for n in recv]
        buf = self._buffer(x)
        out = torch.empty(sum(recv), dtype=x.dtype, device=buf.device, pin_memory=self.staged)
        dist.all_to_all_single(out, buf, recv, send, group=self.group)
        if self.staged:
            out = out.to(self.device)
        es = x.element_size()
        moved = es * (sum(send) - send[self.rank] + sum(recv) - recv[self.rank])
        self._count(moved, es * (sum(send) + sum(recv)))
        return out

    def nan_max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest |x| over ranks, elementwise, as a fresh tensor: NaN
        where any rank's x holds a NaN (float64 or float32)."""
        bits = x.abs()             # clears the sign bit: the bit patterns order as the values
        wide = (bits.view(torch.int64) if x.dtype == torch.float64
                else bits.view(torch.int32).to(torch.int64))
        self.all_reduce(wide, "max")
        return (wide.view(torch.float64) if x.dtype == torch.float64
                else wide.to(torch.int32).view(torch.float32))

    def row_halo(self, first: torch.Tensor, last: torch.Tensor, periodic: bool = False):
        """(rank r - 1's ``last``, rank r + 1's ``first``) as fresh tensors;
        ``first`` goes to rank r - 1 and ``last`` to rank r + 1.  Past the
        ends: zeros, or, ``periodic``, the ring's other end."""
        above = torch.zeros(last.shape, dtype=last.dtype, device=last.device)
        below = torch.zeros(first.shape, dtype=first.dtype, device=first.device)
        prev, nxt = self._ring if periodic else (self._prev, self._next)
        sends, recvs = [], []
        # sends towards r + 1 before those towards r - 1, receives from r - 1
        # before those from r + 1: where one process is both neighbours,
        # in-order matching pairs last with above and first with below
        if nxt is not None:
            sends.append(dist.P2POp(dist.isend, self._buffer(last), nxt, self.group, _TAG_DOWN))
        if prev is not None:
            sends.append(dist.P2POp(dist.isend, self._buffer(first), prev, self.group, _TAG_UP))
            recvs.append((above, self._buffer(above, fill=False), prev, _TAG_DOWN))
        if nxt is not None:
            recvs.append((below, self._buffer(below, fill=False), nxt, _TAG_UP))
        ops = sends + [dist.P2POp(dist.irecv, buf, src, self.group, tag)
                       for _, buf, src, tag in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for dst, buf, _, _ in recvs:
            if buf is not dst:
                dst.copy_(buf)
        moved = self._nbytes(first) * len(ops)
        self._count(moved, moved)
        return above, below
