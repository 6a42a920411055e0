"""The host side of the FP64 product tile (``csrc/dmma_tile.cuh``) that K20
``sine_solve1d``, K22 ``eig_step`` and K26 ``dd_matmul`` share: the plan of
one product launch, picked from its shapes alone, and the copy width an
operand allows.

A product ``C[z] = A[z] B[z]`` of (M x K) by (K x N) runs as a grid of
``BM x BN`` tiles, each walking its slice of the inner index through a ring
of ``stages`` k-tiles of ``BK`` in shared memory.  Two regimes:

* **skinny** -- at most ``SKINNY_MAX`` rows on the short side (the lanes of
  K22, Diffusion2D's DD rows).  Such a product does (short side) / 4 FP64
  operations a table byte, below the H100's ridge of about 20 (67 TFLOP/s
  over 3.35 TB/s) up to about 80 lanes, so it is bound by streaming the long
  operand once.  The long axis goes on the tile's M side (``swap`` when
  M < N) and the short side takes tiles 8 wide (two at 9-16 lanes);
* **wide** -- a 64 x 64 DMMA tile.

The threshold is the measured crossover: ``product_sweep.py`` launches K22
and K26's Diffusion2D table on both regimes at 1-256 lanes x 2400, and on
an H100 SXM the skinny tile is the faster up to 16 lanes (K22 0.0953 ms
against 0.1162, K26 0.0623 against 0.0748, launches alone), the wide one
from 32 (0.0929 against 0.1427; 0.0753 against 0.1030); PERF.md has the
sweep.  Diffusion2D's coarsest march (1 lane) and its example's level 0
(8 lanes) take the skinny tile, its deep grid's level 0 (128 lanes) the
wide one.

Wherever the output tiles are fewer than ``2 * SMS`` the inner index is
split into slices of whole k-tiles (at least ``MIN_SLICE_KTILES`` each),
as many as one wave of resident blocks holds (the tile's register minimum
an SM, fewer where the ring's shared memory allows fewer); the slices'
partials go to a workspace of ``splits * batch * M * N`` values and a
second pass sums them in slice order.  A batch longer than one wave is
walked: each block takes several entries through one ring.
``copy_bytes`` gives the widest ``cp.async`` an operand's rows allow (16
bytes where every row start is 16-byte aligned).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

SMS = 132                  # H100 SXM
SMEM_PER_SM = 233472       # bytes; each block also takes 1024 of it
# (BM, BN, BK, stages, blocks an SM holds by registers: __launch_bounds__'s
# minimum), the instantiations of dmma_tile.cuh::product
SKINNY = (64, 8, 32, 3, 3)
WIDE = (64, 64, 16, 3, 3)
# K20's wide tile: k-tiles of 32 (half the barriers and waits of 16; it was
# the faster at 128 and 1024 lanes of 999 and 1023), two blocks an SM (its
# ring's shared memory)
K20_WIDE = (64, 64, 32, 3, 2)
TILES = (SKINNY, WIDE, K20_WIDE)
SKINNY_MAX = 16            # lanes; the crossover above
MIN_SLICE_KTILES = 4
ELEM_BYTES = {"float64": 8, "float32": 4, "dd": 4}


class Plan(NamedTuple):
    regime: str            # "skinny" or "wide"
    swap: bool             # the tile computes C^T = B^T A^T (the long axis on its M side)
    tile: tuple            # (BM, BN, BK)
    stages: int
    splits: int
    kps: int               # k-tiles a slice
    kslices: tuple         # ((k0, k1), ...) partitioning [0, K) in order
    copy: tuple            # cp.async bytes of the tile's A and B operands
    kmajor: tuple          # whether each stages along K (else along its rows)
    zblocks: int           # blocks walking the batch, each through one ring
    blocks: int
    workspace: int         # partial values (0 without a split)
    smem: int              # dynamic shared memory of a block, bytes

    def launch_args(self) -> tuple:
        """The plan's ten int64 values as the C launchers take them."""
        return (int(self.swap), *self.tile, self.stages, self.splits, self.kps, *self.copy,
                self.zblocks)

    def describe(self) -> str:
        bm, bn, bk = self.tile
        return (f"{self.regime} {bm}x{bn}x{bk} stages {self.stages} splits {self.splits}"
                f"{' swap' if self.swap else ''} copy {self.copy[0]}/{self.copy[1]} B "
                f"blocks {self.blocks}"
                + (f" walking {self.zblocks}" if self.zblocks > 1 else "")
                + f" smem {self.smem} B")


def copy_bytes(ptrs, strides, sizes, elsize: int) -> tuple:
    """(bytes, kmajor): the widest cp.async (16, 8 or 4 bytes; at least one
    element) that copies an operand's tile rows, and whether it stages along
    the inner index.  strides, sizes: (batch, rows, inner) in elements;
    ptrs: the data pointers (hi and lo of a DD pair).  A copy runs along
    the unit-stride axis (the inner index where both are), so it needs every
    pointer and every other stride (of an axis longer than 1) aligned to
    its width; with no unit-stride axis it copies one element."""
    sb, smn, sk = strides
    batch, mn, k = sizes
    kmajor = sk == 1 or smn != 1
    if (sk if kmajor else smn) != 1:
        return elsize, kmajor
    others = [s for s, n in ((sb, batch), (smn if kmajor else sk, mn if kmajor else k)) if n > 1]
    for w in (16, 8):
        if w >= elsize and all(p % w == 0 for p in ptrs) and all(s * elsize % w == 0
                                                                 for s in others):
            return w, kmajor
    return elsize, kmajor


def _ld_mn(extent: int, elsize: int) -> int:
    return extent + 4 if elsize == 8 else (extent + 8 if extent % 16 == 0 else extent)


def _tile_bytes(extent: int, bk: int, kmajor: bool, elsize: int) -> int:
    return elsize * (extent * (bk + 4) if kmajor else bk * _ld_mn(extent, elsize))


def product_plan(batch: int, M: int, N: int, K: int, dtype: str, a=(16, True),
                 b=(16, True)) -> Plan:
    """The plan of C = A B for (batch, M, K) by (batch, K, N) operands of
    ``dtype`` ("float64", "float32" or "dd"); a and b are ``copy_bytes`` of
    A (its rows M, inner K) and of B^T (rows N, inner K)."""
    return _product_plan(batch, M, N, K, dtype, a, b, None)


def lanes_regime(B: int, n: int) -> str:
    """K20's regime: the skinny tile up to SKINNY_MAX lanes, and wherever
    one skinny k-tile holds the whole inner index (n <= its BK: a 64 x 64
    tile would be mostly empty and the product is launch latency); the wide
    tile otherwise."""
    return "skinny" if B <= SKINNY_MAX or n <= SKINNY[2] else "wide"


def lanes_plan(B: int, n: int, dtype: str, table=(16, True), lanes=(16, True),
               comps: int = 1) -> Plan:
    """K20's plan of one product C^T = S L^T of B lanes of n values with the
    (n x n) table S: S on the tile's M side and the lanes on its N side
    whatever their counts (never swapped: the lanes' right-hand side is
    formed on the tile's B operand), the regime ``lanes_regime``'s.  table
    and lanes are ``copy_bytes`` of S and of the lanes (the narrowest of
    their components'); comps is the lane components staged in a slot (1,
    or 2 and 3 where the first product forms BE's and BDF2's right-hand
    side)."""
    return _product_plan(1, n, B, n, dtype, table, lanes, lanes_regime(B, n), False, comps,
                         K20_WIDE)


@lru_cache(maxsize=512)
def _product_plan(batch, M, N, K, dtype, a, b, regime, swap=None, bcomps=1,
                  wide=WIDE) -> Plan:
    """product_plan() on the given regime ("skinny" or "wide"; None picks
    it from the shapes; ``product_sweep.py`` times both); swap None swaps
    where M < N; bcomps: the components of B staged (K20's lanes); wide:
    the wide tile (K20's compiled for fewer blocks an SM)."""
    elsize = ELEM_BYTES[dtype]
    if swap is None:
        swap = M < N
    m, n = (N, M) if swap else (M, N)
    ca, cb = (b, a) if swap else (a, b)
    if regime is None:
        regime = "skinny" if n <= SKINNY_MAX else "wide"
    bm, bn, bk, stages, minb = SKINNY if regime == "skinny" else wide
    comps = 2 if dtype == "dd" else 1
    ta = comps * _tile_bytes(bm, bk, ca[1], elsize)      # one k-tile of each operand
    tb = comps * bcomps * _tile_bytes(bn, bk, cb[1], elsize)
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    kt = math.ceil(K / bk)

    # K20's lane coefficients (static shared memory) where it forms its rhs
    fixed = 1024 + (2 * bn * elsize if bcomps > 1 else 0)

    def slots(smem):                  # one wave of resident blocks
        return SMS * min(minb, SMEM_PER_SM // (smem + fixed))

    smem = stages * (ta + tb)
    splits, kps = 1, kt
    if 0 < batch * tiles < 2 * SMS and kt >= 2 * MIN_SLICE_KTILES:
        want = min(max(slots(smem) // (batch * tiles), 1), kt // MIN_SLICE_KTILES)
        kps = math.ceil(kt / want)
        splits = math.ceil(kt / kps)
    kslices = tuple((s * kps * bk, min(K, (s + 1) * kps * bk)) for s in range(splits))
    if dtype == "dd" and splits == 1:     # the output tile's staging rows
        smem += 4 * bm * (bn + 1)
    # a batch longer than one wave holds is walked: each block takes
    # ceil(batch * tiles * splits / slots) entries in turn
    per = max(1, math.ceil(batch * tiles * splits / slots(smem))) if batch else 1
    zblocks = max(1, math.ceil(batch / per))
    return Plan(regime, swap, (bm, bn, bk), stages, splits, kps, kslices, (ca[0], cb[0]),
                (ca[1], cb[1]), zblocks, tiles * splits * zblocks,
                splits * batch * m * n if splits > 1 else 0, smem)


def workspace(plan: Plan, dtype: torch.dtype, device, lead: int = 0) -> torch.Tensor:
    """One buffer of ``lead`` values (a wrapper's own scratch) followed by
    the partials of a split plan (``splits * batch * M * N`` values of the
    accumulator type), or None where both are empty."""
    n = lead + (plan.workspace if plan.splits > 1 else 0)
    return torch.empty(n, dtype=dtype, device=device) if n else None
