"""Static per-level grid structure for the MGRIT hierarchy.

A copy of ``pymgrit_tpu/core/levels.py`` (pure numpy, so the port does not
import the JAX package): C-/F-point classification by membership of the
coarser grid's time values in the finer grid and the grouping of F-points
into consecutive runs.  The runs are the batch axis of the relaxation
sweeps: all F-runs of a level relax at once.

Everything here is static host data computed once at solver setup.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class FChains:
    """Batched view of the F-point runs of one level.

    Run j starts at the F-point right after C-point ``seed[j]`` and contains
    ``lengths[j]`` F-points.  ``f_idx[j, s]`` is the global index of the s-th
    F-point of run j (padded with ``nt`` where s >= lengths[j], so masked
    scatters with mode='drop' ignore the padding).
    """

    seed: np.ndarray          # (J,) int — index of the C-point seeding each run
    lengths: np.ndarray       # (J,) int
    f_idx: np.ndarray         # (J, Lmax) int, padded with nt
    mask: np.ndarray          # (J, Lmax) bool
    t_prev: np.ndarray        # (J, Lmax) float — t of the predecessor of each F-point
    t_curr: np.ndarray        # (J, Lmax) float — t of each F-point
    lmax: int


@dataclasses.dataclass(frozen=True)
class CChains:
    """Runs of *adjacent* C-points for Gauss-Seidel-exact C-relaxation.

    The reference relaxes C-points in ascending index order
    (mgrit.py:356-368), so with non-uniform coarsening an adjacent C-point
    pair chains sequentially (u[i] uses the just-updated u[i-1]).  Runs of
    adjacent C-points therefore scan sequentially while distinct runs batch.
    With uniform coarsening m >= 2 every run has length 1 and the scan
    degenerates to one fully batched step."""

    c_idx: np.ndarray        # (K, Rmax) run C-point indices, padded with nt
    mask: np.ndarray         # (K, Rmax)
    t_prev: np.ndarray       # (K, Rmax)
    t_curr: np.ndarray       # (K, Rmax)
    seed_prev: np.ndarray    # (K,) predecessor index of the first run point
    rmax: int


@dataclasses.dataclass(frozen=True)
class LevelInfo:
    """Static structure of one time level."""

    lvl: int
    t: np.ndarray                 # (nt,) global time values of this level
    nt: int
    cpts: Optional[np.ndarray]    # (nc,) indices of C-points in this level's grid
    m: int                        # coarsening factor to next level (1 on coarsest)
    chains: Optional[FChains]     # None on the coarsest level
    c_chains: Optional[CChains]   # None on the coarsest level
    fpts: Optional[np.ndarray]    # (nf,) indices of F-points
    uniform: bool = False         # cpts == arange(0, nt, m) and nt-1 == (nc-1)*m:
                                  # enables the scatter-free strided/reshape path


def classify_points(t_fine: np.ndarray, t_coarse: np.ndarray) -> np.ndarray:
    """C-point indices of the fine grid = positions whose time value exists on
    the coarse grid (reference: mgrit.py:768 ``np.in1d``)."""
    return np.where(np.isin(t_fine, t_coarse))[0]


def coarsening_factor(cpts: np.ndarray) -> int:
    """First-difference coarsening factor (reference: mgrit.py:212-217)."""
    d = np.diff(cpts)
    return int(d[0]) if d.size else 1


def build_chains(t: np.ndarray, cpts: np.ndarray) -> FChains:
    """Decompose the F-points of a level into runs seeded by C-points."""
    nt = len(t)
    in_c = np.zeros(nt, dtype=bool)
    in_c[cpts] = True
    if not in_c[0]:
        raise Exception("The first time point of every level must be a C-point")

    seeds: List[int] = []
    lengths: List[int] = []
    i = 0
    while i < nt:
        if in_c[i]:
            # Find run of F-points following this C-point
            j = i + 1
            while j < nt and not in_c[j]:
                j += 1
            run_len = j - i - 1
            if run_len > 0:
                seeds.append(i)
                lengths.append(run_len)
            i = j if j > i + 1 else i + 1
        else:  # pragma: no cover — unreachable given the first-point check
            i += 1

    seeds_a = np.asarray(seeds, dtype=np.int64)
    lengths_a = np.asarray(lengths, dtype=np.int64)
    j_count = len(seeds)
    lmax = int(lengths_a.max()) if j_count else 0

    f_idx = np.full((j_count, lmax), nt, dtype=np.int64)
    mask = np.zeros((j_count, lmax), dtype=bool)
    t_prev = np.zeros((j_count, lmax), dtype=np.float64)
    t_curr = np.zeros((j_count, lmax), dtype=np.float64)
    for j in range(j_count):
        ln = lengths_a[j]
        idxs = seeds_a[j] + 1 + np.arange(ln)
        f_idx[j, :ln] = idxs
        mask[j, :ln] = True
        t_prev[j, :ln] = t[idxs - 1]
        t_curr[j, :ln] = t[idxs]
        # Pad time entries with the last valid pair so padded lanes still
        # evaluate step() on well-defined (finite, nonzero-dt) arguments.
        if ln < lmax and ln > 0:
            t_prev[j, ln:] = t[idxs[-1] - 1]
            t_curr[j, ln:] = t[idxs[-1]]
    return FChains(seed=seeds_a, lengths=lengths_a, f_idx=f_idx, mask=mask,
                   t_prev=t_prev, t_curr=t_curr, lmax=lmax)


def build_c_chains(t: np.ndarray, cpts: np.ndarray) -> CChains:
    """Group the relaxed C-points (all but global index 0) into maximal runs
    of adjacent indices."""
    nt = len(t)
    pts = cpts[cpts != 0]
    runs: List[List[int]] = []
    for p in pts:
        if runs and p == runs[-1][-1] + 1:
            runs[-1].append(int(p))
        else:
            runs.append([int(p)])
    k = len(runs)
    rmax = max((len(r) for r in runs), default=0)
    c_idx = np.full((k, rmax), nt, dtype=np.int64)
    mask = np.zeros((k, rmax), dtype=bool)
    t_prev = np.zeros((k, rmax), dtype=np.float64)
    t_curr = np.zeros((k, rmax), dtype=np.float64)
    seed_prev = np.zeros(k, dtype=np.int64)
    for j, r in enumerate(runs):
        ln = len(r)
        c_idx[j, :ln] = r
        mask[j, :ln] = True
        t_prev[j, :ln] = t[np.asarray(r) - 1]
        t_curr[j, :ln] = t[np.asarray(r)]
        seed_prev[j] = r[0] - 1
        if ln < rmax:
            t_prev[j, ln:] = t[r[-1] - 1]
            t_curr[j, ln:] = t[r[-1]]
    return CChains(c_idx=c_idx, mask=mask, t_prev=t_prev, t_curr=t_curr,
                   seed_prev=seed_prev, rmax=rmax)


def build_level_infos(t_grids: List[np.ndarray]) -> List[LevelInfo]:
    """Build the static structure for a hierarchy of nested time grids."""
    infos: List[LevelInfo] = []
    n_levels = len(t_grids)
    for lvl in range(n_levels):
        t = np.asarray(t_grids[lvl], dtype=np.float64)
        nt = len(t)
        if lvl < n_levels - 1:
            cpts = classify_points(t, np.asarray(t_grids[lvl + 1], dtype=np.float64))
            m = coarsening_factor(cpts)
            chains = build_chains(t, cpts)
            c_chains = build_c_chains(t, cpts)
            all_idx = np.arange(nt)
            fpts = np.setdiff1d(all_idx, cpts)
            uniform = bool(m > 1 and len(cpts) > 1 and
                           np.array_equal(cpts, np.arange(0, nt, m)) and
                           nt - 1 == (len(cpts) - 1) * m)
        else:
            cpts = np.arange(nt)
            m = 1
            chains = None
            c_chains = None
            fpts = np.array([], dtype=np.int64)
            uniform = False
        infos.append(LevelInfo(lvl=lvl, t=t, nt=nt, cpts=cpts, m=m,
                               chains=chains, c_chains=c_chains, fpts=fpts,
                               uniform=uniform))
    return infos


def validate_hierarchy(t_grids: List[np.ndarray]) -> None:
    """Nestedness validation (reference: mgrit.py:93-96)."""
    for lvl in range(1, len(t_grids)):
        fine = set(np.asarray(t_grids[lvl - 1]).tolist())
        coarse = np.asarray(t_grids[lvl]).tolist()
        if len(fine.intersection(set(coarse))) != len(coarse):
            raise Exception(
                'Some points from level ' + str(lvl - 1) + ' are not points of level ' + str(lvl))
        if len(t_grids[lvl - 1]) < len(t_grids[lvl]):
            raise Exception(
                'The time grid on level ' + str(lvl) + ' contains more time points than level ' + str(lvl - 1))
