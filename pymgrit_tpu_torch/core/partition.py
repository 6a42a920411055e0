"""Rank/shard partition arithmetic for the time axis.

A copy of ``pymgrit_tpu/core/partition.py`` (numpy only; the port imports
nothing of the JAX package): the reference's decomposition
(src/pymgrit/core/mgrit.py:728-838 -- ``split_into``, ``split_points``,
``setup_points_and_comm_info``), used for the parallel-distribution plot
(``utils/plots.py``) and, later, the time-sharded executor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def split_into(number_points: int, number_processes: int) -> np.ndarray:
    """Block sizes: first (n % p) ranks get ceil(n/p) (mgrit.py:829-838)."""
    return np.array([int(number_points / number_processes + 1)] * (number_points % number_processes) +
                    [int(number_points / number_processes)] * (number_processes - number_points % number_processes))


def split_points(length: int, size: int, rank: int) -> Tuple[int, int]:
    """(block_size, first_index) of this rank's slab (mgrit.py:728-740)."""
    split = split_into(number_points=length, number_processes=size)
    return split[rank], np.sum(split[:rank]) if split[rank] > 0 else 0


@dataclasses.dataclass
class RankView:
    """What one time-rank owns on one level (the fields the reference derives
    in setup_points_and_comm_info and asserts in its unit tables)."""

    cpts: np.ndarray            # global indices of owned C-points
    index_local: np.ndarray     # local indices of owned points (ghost offset)
    index_local_c: np.ndarray   # local indices of owned C-points
    index_local_f: np.ndarray   # local indices of owned F-points (ascending)
    first_is_c_point: bool
    first_is_f_point: bool
    last_is_c_point: bool
    last_is_f_point: bool
    comm_front: bool
    comm_back: bool
    send_to: int
    get_from: int
    with_ghost_point: bool
    t_local: np.ndarray         # owned time values incl. ghost


def rank_partition(t_grids: List[np.ndarray], n_ranks: int, rank: int) -> List[RankView]:
    """Per-level ownership tables for one rank (mgrit.py:742-827 semantics):
    level 0 is block-partitioned; coarse-level ownership is derived by
    time-value containment in the rank's fine slab, so a rank owns the same
    physical time interval on every level (and possibly zero points)."""
    views: List[RankView] = []
    lvl_max = len(t_grids)
    t0 = np.asarray(t_grids[0], dtype=np.float64)
    int_start = int_stop = None

    for lvl in range(lvl_max):
        t = np.asarray(t_grids[lvl], dtype=np.float64)
        nt = len(t)
        all_idx = np.arange(nt)
        if lvl == 0:
            block, first = split_points(nt, n_ranks, rank)
            all_pts = all_idx[first:first + block]
            int_start = t[all_pts[0]]
            int_stop = t[all_pts[-1]]
        else:
            all_pts = np.where((t >= int_start) & (t <= int_stop))[0]

        if lvl != lvl_max - 1:
            all_cpts = np.where(np.isin(t, np.asarray(t_grids[lvl + 1], dtype=np.float64)))[0]
        else:
            all_cpts = np.arange(0, nt, 1)
        all_fpts = np.setdiff1d(np.arange(nt), all_cpts)
        cpts = np.sort(np.array(list(set(all_pts) - set(all_fpts)), dtype=int))
        fpts = np.sort(np.array(list(set(all_pts) - set(cpts)), dtype=int))

        with_ghost = rank != 0 and all_pts.size > 0
        if with_ghost:
            all_pts_with_ghost = np.concatenate([[all_pts[0] - 1], all_pts])
        else:
            all_pts_with_ghost = all_pts

        index_local = np.nonzero(all_pts[:, None] == all_pts_with_ghost)[1]
        index_local_c = np.nonzero(cpts[:, None] == all_pts_with_ghost)[1]
        index_local_f = np.nonzero(fpts[:, None] == all_pts_with_ghost)[1]

        comm_front = bool(fpts.size > 0 and fpts.min() - 1 in all_fpts)
        comm_back = bool(fpts.size > 0 and fpts.max() + 1 in all_fpts)

        first_is_c = bool(all_pts.size > 0 and all_pts[0] in cpts and all_pts[0] != 0
                          and all_pts[0] - 1 in all_fpts)
        first_is_f = bool(all_pts.size > 0 and all_pts[0] in fpts and all_pts[0] - 1 in all_cpts)
        last_is_c = bool(all_pts.size > 0 and all_pts[-1] in cpts
                         and all_pts[-1] != nt - 1 and all_pts[-1] + 1 in all_fpts)
        last_is_f = bool(all_pts.size > 0 and all_pts[-1] in fpts
                         and all_pts[-1] != nt - 1 and all_pts[-1] + 1 in all_cpts)

        # Neighbor ranks via the fine-level slab boundaries (mgrit.py:815-827)
        split_ends = t0[np.cumsum(split_into(len(t0), n_ranks)) - 1]
        send_to = -99
        get_from = -99
        t_local = t[all_pts_with_ghost]
        if len(all_pts_with_ghost) > 0:
            if t_local[-1] != t[-1]:
                nxt = t[np.argwhere(t == t_local[-1])[0][0] + 1]
                send_to = int(np.searchsorted(split_ends, nxt))
            if with_ghost or t_local[0] != t0[0]:
                get_from = int(np.searchsorted(split_ends, t_local[0]))

        views.append(RankView(cpts=cpts, index_local=index_local,
                              index_local_c=index_local_c, index_local_f=index_local_f,
                              first_is_c_point=first_is_c, first_is_f_point=first_is_f,
                              last_is_c_point=last_is_c, last_is_f_point=last_is_f,
                              comm_front=comm_front, comm_back=comm_back,
                              send_to=send_to, get_from=get_from,
                              with_ghost_point=with_ghost, t_local=t_local))
    return views
