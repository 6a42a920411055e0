"""GetDP file-format IO and mesh utilities for the im_3kW machine model.

A copy of ``pymgrit_tpu/models/induction_machine/io_getdp.py`` (the port
imports nothing of the JAX package), reference
src/pymgrit/induction_machine/helper.py:1-518: .pre resolution headers
(get_preresolution, pre_file), .res solution files (set_resolution,
getdp_read_resolution), result scalars (get_values_from), gmsh v4 .msh
parsing (get_nodes, get_elements, check_version), mesh geometry and
classification (get_arrays, compute_data), and mesh-to-mesh barycentric
interpolation (interp_weights, interpolation_factors,
compute_mesh_transfer).

All of it is setup-time numpy (file parsing, ``scipy.spatial.Delaunay``)
but ``compute_mesh_transfer``, which the grid transfer applies to tensors:
a gather and a row-wise weighted sum.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.spatial import Delaunay

INNER_RADIUS_DEFAULT = 0.04568666666666668


# ---------------------------------------------------------------------------
# .pre / .res resolution files
# ---------------------------------------------------------------------------

def get_preresolution(file: str) -> int:
    """Number of unknowns from a .pre file: 6th line after $DofData, last
    field (reference helper.py:26-37)."""
    with open(file) as f:
        content = f.readlines()
    ind = next(idx for idx, s in enumerate(content) if '$DofData' in s)
    return int(content[ind + 5].split()[-1])


def set_resolution(file: str, t_start: float, u_start: np.ndarray, num_dofs: int) -> None:
    """Write a GetDP .res resolution file seeding the next solve
    (reference helper.py:40-62)."""
    u_start = np.asarray(u_start)
    lines = ['$ResFormat /* GetDP 2.10.0, ascii */', '1.1 0', '$EndResFormat']
    lines.append('$Solution  /* DofData #0 */')
    lines.append('0 ' + str(t_start) + ' 0 0')
    body = np.stack([np.real(u_start), np.imag(u_start)], axis=1)
    lines.append("\n".join(" ".join(map(str, row)) for row in body))
    lines.append('$EndSolution\n')
    with open(file, "w") as fid:
        fid.write("\n".join(lines))


def get_values_from(file: str) -> np.ndarray:
    """Last column of each line (reference helper.py:65-77)."""
    vals = []
    with open(file) as fobj:
        for line in fobj:
            row = line.split()
            if row:
                vals.append(row[-1])
    return np.array(vals, dtype=float)


def getdp_read_resolution(file: str, num_dofs: int) -> Tuple[np.ndarray, np.ndarray]:
    """Read time points and DOF vectors from a .res file
    (reference helper.py:80-135)."""
    with open(file) as f:
        content = f.readlines()

    ts: List[float] = []
    xs: List[np.ndarray] = []
    idx = 0
    while idx < len(content):
        line = content[idx]
        if '$Solution' in line:
            header = content[idx + 1].split()
            t_val = float(header[1])
            step_no = int(header[3])
            block = content[idx + 2: idx + 2 + num_dofs]
            arr = np.array([list(map(float, s.split())) for s in block])
            if len(ts) == step_no:
                ts.append(t_val)
                xs.append(arr[:, 0])
            elif step_no == len(ts) - 1:
                # the same step re-stored overwrites in place (reference
                # helper.py:109-119: oldstep == 1+step -> t[j-1]/x[j-1]
                # are overwritten; GetDP re-emits a step on restart)
                ts[step_no] = t_val
                xs[step_no] = arr[:, 0]
            else:
                raise Exception('time step stored out of order in ' + file)
            idx += 2 + num_dofs
        elif '$ResFormat' in line:
            if not content[idx + 1].startswith('1.1'):
                raise Exception('Unknown file format version')
            idx += 2
        else:
            idx += 1

    t = np.array(ts)
    x = np.stack(xs) if xs else np.zeros((0, num_dofs))
    if (x.size and np.isnan(x).any()) or (t.size and np.isnan(t).any()):
        raise Exception('getdp_read_resolution: file contains NaN | timepoint: ' + str(t))
    return t, x


def pre_file(file: str) -> Tuple[Dict, Dict, List]:
    """Node <-> unknown mapping from a .pre file (reference
    helper.py:138-161): body lines are `... node ... ... unknown`; unknown
    values 0/-1/1 mark boundary nodes."""
    with open(file) as f:
        content = f.readlines()
    mapping = content[9:-35]
    cor_to_un: Dict[str, str] = {}
    un_to_cor: Dict[str, str] = {}
    boundary: List[str] = []
    for ma in mapping:
        row = ma.split()
        if row[4] not in ('0', '-1', '1'):
            cor_to_un[row[1]] = row[4]
            un_to_cor[row[4]] = row[1]
        else:
            boundary.append(row[1])
    return cor_to_un, un_to_cor, boundary


# ---------------------------------------------------------------------------
# gmsh v4 meshes
# ---------------------------------------------------------------------------

def check_version(msh_file: str) -> None:
    """Require msh format major version 4 (reference helper.py:196-201)."""
    with open(msh_file) as f:
        content = f.readlines()
    if content[1].split()[0] != '4':
        raise Exception('Unsupported msh version. Required version: 4')


def get_nodes(file: str) -> Tuple[Dict, Dict]:
    """Nodes from a v4 .msh: 4+-field body lines inside $Nodes whose second
    token is not an entity dimension 0/1/2 (block headers) — matching the
    reference's filter exactly (helper.py:227-252)."""
    with open(file) as f:
        content = f.readlines()
    start = content.index('$Nodes\n')
    end = content.index('$EndNodes\n')
    node_dict: Dict[str, np.ndarray] = {}
    point_to_node: Dict[str, str] = {}
    for node in content[start + 2:end]:
        row = node.split()
        if len(row) > 1 and row[1] not in ('0', '1', '2'):
            node_dict[row[0]] = np.array([float(row[1]), float(row[2])])
            point_to_node[row[1] + ' ' + row[2]] = row[0]
    return node_dict, point_to_node


def get_elements(file: str) -> Tuple[Dict, Dict, Dict, Dict]:
    """Line and triangle elements from a v4 .msh (reference
    helper.py:255-297): per entity block, the header's last field is the
    element count; 3-field rows are lines, 4-field rows are triangles."""
    with open(file) as f:
        content = f.readlines()
    start = content.index('$Elements\n')
    end = content.index('$EndElements\n')
    ele = content[start + 2:end]

    lines_raw: List[str] = []
    tris_raw: List[str] = []
    i = 0
    while i < len(ele):
        num = int(ele[i].split()[-1])
        first = ele[i + 1].split() if num > 0 else []
        if len(first) == 3:
            lines_raw += ele[i + 1:i + num + 1]
        elif len(first) == 4:
            tris_raw += ele[i + 1:i + num + 1]
        i += num + 1

    line_d, line_r, tri_d, tri_r = {}, {}, {}, {}
    for elem in lines_raw:
        row = elem.split()
        line_d[row[0]] = np.array([row[1], row[2]])
        line_r[row[1] + ' ' + row[2]] = row[0]
    for elem in tris_raw:
        row = elem.split()
        tri_d[row[0]] = np.array([row[1], row[2], row[3]])
        tri_r[row[1] + ' ' + row[2] + ' ' + row[3]] = row[0]
    return line_d, tri_d, line_r, tri_r


def cart2pol(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return (x ** 2 + y ** 2) ** 0.5


# ---------------------------------------------------------------------------
# grid classification + transfer factors
# ---------------------------------------------------------------------------

def get_arrays(nodes_dict: Dict, lines_dict: Dict, elements_dict: Dict,
               inner_r: float, unknown_to_cor: Dict, boundary: List,
               new_start: int = 0) -> Dict:
    """Coordinate arrays + inner/outer (rotor/stator) classification of all
    nodes, boundary nodes and unknowns (reference helper.py:310-457)."""
    node_keys = list(nodes_dict.keys())
    points_com = np.array([nodes_dict[k] for k in node_keys]) if node_keys else np.zeros((0, 2))
    ind = {k: i for i, k in enumerate(node_keys)}

    boundary_nodes = sorted({v for val in lines_dict.values() for v in val})
    points_bou = np.array([nodes_dict[n] for n in boundary_nodes]) if boundary_nodes else np.zeros((0, 2))

    elecom = np.array([[ind[v[0]], ind[v[1]], ind[v[2]]] for v in elements_dict.values()],
                      dtype=int) if elements_dict else np.zeros((0, 3), dtype=int)

    unknown = np.array([nodes_dict[val] for val in unknown_to_cor.values()]) \
        if unknown_to_cor else np.zeros((0, 2))
    bou_coords = np.array([nodes_dict[e] for e in boundary]) if boundary else np.zeros((0, 2))
    unknown_com = np.vstack([unknown, bou_coords]) if bou_coords.size else unknown

    unknown_new = np.copy(unknown[new_start:, :])

    def split_inner_outer(pts, outer_eps):
        r = cart2pol(pts[:, 0], pts[:, 1]) if pts.size else np.zeros(0)
        inner = np.where(np.abs(r) - 1e-9 < abs(inner_r))[0]
        outer = np.where(np.abs(r) > abs(inner_r) + outer_eps)[0]
        return pts[inner], pts[outer]

    points_inner, _ = split_inner_outer(points_com, 0)
    r = cart2pol(points_com[:, 0], points_com[:, 1]) if points_com.size else np.zeros(0)
    points_outer = points_com[np.where(np.abs(r) > abs(inner_r) - 1e-9)[0]]

    points_bou_inner, points_bou_outer = split_inner_outer(points_bou, 1e-7)
    unknown_com_inner, unknown_com_outer = split_inner_outer(unknown_com, 1e-7)
    unknown_inner, unknown_outer = split_inner_outer(unknown, 1e-7)
    unknown_new_inner, unknown_new_outer = split_inner_outer(unknown_new, 1e-7)

    def membership_mapping(pts, inner_set, outer_set):
        map_in, map_out = [], []
        for i in range(pts.shape[0]):
            if inner_set.size and (pts[i] == inner_set).all(axis=1).any():
                map_in.append(i)
            elif outer_set.size and (pts[i] == outer_set).all(axis=1).any():
                map_out.append(i)
        return np.array(map_in, dtype=int), np.array(map_out, dtype=int)

    mapping_inner_new, mapping_outer_new = membership_mapping(
        unknown_new, unknown_new_inner, unknown_new_outer)

    # reference quirk (helper.py:425-435): the inner test uses `if ... in`,
    # the outer test a separate `if` (not elif) — a point on the interface
    # radius lands in both mappings.
    map_in, map_out = [], []
    for i in range(unknown.shape[0]):
        if unknown_inner.size and (unknown[i] == unknown_inner).all(axis=1).any():
            map_in.append(i)
        if unknown_outer.size and (unknown[i] == unknown_outer).all(axis=1).any():
            map_out.append(i)
    mapping_inner = np.array(map_in, dtype=int)
    mapping_outer = np.array(map_out, dtype=int)

    return {
        'pointsCom': points_com, 'pointsBou': points_bou,
        'pointsInner': points_inner, 'pointsBouInner': points_bou_inner,
        'elecom': elecom, 'unknown': unknown, 'unknownCom': unknown_com,
        'ind': ind, 'boundaryNodes': boundary_nodes,
        'pointsOuter': points_outer, 'pointsBouOuter': points_bou_outer,
        'unknownComInner': unknown_com_inner, 'unknownComOuter': unknown_com_outer,
        'unknownInner': unknown_inner, 'unknownOuter': unknown_outer,
        'mappingInnerToUnknown': mapping_inner, 'mappingOuterToUnknown': mapping_outer,
        'unknownNewInner': unknown_new_inner, 'unknownNewOuter': unknown_new_outer,
        'mappingInnerToUnknownNew': mapping_inner_new,
        'mappingOuterToUnknownNew': mapping_outer_new,
        'unknownNew': unknown_new,
    }


def compute_data(pre: str, msh: str, new_unknown_start: int,
                 inner_r: float = INNER_RADIUS_DEFAULT) -> Dict:
    """Parse one mesh level's .pre + .msh into grid info (reference
    helper.py:165-193)."""
    cor_to_un, un_to_cor, boundary = pre_file(pre)
    nodes, nodes_r = get_nodes(msh)
    lines, elements, lines_r, elements_r = get_elements(msh)
    data = get_arrays(nodes, lines, elements, inner_r, un_to_cor, boundary,
                      new_unknown_start)
    data.update({'nodes': nodes, 'lines': lines, 'elements': elements,
                 'elementsR': elements_r, 'linesR': lines_r, 'nodesR': nodes_r,
                 'corToUn': cor_to_un, 'unToCor': un_to_cor, 'boundary': boundary,
                 'indNodesToI': data['ind'], 'unknownComInner': data['unknownComInner']})
    return data


def interp_weights(xyz: np.ndarray, uvw: np.ndarray, d: int = 2,
                   tol: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Barycentric interpolation factors from a Delaunay triangulation of the
    coarse points (reference helper.py:500-518); negative weights (points
    outside every simplex) are clamped to 0."""
    tri = Delaunay(xyz)
    simplex = tri.find_simplex(uvw, tol=tol)
    vertices = np.take(tri.simplices, simplex, axis=0)
    temp = np.take(tri.transform, simplex, axis=0)
    delta = uvw - temp[:, d]
    bary = np.einsum('njk,nk->nj', temp[:, :d, :], delta)
    wts = np.hstack((bary, 1 - bary.sum(axis=1, keepdims=True)))
    wts[wts < 0] = 0
    return vertices, wts


def interpolation_factors(data_coarse: Dict, data_fine: Dict) -> Dict:
    """Inner/outer transfer factors between two mesh levels (reference
    helper.py:461-497)."""
    vtx_inner, wts_inner = interp_weights(data_coarse['unknownComInner'],
                                          data_fine['unknownNewInner'])
    vtx_outer, wts_outer = interp_weights(data_coarse['unknownComOuter'],
                                          data_fine['unknownNewOuter'])
    return {
        'vtxInner': vtx_inner, 'wtsInner': wts_inner,
        'vtxOuter': vtx_outer, 'wtsOuter': wts_outer,
        'addBoundInner': np.size(data_coarse['unknownComInner'], 0) -
                         np.size(data_coarse['unknownInner'], 0),
        'addBoundOuter': np.size(data_coarse['unknownComOuter'], 0) -
                         np.size(data_coarse['unknownOuter'], 0),
        'sizeLvlStop': len(data_fine['corToUn']),
        'sizeLvlStart': len(data_coarse['corToUn']),
        'mappingInner': data_coarse['mappingInnerToUnknown'],
        'mappingOuter': data_coarse['mappingOuterToUnknown'],
        'mappingInnerNew': data_fine['mappingInnerToUnknownNew'],
        'mappingOuterNew': data_fine['mappingOuterToUnknownNew'],
    }


def compute_mesh_transfer(values, vtx, wts, dif: int, dif2: int, fill_value: float = np.nan):
    """Apply barycentric transfer factors (reference helper.py:204-218) to
    the last axis of ``values`` (one state's values, or a (rows, n) batch;
    a tensor, or numpy on the CPU): the values padded with ``dif`` zeros,
    gathered at each new point's three vertices ``vtx`` and summed with its
    weights ``wts`` (numpy, or tensors on the values' device); NaN where a
    weight is negative; the last ``dif2`` points dropped."""
    values = torch.atleast_1d(torch.as_tensor(values, dtype=torch.float64))
    work = torch.cat([values, values.new_zeros(values.shape[:-1] + (dif,))], dim=-1)
    idx = torch.as_tensor(vtx, dtype=torch.int64, device=values.device)
    w = torch.as_tensor(wts, dtype=values.dtype, device=values.device)
    ret = torch.where((w < 0).any(dim=-1), fill_value, torch.sum(work[..., idx] * w, dim=-1))
    if dif2:
        ret = ret[..., :ret.shape[-1] - dif2]
    return ret
