"""Marching-tetrahedra isosurface extraction, the fssrecon analogue (port
of `tpu3drec/mvs/marching.py`, single device).

The surface is the TSDF's zero crossing (`mvs/tsdf.py`). Each cell splits
into 6 tetrahedra around the main diagonal; a tetrahedron has 16 sign
cases whose triangulations follow from first principles (0 or 4 corners
inside: nothing; 1 or 3: one triangle; 2: a quad, two triangles), so the
case table is built by `_build_case_table`, not transcribed. The cells
with a sign change are found on the host (numpy) and padded to a bucketed
count; the triangles are emitted for all of them at once on the device by
gathers and elementwise interpolation, then compacted on the host.

Each triangle is flipped where needed so that its normal points along the
TSDF's gradient (outward: the TSDF is positive in free space).
`weld_mesh` turns the soup into an indexed mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.utils.device import resolve_device

# cube corners as (dx, dy, dz) offsets, the conventional MC ordering
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# 6-tet decomposition of the cube around the main diagonal c0-c6
_TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
     [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int32)

# the 6 edges of a tetrahedron as (vertex, vertex) index pairs
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)


def _build_case_table() -> np.ndarray:
    """(16, 2, 3) edge-index triangles per sign case, -1-padded.

    Case bit i set <=> tet vertex i is inside (value < iso):
    - 0 or 4 inside: no crossing, no triangle;
    - 1 inside (vertex a): the 3 edges from a to the outside vertices;
    - 3 inside (outside vertex d): the 3 edges from d;
    - 2 inside {a, b}, outside {c, d}: the quad of edges (a,c), (a,d),
      (b,d), (b,c) in that cyclic order (consecutive corners share a tet
      vertex), as two triangles.
    """
    edge_id = {tuple(sorted(e)): i for i, e in enumerate(_TET_EDGES)}
    table = np.full((16, 2, 3), -1, np.int32)
    for case in range(16):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if not case & (1 << v)]
        if len(inside) in (0, 4):
            continue
        if len(inside) == 1:
            a = inside[0]
            table[case, 0] = [edge_id[tuple(sorted((a, o)))] for o in outside]
        elif len(inside) == 3:
            d = outside[0]
            table[case, 0] = [edge_id[tuple(sorted((d, i)))] for i in inside]
        else:
            a, b = inside
            c, d = outside
            q = [edge_id[tuple(sorted((a, c)))], edge_id[tuple(sorted((a, d)))],
                 edge_id[tuple(sorted((b, d)))], edge_id[tuple(sorted((b, c)))]]
            table[case, 0] = [q[0], q[1], q[2]]
            table[case, 1] = [q[0], q[2], q[3]]
    return table


_CASE_TABLE = _build_case_table()


def _emit_triangles(cells_xyz: torch.Tensor, tsdf: torch.Tensor, origin: torch.Tensor,
                    res: float, iso: float):
    """cells_xyz (A, 3) int64 cell coordinates on the TSDF's device ->
    (verts (A, 6, 2, 3, 3), valid (A, 6, 2)): per cell, tetrahedron and
    triangle slot, the triangle's vertices and whether the slot holds one."""
    dev = tsdf.device
    X, Y, Z = tsdf.shape
    flat = tsdf.reshape(-1)
    corners = cells_xyz[:, None, :] + torch.as_tensor(_CORNERS, device=dev)  # (A, 8, 3)
    cidx = (corners[..., 0] * Y + corners[..., 1]) * Z + corners[..., 2]
    vals = flat[cidx.reshape(-1)].reshape(corners.shape[:2])  # (A, 8)
    # origin + corner * res, one rounding per coordinate
    pos = fp.fma(corners.to(torch.float32), torch.full_like(origin, res).expand(corners.shape),
                 origin.expand(corners.shape))
    tets = torch.as_tensor(_TETS, device=dev).long()
    tet_vals = vals[:, tets]  # (A, 6, 4)
    tet_pos = pos[:, tets]    # (A, 6, 4, 3)
    bits = (tet_vals < iso).to(torch.int64)
    case = (bits * torch.tensor([1, 2, 4, 8], device=dev)).sum(-1)  # (A, 6)

    tris = torch.as_tensor(_CASE_TABLE, device=dev).long()[case]  # (A, 6, 2, 3)
    valid = tris[..., 0] >= 0
    ev = torch.as_tensor(_TET_EDGES, device=dev).long()[torch.clamp(tris, 0, 5)]  # (A,6,2,3,2)

    def corner(v):
        """v (A, 6, 2, 3) tet-vertex ids -> (values, positions)."""
        tv = tet_vals[:, :, None, None, :].expand(v.shape + (4,))
        val = torch.gather(tv, -1, v[..., None])[..., 0]
        tp = tet_pos[:, :, None, None, :, :].expand(v.shape + (4, 3))
        p = torch.gather(tp, -2, v[..., None, None].expand(v.shape + (1, 3)))[..., 0, :]
        return val, p

    vA, pA = corner(ev[..., 0])
    vB, pB = corner(ev[..., 1])
    tdenom = vB - vA
    tt = (iso - vA) / torch.where(torch.abs(tdenom) < 1e-12, tdenom.new_full((), 1e-12), tdenom)
    tt = fp.clip(tt, 0.0, 1.0)
    verts = fp.fma(tt[..., None].expand(pA.shape), pB - pA, pA)  # (A, 6, 2, 3, 3)

    # orient along the TSDF gradient (outward): flip where the face normal
    # disagrees with the inside -> outside direction of the tetrahedron
    w_in = bits.to(torch.float32)
    w_out = 1.0 - w_in
    c_in = (tet_pos * w_in[..., None]).sum(2) / torch.clamp_min(w_in.sum(-1), 1.0)[..., None]
    c_out = (tet_pos * w_out[..., None]).sum(2) / torch.clamp_min(w_out.sum(-1), 1.0)[..., None]
    g = c_out - c_in  # (A, 6, 3)
    n = torch.cross(verts[..., 1, :] - verts[..., 0, :], verts[..., 2, :] - verts[..., 0, :],
                    dim=-1)  # (A, 6, 2, 3)
    flip = (n * g[:, :, None, :]).sum(-1) < 0
    swapped = verts[..., [0, 2, 1], :]
    verts = torch.where(flip[..., None, None], swapped, verts)
    return verts, valid


def _cell_reduce(a: np.ndarray, op) -> np.ndarray:
    """``op`` over each cell's 8 corners of an (X, Y, Z) array ->
    (X-1, Y-1, Z-1)."""
    return op.reduce([a[:-1, :-1, :-1], a[1:, :-1, :-1], a[1:, 1:, :-1], a[:-1, 1:, :-1],
                      a[:-1, :-1, 1:], a[1:, :-1, 1:], a[1:, 1:, 1:], a[:-1, 1:, 1:]])


def marching_tetrahedra(tsdf, weight=None, origin=(0.0, 0.0, 0.0), res: float = 1.0,
                        iso: float = 0.0, pad_to: int = 1024, device=None) -> np.ndarray:
    """The iso-surface triangle soup of an (X, Y, Z) TSDF (numpy or a
    tensor). ``weight`` (optional): cells touching an unobserved (weight 0)
    corner are skipped. Triangles are emitted on ``device`` (default the
    TSDF's, for a tensor; else the card). Returns (T, 3, 3) float32 world
    coordinates, in the order of cells, tetrahedra and slots."""
    if device is None and isinstance(tsdf, torch.Tensor):
        device = tsdf.device
    dev = resolve_device(device)
    tsdf_t = torch.as_tensor(tsdf, dtype=torch.float32, device=dev)
    tsdf_np = tsdf_t.cpu().numpy()
    inside = tsdf_np < iso
    # a cell holds a crossing iff its 8 corners are not all on one side
    active = _cell_reduce(inside, np.maximum) & ~_cell_reduce(inside, np.minimum)
    if weight is not None:
        w = torch.as_tensor(weight).cpu().numpy() > 0
        active &= _cell_reduce(w, np.minimum)  # all 8 corners observed
    ax, ay, az = np.nonzero(active)
    if ax.size == 0:
        return np.zeros((0, 3, 3), np.float32)
    cells = np.stack([ax, ay, az], axis=1).astype(np.int64)
    # pad to a bucketed count (powers of two times pad_to), as the JAX
    # package does to bound its compiled shapes; padded cells are dropped
    A = cells.shape[0]
    padded = pad_to
    while padded < A:
        padded *= 2
    cells_p = np.concatenate([cells, np.zeros((padded - A, 3), np.int64)])
    verts, valid = _emit_triangles(
        torch.as_tensor(cells_p, device=dev), tsdf_t,
        torch.as_tensor(np.asarray(origin, np.float32), device=dev), float(res), float(iso))
    valid[A:] = False
    return verts[valid].cpu().numpy().astype(np.float32)


def weld_mesh(tri_soup: np.ndarray, tol: float = 1e-5):
    """(T, 3, 3) triangle soup -> indexed mesh (verts (V, 3) float32, faces
    (T', 3) int32). Vertices are welded by quantising to ``tol`` (each welded
    vertex the mean of its originals); faces with a repeated vertex after
    welding are dropped. Host-side."""
    if tri_soup.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = tri_soup.reshape(-1, 3)
    q = np.round(flat / tol).astype(np.int64)
    uniq, inv = np.unique(q, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    verts = np.zeros((uniq.shape[0], 3), np.float64)
    counts = np.bincount(inv, minlength=uniq.shape[0]).astype(np.float64)
    for k in range(3):
        verts[:, k] = np.bincount(inv, weights=flat[:, k], minlength=uniq.shape[0]) / counts
    faces = inv.reshape(-1, 3).astype(np.int32)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[ok]
