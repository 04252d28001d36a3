"""Procedural SA boundary meshes: vertices + triangular boundary elements.

Counterpart of the JAX package's ``geometry/sa_mesh.py``, host-side numpy
like it.  The reference obtains SA geometry from Crixus-generated HDF5 files
(`src/problem_api/ProblemAPI_1.cc:1998-2014`); this build generates the
equivalent data procedurally for box-like domains:

* vertex particles on a dp lattice over each wall face (shared on edges /
  corners), with Crixus-style masses m_v = rho0 * dp * (owned area) where
  the owned area is one third of each adjacent triangle's area;
* one boundary element (segment) per triangle: barycenter position, inward
  unit normal, and the three vertex positions relative to the barycenter;
* vertex normals = normalized average of adjacent segment normals (the
  reference's computeVertexNormal, `boundary_conditions_kernel.cu`).

Triangle vertex order is counter-clockwise as seen along the inward normal
(cross(v1-v0, v2-v0) || n), the invariant the analytic grad-gamma formula
of ``ops/sa.py`` requires (reference initConnectivity).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _face_grid(origin, du, dv, nu, nv):
    """Vertex grid of a rectangular face: origin + i*du + j*dv."""
    i = np.arange(nu + 1)
    j = np.arange(nv + 1)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    pts = (
        np.asarray(origin)[None, None, :]
        + ii[..., None] * np.asarray(du)[None, None, :]
        + jj[..., None] * np.asarray(dv)[None, None, :]
    )
    return pts.reshape(-1, 3), ii.shape


def box_sa_mesh(
    origin: Tuple[float, float, float],
    size: Tuple[float, float, float],
    dp: float,
    *,
    faces: str = "all",  # "all", "open_top" or "channel"
    outward: bool = False,
) -> Dict[str, np.ndarray]:
    """SA mesh of an axis-aligned box with inward normals (``outward=True``
    flips them for obstacle boxes immersed in the fluid).

    Returns dict with ``verts`` [NV,3], ``vert_normal`` [NV,3],
    ``vert_area`` [NV] (owned area), ``seg_pos`` [NS,3], ``seg_normal``
    [NS,3], ``seg_verts`` [NS,3,3] (vertex positions relative to the
    barycenter), ``seg_area`` [NS], ``seg_vidx`` [NS,3] (indices into
    ``verts``).
    """
    o = np.asarray(origin, np.float64)
    s = np.asarray(size, np.float64)
    n = np.maximum(np.rint(s / dp).astype(int), 1)
    d = s / n  # actual spacings per axis

    # face definitions: (corner, u axis, v axis, inward normal axis sign)
    ex, ey, ez = np.eye(3)
    face_defs = [
        # (corner, u, v, normal, nu, nv)
        (o, ex * d[0], ey * d[1], ez, n[0], n[1]),                     # bottom z=0, n=+z
        (o + ez * s[2], ey * d[1], ex * d[0], -ez, n[1], n[0]),        # top, n=-z
        (o, ez * d[2], ey * d[1], ex, n[2], n[1]),                     # x=0, n=+x
        (o + ex * s[0], ey * d[1], ez * d[2], -ex, n[1], n[2]),        # x=L, n=-x
        (o, ex * d[0], ez * d[2], ey, n[0], n[2]),                     # y=0, n=+y
        (o + ey * s[1], ez * d[2], ex * d[0], -ey, n[2], n[0]),        # y=L, n=-y
    ]
    if outward:
        face_defs = [(c, du, dv, -nrm, nu, nv)
                     for (c, du, dv, nrm, nu, nv) in face_defs]
    if faces == "open_top":
        face_defs = [face_defs[0]] + face_defs[2:]
    elif faces == "channel":
        # bottom + the two y walls: open top AND open x ends (for
        # inlet/outlet plates added separately as IO meshes)
        face_defs = [face_defs[0], face_defs[4], face_defs[5]]

    all_pts = []
    all_tris = []  # (i0, i1, i2) into the concatenated point list
    tri_normals = []
    tri_face = []  # face id per triangle
    base = 0
    for fid, (corner, du, dv, nrm, nu, nv) in enumerate(face_defs):
        pts, shape = _face_grid(corner, du, dv, nu, nv)
        all_pts.append(pts)
        nu1 = int(nv + 1)  # v-fastest index stride

        def vid(i, j):
            return base + i * nu1 + j

        for i in range(int(nu)):
            for j in range(int(nv)):
                # two triangles per quad, CCW about the inward normal
                quad = [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
                for tri in ((quad[0], quad[1], quad[2]), (quad[0], quad[2], quad[3])):
                    all_tris.append(tri)
                    tri_normals.append(nrm)
                    tri_face.append(fid)
        base += len(pts)

    pts = np.concatenate(all_pts)
    tris = np.asarray(all_tris, np.int64)
    tri_n = np.asarray(tri_normals, np.float64)

    # dedupe shared edge/corner vertices
    key = np.round(pts / (min(d) * 0.25)).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    verts = pts[uniq_idx]
    tris = inv[tris]

    # enforce CCW-about-normal ordering
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    crossp = np.cross(v1 - v0, v2 - v0)
    flip = np.einsum("ij,ij->i", crossp, tri_n) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    v1, v2 = verts[tris[:, 1]], verts[tris[:, 2]]
    crossp = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(crossp, axis=1)

    seg_pos = (v0 + v1 + v2) / 3.0
    seg_verts = np.stack([v0 - seg_pos, v1 - seg_pos, v2 - seg_pos], axis=1)

    # vertex owned area + averaged normals + fluid-side Voronoi volume
    NV = len(verts)
    vert_area = np.zeros(NV)
    vert_normal = np.zeros((NV, 3))
    nfaces = np.zeros(NV, np.int64)
    tf = np.asarray(tri_face)
    for fid in range(len(face_defs)):
        used = np.zeros(NV, bool)
        used[tris[tf == fid].ravel()] = True
        nfaces += used
    for k in range(3):
        np.add.at(vert_area, tris[:, k], area / 3.0)
        np.add.at(vert_normal, tris[:, k], tri_n)
    nn = np.linalg.norm(vert_normal, axis=1, keepdims=True)
    vert_normal = vert_normal / np.maximum(nn, 1e-12)
    # the vertex represents its near-wall Voronoi cell clipped to the fluid
    # side (Crixus semantics): dp^3/2 at a flat face, /4 at edges, /8 at
    # corners of a convex box
    dpm = float(np.mean(d))
    vert_volume = dpm**3 / (2.0 ** np.clip(nfaces, 1, 3))
    if outward:
        # fluid side is the exterior of a convex box: flat faces keep
        # dp^3/2, edges get 3/4, corners 7/8
        vert_volume = np.where(nfaces <= 1, vert_volume,
                               dpm**3 - vert_volume)

    return dict(
        verts=verts,
        vert_normal=vert_normal,
        vert_area=vert_area,
        vert_volume=vert_volume,
        seg_pos=seg_pos,
        seg_normal=tri_n,
        seg_verts=seg_verts,
        seg_area=area,
        seg_vidx=tris,
    )


def plate_sa_mesh(
    origin: Tuple[float, float, float],
    u_vec: Tuple[float, float, float],
    v_vec: Tuple[float, float, float],
    normal: Tuple[float, float, float],
    dp: float,
    *,
    periodic_u: bool = False,
    periodic_v: bool = False,
) -> Dict[str, np.ndarray]:
    """SA mesh of a single rectangular wall plate spanned by u_vec x v_vec
    with inward unit normal ``normal``; periodic edges share the seam
    vertices (for periodic channels like TurbulentPoiseuilleFlowSA)."""
    o = np.asarray(origin, np.float64)
    u = np.asarray(u_vec, np.float64)
    v = np.asarray(v_vec, np.float64)
    nrm = np.asarray(normal, np.float64)
    nrm = nrm / np.linalg.norm(nrm)
    nu = max(int(round(np.linalg.norm(u) / dp)), 1)
    nv = max(int(round(np.linalg.norm(v) / dp)), 1)
    du = u / nu
    dv = v / nv

    nu_pts = nu if periodic_u else nu + 1
    nv_pts = nv if periodic_v else nv + 1
    pts = np.zeros((nu_pts, nv_pts, 3))
    for i in range(nu_pts):
        for j in range(nv_pts):
            pts[i, j] = o + i * du + j * dv
    verts = pts.reshape(-1, 3)

    def vid(i, j):
        return (i % nu_pts if periodic_u else i) * nv_pts + (
            j % nv_pts if periodic_v else j
        )

    tris = []
    for i in range(nu):
        for j in range(nv):
            q = [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
            tris.append((q[0], q[1], q[2]))
            tris.append((q[0], q[2], q[3]))
    tris = np.asarray(tris, np.int64)

    # CCW about the inward normal; seg geometry built from UNWRAPPED corner
    # positions so vertex rel-positions stay local across periodic seams
    def corner(i, j):
        return o + i * du + j * dv

    v0s, v1s, v2s = [], [], []
    t = 0
    for i in range(nu):
        for j in range(nv):
            cs = [corner(i, j), corner(i + 1, j), corner(i + 1, j + 1), corner(i, j + 1)]
            for tri_c in ((cs[0], cs[1], cs[2]), (cs[0], cs[2], cs[3])):
                a, b, c = tri_c
                if np.dot(np.cross(b - a, c - a), nrm) < 0:
                    b, c = c, b
                    tris[t] = tris[t][[0, 2, 1]]
                v0s.append(a); v1s.append(b); v2s.append(c)
                t += 1
    v0 = np.asarray(v0s); v1 = np.asarray(v1s); v2 = np.asarray(v2s)
    crossp = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(crossp, axis=1)
    seg_pos = (v0 + v1 + v2) / 3.0
    seg_verts = np.stack([v0 - seg_pos, v1 - seg_pos, v2 - seg_pos], axis=1)

    NV = len(verts)
    vert_area = np.zeros(NV)
    vert_normal = np.tile(nrm, (NV, 1))
    for k in range(3):
        np.add.at(vert_area, tris[:, k], area / 3.0)
    # flat plate: each vertex owns the near-wall half cell
    vert_volume = vert_area * dp * 0.5

    return dict(
        verts=verts,
        vert_normal=vert_normal,
        vert_area=vert_area,
        vert_volume=vert_volume,
        seg_pos=seg_pos,
        seg_normal=np.tile(nrm, (len(tris), 1)),
        seg_verts=seg_verts,
        seg_area=area,
        seg_vidx=tris,
    )


__all__ = ["box_sa_mesh", "plate_sa_mesh"]
