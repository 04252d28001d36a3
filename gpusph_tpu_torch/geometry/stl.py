"""STL mesh loading and particle filling, on the host in numpy.

Counterpart of the JAX package's ``geometry/stl.py`` (the reference's
`src/geometries/STLMesh.{h,cc}`, ``addSTLMesh`` in
`src/problem_api/ProblemAPI_1.h:288`): load a binary or ASCII STL file,
sample each triangle on a lattice of about dp to make boundary particles,
and test points for being inside the mesh (ray parity) for erase
operations.
"""
from __future__ import annotations

import numpy as np

from .primitives import _dedup

# one binary STL record: normal, three vertices, attribute word (50 bytes)
_RECORD = np.dtype([("n", "<3f4"), ("v", "<(3,3)f4"), ("attr", "<u2")])


def load_stl(path: str) -> np.ndarray:
    """Triangles [n,3,3] float64 of a binary or ASCII STL file."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head.startswith(b"solid"):
        try:
            return _load_ascii(path)
        except ValueError:
            pass  # some binary files start with 'solid' too
    return _load_binary(path)


def _load_binary(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(80)
        n = int(np.frombuffer(f.read(4), "<u4")[0])
        rec = np.frombuffer(f.read(n * _RECORD.itemsize), dtype=_RECORD)
    return rec["v"].astype(np.float64)


def _load_ascii(path: str) -> np.ndarray:
    tris, cur = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                cur.append([float(x) for x in parts[1:4]])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    if not tris:
        raise ValueError("no triangles parsed")
    return np.asarray(tris, np.float64)


def fill_stl_surface(tris: np.ndarray, dp: float) -> np.ndarray:
    """Points on the mesh surface at about dp spacing, duplicates merged
    (STLMesh::FillBorder)."""
    pts = []
    for v0, v1, v2 in tris:
        e1 = v1 - v0
        e2 = v2 - v0
        n1 = max(1, int(np.ceil(np.linalg.norm(e1) / dp)))
        n2 = max(1, int(np.ceil(np.linalg.norm(e2) / dp)))
        a = (np.arange(n1 + 1) / n1)[:, None]
        b = (np.arange(n2 + 1) / n2)[None, :]
        mask = (a + b) <= 1.0 + 1e-9
        A = np.broadcast_to(a, mask.shape)[mask]
        B = np.broadcast_to(b, mask.shape)[mask]
        pts.append(v0[None, :] + A[:, None] * e1[None, :] + B[:, None] * e2[None, :])
    return _dedup(np.concatenate(pts, axis=0), dp)


def stl_inside_predicate(tris: np.ndarray):
    """``inside(points [n,3]) -> bool[n]`` by ray parity (Object::IsInside):
    Moller-Trumbore hits of a ray in a slightly irrational direction, which
    misses the shared edges of the triangles."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    d = np.array([0.03304043, 0.05571483, 0.99790407])
    d = d / np.linalg.norm(d)
    h = np.cross(d, e2)
    a = np.einsum("nd,nd->n", e1, h)
    ok = np.abs(a) > 1e-12
    inv_a = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)

    def inside(points: np.ndarray) -> np.ndarray:
        out = np.zeros(len(points), bool)
        for i, p in enumerate(points):
            s = p[None, :] - v0
            u = np.einsum("nd,nd->n", s, h) * inv_a
            q = np.cross(s, e1)
            v = (q @ d) * inv_a
            t = np.einsum("nd,nd->n", e2, q) * inv_a
            hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
            out[i] = (hit.sum() % 2) == 1
        return out

    return inside


__all__ = ["load_stl", "fill_stl_surface", "stl_inside_predicate"]
