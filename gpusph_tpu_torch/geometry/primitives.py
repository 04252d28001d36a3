"""Host-side geometry primitives: particle filling.

Copy of the JAX package's ``geometry/primitives.py`` (numpy only): the
counterpart of the reference's geometry classes
(`src/geometries/Cube.cc`, `Sphere.cc`, `Cylinder.cc`, ... — the
Fill/FillBorder/FillIn methods, `src/geometries/Object.h:89-228`).  These run
once at problem setup on the host, in numpy float64; only the resulting
particle arrays are shipped to the device.

All fill functions return ``[n,3]`` float64 position arrays on a regular
lattice of spacing ``dp``.  Border fills produce ``layers`` shells spaced
``dp`` apart, growing *inward* from the outer surface, matching the
reference's dynamic-boundary layering (`setDynamicBoundariesLayers`).
"""
from __future__ import annotations

import numpy as np


def _lattice(lo, hi, dp):
    """1D fill coordinates: points spaced dp inside [lo,hi], centered.

    Never overshoots the interval (particles must stay inside the world
    grid); when the span is an exact multiple of dp the lattice touches both
    ends.
    """
    span = hi - lo
    n = max(1, int(np.floor(span / dp + 1e-6)) + 1)
    pad = (span - (n - 1) * dp) / 2
    return lo + pad + np.arange(n) * dp


def fill_box(origin, size, dp) -> np.ndarray:
    """Solid box fill (reference `Cube::Fill`)."""
    xs = _lattice(origin[0], origin[0] + size[0], dp)
    ys = _lattice(origin[1], origin[1] + size[1], dp)
    zs = _lattice(origin[2], origin[2] + size[2], dp)
    g = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=1)


def fill_box_border(origin, size, dp, layers: int = 1, open_top: bool = False) -> np.ndarray:
    """Box shell fill of ``layers`` layers (reference `Cube::FillIn`).

    Layers grow *inward* from the given box surface (matching the reference's
    FillIn semantics): the outermost shell sits on the box faces, deeper
    shells at dp steps inside — so with dynamic boundaries the fluid must be
    placed ``layers*dp`` away from the faces (see DamBreak3D.cu:141-144).
    """
    pts = []
    o = np.asarray(origin, np.float64)
    s = np.asarray(size, np.float64)
    for layer in range(layers):
        off = layer * dp
        lo = o + off
        sz = s - 2 * off
        xs = _lattice(lo[0], lo[0] + sz[0], dp)
        ys = _lattice(lo[1], lo[1] + sz[1], dp)
        zs = _lattice(lo[2], lo[2] + sz[2], dp)
        for fixed_axis in range(3):
            for side in (0, 1):
                if open_top and fixed_axis == 2 and side == 1:
                    continue
                coords = [xs, ys, zs]
                coords[fixed_axis] = np.asarray(
                    [lo[fixed_axis] + side * sz[fixed_axis]]
                )
                g = np.meshgrid(*coords, indexing="ij")
                pts.append(np.stack([a.ravel() for a in g], axis=1))
    pts = np.concatenate(pts, axis=0)
    return _dedup(pts, dp)


def fill_rect(origin, u, v, dp) -> np.ndarray:
    """Planar rectangle fill: origin + s*u + t*v (reference `Rect::Fill`)."""
    o = np.asarray(origin, np.float64)
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    nu = max(1, int(np.floor(np.linalg.norm(u) / dp + 0.5)) + 1)
    nv = max(1, int(np.floor(np.linalg.norm(v) / dp + 0.5)) + 1)
    ss = np.linspace(0, 1, nu)
    tt = np.linspace(0, 1, nv)
    g = np.stack(np.meshgrid(ss, tt, indexing="ij"), axis=-1).reshape(-1, 2)
    return o + g[:, :1] * u + g[:, 1:] * v


def fill_sphere(center, radius, dp, solid=True, layers: int = 1) -> np.ndarray:
    """Sphere fill (reference `Sphere::Fill`/`FillIn`)."""
    c = np.asarray(center, np.float64)
    r_out = radius
    grid = fill_box(c - r_out, (2 * r_out,) * 3, dp)
    d = np.linalg.norm(grid - c, axis=1)
    if solid:
        return grid[d <= r_out + 1e-9]
    r_in = max(0.0, r_out - (layers - 1) * dp)
    # shell: keep lattice points within the shell thickness
    return grid[(d <= r_out + 1e-9) & (d >= r_in - 0.5 * dp)]


def fill_cylinder(center_base, radius, height, dp, solid=True, layers: int = 1,
                  axis: int = 2, capped: bool = True) -> np.ndarray:
    """Cylinder fill along a coordinate axis (reference `Cylinder::Fill`)."""
    c = np.asarray(center_base, np.float64)
    lo = c.copy()
    lo[(axis + 1) % 3] -= radius
    lo[(axis + 2) % 3] -= radius
    size = np.full(3, 2 * radius)
    size[axis] = height
    grid = fill_box(lo, size, dp)
    rel = grid - c
    rad_d = np.sqrt(
        rel[:, (axis + 1) % 3] ** 2 + rel[:, (axis + 2) % 3] ** 2
    )
    inside = rad_d <= radius + 1e-9
    if solid:
        return grid[inside]
    r_in = max(0.0, radius - (layers - 1) * dp)
    shell = inside & (rad_d >= r_in - 0.5 * dp)
    if capped:
        ax_d = rel[:, axis]
        caps = inside & (
            (ax_d <= (layers - 1) * dp + 0.5 * dp)
            | (ax_d >= height - (layers - 1) * dp - 0.5 * dp)
        )
        shell = shell | caps
    return grid[shell]


def fill_torus(center, major_radius, minor_radius, dp, axis: int = 2) -> np.ndarray:
    """Solid torus fill (reference `Torus::Fill`)."""
    c = np.asarray(center, np.float64)
    r_out = major_radius + minor_radius
    lo = c - r_out
    lo[axis] = c[axis] - minor_radius
    size = np.full(3, 2 * r_out)
    size[axis] = 2 * minor_radius
    grid = fill_box(lo, size, dp)
    rel = grid - c
    a1, a2 = (axis + 1) % 3, (axis + 2) % 3
    ring_d = np.sqrt(rel[:, a1] ** 2 + rel[:, a2] ** 2) - major_radius
    tube_d = np.sqrt(ring_d**2 + rel[:, axis] ** 2)
    return grid[tube_d <= minor_radius + 1e-9]


def fill_cone(center_base, bottom_radius, top_radius, height, dp,
              axis: int = 2) -> np.ndarray:
    """Solid (truncated) cone fill (reference `Cone::Fill`)."""
    c = np.asarray(center_base, np.float64)
    r_max = max(bottom_radius, top_radius)
    lo = c.copy()
    a1, a2 = (axis + 1) % 3, (axis + 2) % 3
    lo[a1] -= r_max
    lo[a2] -= r_max
    size = np.full(3, 2 * r_max)
    size[axis] = height
    grid = fill_box(lo, size, dp)
    rel = grid - c
    frac = np.clip(rel[:, axis] / height, 0, 1)
    r_here = bottom_radius + (top_radius - bottom_radius) * frac
    rad_d = np.sqrt(rel[:, a1] ** 2 + rel[:, a2] ** 2)
    return grid[rad_d <= r_here + 1e-9]


def fill_disk(center, radius, dp, axis: int = 2) -> np.ndarray:
    """Planar disk fill (reference `Disk::Fill`)."""
    return fill_cylinder(center, radius, 0.0, dp, solid=True, axis=axis)


def erase_inside(pts: np.ndarray, predicate, keep_outside=True) -> np.ndarray:
    """Remove points where predicate(pts) (reference unfill/erase operations,
    `src/problem_api/ProblemAPI_1.h:71-99`)."""
    m = predicate(pts)
    return pts[~m] if keep_outside else pts[m]


def box_predicate(origin, size, margin=0.0):
    o = np.asarray(origin, np.float64) - margin
    hi = o + np.asarray(size, np.float64) + 2 * margin
    return lambda p: np.all((p >= o) & (p <= hi), axis=1)


def sphere_predicate(center, radius):
    c = np.asarray(center, np.float64)
    return lambda p: np.linalg.norm(p - c, axis=1) <= radius


def _dedup(pts: np.ndarray, dp: float) -> np.ndarray:
    """Remove duplicate lattice points (overlapping shells at box edges)."""
    key = np.round(pts / (dp * 0.5)).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return pts[np.sort(idx)]


def rotate_axis(pts: np.ndarray, center, axis: int, angle: float) -> np.ndarray:
    """Rotate points by ``angle`` about the coordinate ``axis`` through
    ``center`` (reference EulerParameters rotations, `src/geometries/`)."""
    c, s = np.cos(angle), np.sin(angle)
    a1, a2 = (axis + 1) % 3, (axis + 2) % 3
    ctr = np.asarray(center, np.float64)
    rel = pts - ctr
    out = rel.copy()
    out[:, a1] = c * rel[:, a1] - s * rel[:, a2]
    out[:, a2] = s * rel[:, a1] + c * rel[:, a2]
    return out + ctr


def rotate_z(pts: np.ndarray, center, angle: float) -> np.ndarray:
    """Rotate points around a vertical axis through ``center``."""
    return rotate_axis(pts, center, 2, angle)


def rotate_y(pts: np.ndarray, center, angle: float) -> np.ndarray:
    return rotate_axis(pts, center, 1, angle)


__all__ = [
    "fill_box",
    "fill_box_border",
    "fill_rect",
    "fill_sphere",
    "fill_cylinder",
    "fill_torus",
    "fill_cone",
    "fill_disk",
    "erase_inside",
    "box_predicate",
    "sphere_predicate",
    "rotate_z",
]
