"""DEM (digital elevation model) terrain: the geometry force.

Counterpart of the JAX package's ``ops/dem.py`` (the reference's
`src/cuda/geom_core.cu`: DemPos, DemInterpol, DemTangentPlane and the
GeometryForce repulsion, with `src/geometries/TopoCube.{h,cc}` holding the
height field).  For each fluid particle the terrain height under (x, y) is
interpolated bilinearly, the local tangent plane comes from forward
differences over one DEM cell, and the Lennard-Jones plane repulsion acts
along its normal.  No neighbor search: elementwise gathers and arithmetic.

The DEM is static framework configuration packed hashable
(``SimFramework.dem``): (rows, cols, west, south, ewres, nsres,
heights_bytes), the heights row-major f32 from south to north and west to
east (GRASS ASCII, the reference's ``TopoCube::load_file<DEM_FMT_ASCII>``,
`TopoCube.cc:150`).  ``dem_heights`` puts the heights on a device once per
descriptor and device, and every forces pass reads that tensor.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..framework import SimFramework
from .forces import _powf


def pack_dem(heights: np.ndarray, west: float, south: float,
             ewres: float, nsres: float) -> tuple:
    """Hashable DEM descriptor for ``SimFramework.dem``."""
    h = np.ascontiguousarray(heights, np.float32)
    return (int(h.shape[0]), int(h.shape[1]), float(west), float(south),
            float(ewres), float(nsres), h.tobytes())


def unpack_dem(dem: tuple):
    """(heights f32[rows, cols], west, south, ewres, nsres)."""
    rows, cols, west, south, ewres, nsres, blob = dem
    h = np.frombuffer(blob, np.float32).reshape(rows, cols)
    return h, west, south, ewres, nsres


@functools.lru_cache(maxsize=8)
def dem_heights(dem: tuple, device: torch.device) -> torch.Tensor:
    """The height field as one f32 [rows, cols] tensor on ``device``, made
    once per descriptor and device (callers only read it)."""
    return torch.tensor(unpack_dem(dem)[0], dtype=torch.float32, device=device)


def dem_height_normal(dem: tuple, pos: torch.Tensor):
    """Bilinear terrain height [N] and unit normal [N,3] under ``pos``
    [N,3]; the normal comes from forward differences over one DEM cell
    (DemTangentPlane, `geom_core.cu:100-140`)."""
    rows, cols, west, south, ewres, nsres, _ = dem
    H = dem_heights(dem, pos.device)

    def div(a, b):
        # a true division on the card too: PyTorch divides a CUDA tensor by
        # a host number as a product with its reciprocal, an ulp off the
        # CPU's (and the JAX package's) quotient, and the terrain force
        # grows as (r0/d)^12 near the terrain
        return a / torch.full_like(a, b)

    def interp(x, y):
        # the clamp keeps ix + 1 and iy + 1 inside the grid, also for the
        # forward differences at the east and north edges
        fx = torch.clamp(div(x - west, ewres), 0.0, cols - 1.001)
        fy = torch.clamp(div(y - south, nsres), 0.0, rows - 1.001)
        ix = torch.floor(fx).long()
        iy = torch.floor(fy).long()
        tx = fx - ix
        ty = fy - iy
        h00 = H[iy, ix]
        h01 = H[iy, ix + 1]
        h10 = H[iy + 1, ix]
        h11 = H[iy + 1, ix + 1]
        return (h00 * (1 - tx) * (1 - ty) + h01 * tx * (1 - ty)
                + h10 * (1 - tx) * ty + h11 * tx * ty)

    x, y = pos[:, 0], pos[:, 1]
    z0 = interp(x, y)
    z1 = interp(x + ewres, y)
    z2 = interp(x, y + nsres)
    # tangent-plane normal (geom_core.cu:128-133)
    a = nsres * (z0 - z1)
    b = ewres * (z0 - z2)
    c = ewres * nsres  # a host float, as in the JAX package
    l = torch.sqrt(a * a + b * b + c * c)
    return z0, torch.stack([a / l, b / l, c / l], dim=-1)


def apply_dem_force(fw: SimFramework, pos, vel, mass, is_fluid, DvDt):
    """Add the Lennard-Jones repulsion against the DEM tangent plane to the
    fluid rows of ``DvDt`` (GeometryForce; the force law of
    ``ops/planes.py``), with the wall-friction term where the fluids are
    viscous."""
    pp = fw.pp
    r0 = pp.r0
    z0, n = dem_height_normal(fw.dem, pos)
    # signed distance to the tangent plane through (x, y, z0)
    dist = (pos[:, 2] - z0) * n[:, 2]
    safe = torch.clamp(dist, min=1e-3 * r0)
    ratio = r0 / safe
    lj = pp.dcoeff * (_powf(ratio, pp.p1coeff) - _powf(ratio, pp.p2coeff)) / (safe * safe)
    lj = torch.clamp(lj, max=1e30)
    active = (is_fluid & (dist < r0))[:, None]
    DvDt = DvDt + torch.where(active, (lj * safe)[:, None] * n, 0.0)
    dynvisc = max((f.kinematic_visc * f.rho0 for f in pp.fluids), default=0.0)
    if dynvisc > 0:
        vn = (vel * n).sum(dim=-1)
        v_t = vel - vn[:, None] * n
        coeff = -dynvisc * pp.partsurf / (mass * safe)
        DvDt = DvDt + torch.where(active, coeff[:, None] * v_t, 0.0)
    return DvDt


def load_dem_ascii(path: str) -> tuple:
    """A GRASS ASCII DEM (the reference's DEM_FMT_ASCII, `TopoCube.cc:150`):
    a header of north, south, east, west, rows and cols, then the heights
    row by row from the north edge; samples at the cell centres."""
    hdr = {}
    data = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0].rstrip(":")
            if key in ("north", "south", "east", "west", "rows", "cols"):
                hdr[key] = float(parts[1])
            else:
                data.append([float(v) for v in parts])
    rows, cols = int(hdr["rows"]), int(hdr["cols"])
    # file rows go north to south; stored south to north
    h = np.asarray(data, np.float32).reshape(rows, cols)[::-1]
    ewres = (hdr["east"] - hdr["west"]) / cols
    nsres = (hdr["north"] - hdr["south"]) / rows
    return pack_dem(h, hdr["west"] + ewres / 2, hdr["south"] + nsres / 2, ewres, nsres)


__all__ = ["pack_dem", "unpack_dem", "dem_heights", "dem_height_normal",
           "apply_dem_force", "load_dem_ascii"]
