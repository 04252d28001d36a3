"""Geometric plane boundaries (ENABLE_PLANES).

Counterpart of the JAX package's ``ops/planes.py`` (the reference's plane
forces, `PlaneForce`/`GeometryForce` `src/cuda/forces_kernel.cu:140-210`,
`src/planes.h`): LJ repulsion along the plane normal plus a tangential
viscous damping term, applied per particle with no neighbor search, after
gravity in the finalize step.  A handful of elementwise ops per plane, plain
PyTorch on every device.
"""
from __future__ import annotations

import torch

from ..framework import SimFramework
from .forces import _powf


def apply_plane_forces(fw: SimFramework, pos: torch.Tensor, vel: torch.Tensor,
                       mass: torch.Tensor, is_fluid: torch.Tensor,
                       DvDt: torch.Tensor) -> torch.Tensor:
    """DvDt plus the plane contributions of the fluid particles."""
    pp = fw.pp
    r0 = pp.r0
    f32 = dict(dtype=torch.float32, device=pos.device)
    dynvisc = max((f.kinematic_visc * f.rho0 for f in pp.fluids), default=0.0)
    for point, normal in fw.planes:
        n = torch.tensor(normal, **f32)
        n = n / torch.linalg.norm(n)
        dist = (pos - torch.tensor(point, **f32)) @ n  # signed distance along n
        safe = torch.clamp(dist, min=1e-3 * r0)
        # f32 tensor numerators: a Python scalar over a tensor would become a
        # reciprocal times the scalar, which rounds differently from JAX
        ratio = torch.full_like(safe, r0) / safe
        lj = pp.dcoeff * (_powf(ratio, pp.p1coeff) - _powf(ratio, pp.p2coeff)) / (safe * safe)
        lj = torch.clamp(lj, max=1e30)
        active = (is_fluid & (dist < r0))[:, None]
        # normal repulsion: DvDt += LJForce(r) * r * n (PlaneForce)
        DvDt = DvDt + torch.where(active, (lj * safe)[:, None] * n, 0.0)
        if dynvisc > 0:
            # tangential viscous damping: -mu*partsurf/(m*r) * v_t
            v_t = vel - (vel @ n)[:, None] * n
            coeff = torch.full_like(safe, -dynvisc * pp.partsurf) / (mass * safe)
            DvDt = DvDt + torch.where(active, coeff[:, None] * v_t, 0.0)
    return DvDt


__all__ = ["apply_plane_forces"]
