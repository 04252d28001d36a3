"""Integration engine: the Euler update of the predictor-corrector scheme.

Counterpart of the JAX package's ``ops/integrate.py`` (``eulerDevice``,
`src/cuda/euler_kernel.def:395-540`).  Scheme (reference
`src/integrators/PredictorCorrectorIntegrator.cc:44-69`):

* predictor (step 1): from state n with forces(n), dt_eff = dt/2,
  ``velc = vel(n)`` — produces state n*
* corrector (step 2): from state n with forces(n*), dt_eff = dt,
  ``velc = vel(n) + forces(n*) * dt/2`` — produces state n+1

Fluid particles integrate pos/vel/rho; boundary particles are static except
that DYN boundaries integrate density; moving-body particles are moved by
the bodies subsystem afterwards.
"""
from __future__ import annotations

import torch

from ..defs import BoundaryType, ParticleType, SimFlags, SPHFormulation, TurbulenceModel
from ..framework import SimFramework
from ..state import ParticleState, part_type
from .forces import ForcesOut


def wrap_periodic(grid, pos: torch.Tensor) -> torch.Tensor:
    """Wrap positions into the periodic box (the reference folds this into
    the cell hash, `buildneibs_kernel.cu:664`)."""
    per = int(grid.periodic)
    if not per:
        return pos
    cols = []
    for a in range(3):
        x = pos[:, a]
        if per & (1 << a):
            o = grid.origin[a]
            x = o + torch.remainder(x - o, grid.world_size[a])
        cols.append(x)
    return torch.stack(cols, dim=1)


def euler_step(
    fw: SimFramework,
    state_n: ParticleState,
    forces: ForcesOut,
    dt_eff,
    *,
    step: int,
    full_dt=None,
    grid=None,
) -> ParticleState:
    """One Euler update producing state n* (step=1) or n+1 (step=2)."""
    if fw.sph_formulation == SPHFormulation.SPH_GRENIER:
        raise NotImplementedError("Grenier's formulation is not ported yet")
    if fw.visc.turbmodel == TurbulenceModel.KEPSILON:
        raise NotImplementedError("the k-epsilon model is not ported yet")
    ptype = part_type(state_n.info)
    is_fluid = (ptype == ParticleType.FLUID)
    is_bound = (ptype == ParticleType.BOUNDARY)

    # corrected velocity (compute_corrected_velocity, euler_kernel.def)
    velc = state_n.vel
    if step == 2:
        velc = velc + forces.DvDt * (full_dt * 0.5)
    if fw.has_xsph:
        velc = velc + fw.pp.epsxsph * forces.xsph

    fl = is_fluid[:, None]
    new_pos = torch.where(fl, state_n.pos + velc * dt_eff, state_n.pos)
    if grid is not None:
        new_pos = wrap_periodic(grid, new_pos)
    new_vel = torch.where(fl, state_n.vel + forces.DvDt * dt_eff, state_n.vel)

    rho_mask = is_fluid
    if fw.boundarytype in (BoundaryType.DYN_BOUNDARY, BoundaryType.SA_BOUNDARY):
        rho_mask = rho_mask | is_bound
    new_rho = torch.where(rho_mask, state_n.rho + forces.DrDt * dt_eff, state_n.rho)

    extras = dict(state_n.extras)
    # internal energy integration (euler_kernel.def:182-196)
    if (fw.flags & SimFlags.ENABLE_INTERNAL_ENERGY) and "energy" in extras:
        extras["energy"] = torch.where(
            is_fluid, extras["energy"] + forces.DEDt * dt_eff, extras["energy"])
    return state_n.replace(pos=new_pos, vel=new_vel, rho=new_rho, extras=extras)


def compute_dt(fw: SimFramework, forces: ForcesOut) -> torch.Tensor:
    """Adaptive dt from the CFL maxima — ``dtreduce`` (`forces.cu:557-600`):
    dtadaptfactor * min(sqrt(h/max|a|), h/max_c), further bounded by the
    viscous condition viscdtfactor * h^2 / nu_max."""
    sp = fw.sp
    # an f32 tensor numerator: a Python scalar over a tensor would become a
    # reciprocal times the scalar, which rounds differently from JAX
    h = torch.tensor(sp.slength, dtype=torch.float32, device=forces.max_accel.device)
    dt_force = torch.sqrt(h / torch.clamp(forces.max_accel, min=1e-12))
    dt_sound = h / torch.clamp(forces.max_sspeed, min=1e-12)
    dt = sp.dtadaptfactor * torch.minimum(dt_force, dt_sound)
    if not fw.is_inviscid:
        dt_visc = sp.viscdtfactor * h * h / torch.clamp(forces.max_kinvisc, min=1e-12)
        dt = torch.minimum(dt, dt_visc)
    return dt


__all__ = ["euler_step", "compute_dt", "wrap_periodic"]
