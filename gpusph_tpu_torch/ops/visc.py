"""Viscosity engine: shear rate, SPS stress, non-Newtonian effective viscosity.

Counterpart of the JAX package's ``ops/visc.py`` (the reference's
`AbstractViscEngine` `src/engine_visc.h:45-100`, kernels in
`src/cuda/visc_kernel.cu`), in plain PyTorch over ``ops/pair.neighbor_apply``:

* the shear-rate tensor from SPH velocity gradients
  (`shearRate<MIXED_TENSOR>` `visc_kernel.cu:300-350`:
  dv_a = - sum m_j/rho_j v_ab,a grad W);
* the SPS sub-particle-scale stress (`SPSstressMatrixDevice`
  `visc_kernel.cu:760-810`): Smagorinsky nu_sps = (Cs dp)^2 |S|, Dalrymple &
  Rogers (2006) eq. 10/12, tau stored per particle over rho;
* the effective viscosity of the generalized-Newtonian rheologies
  (`effectiveViscDevice` `visc_kernel.cu:640-700`): viscShearTerm +
  viscYieldTerm with Papanastasiou regularization (`:440-540`), clamped to
  the limiting viscosity.

The "mixed tensor" convention is the reference's: diagonal entries hold
dv_a/da, off-diagonals the DOUBLED symmetric part (dv_a/db + dv_b/da).
Every pass takes ``cells``, the occupied cells of the rebuild.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..defs import RheologyType
from ..framework import SimFramework
from ..state import FG_SEDIMENT, ParticleState, fluid_num, has_flag, part_type
from . import eos
from .kernels import F as kernF
from .neighbors import CellAux, CellGrid
from .pair import neighbor_apply, split_vec

# component order of the 6-vector mixed tensor
XX, XY, XZ, YY, YZ, ZZ = range(6)


def shear_rate_tensor(fw: SimFramework, grid: CellGrid, state: ParticleState,
                      aux: CellAux, *, cells: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Mixed shear-rate tensor [N,6] (shearRate<MIXED_TENSOR>)."""
    sp = fw.sp
    h = sp.slength
    f_num = fluid_num(state.info)
    fields = dict(
        **split_vec("pos", state.pos),
        **split_vec("vel", state.vel),
        mass=state.mass,
        rho=eos.physical_density(fw.pp, state.rho, f_num),
        ptype=part_type(state.info),
    )

    def pair_fn(c, n, g):
        f = kernF(fw.kerneltype, g.r, h)
        coeff = torch.where(g.mask, n["mass"] / n["rho"] * f, 0.0)
        # dv_a/db = - sum m_j/rho_j (v_a,i - v_a,j) * rel_b * F
        out = {}
        for a in "xyz":
            rv = c[f"vel_{a}"] - n[f"vel_{a}"]
            for b, rel in zip("xyz", (g.relx, g.rely, g.relz)):
                out[f"d{a}{b}"] = -coeff * rv * rel
        return out

    s = neighbor_apply(grid, aux, fields, pair_fn,
                       max_parts_per_cell=sp.max_parts_per_cell,
                       influenceradius=sp.influenceradius, cells=cells)
    return torch.stack([
        s["dxx"],
        s["dxy"] + s["dyx"],
        s["dxz"] + s["dzx"],
        s["dyy"],
        s["dyz"] + s["dzy"],
        s["dzz"],
    ], dim=-1)


def shear_rate_norm2(tau: torch.Tensor) -> torch.Tensor:
    """2*S:S of a mixed tensor (shearRateNorm2<MIXED_TENSOR>)."""
    return (
        2.0 * (tau[..., XX] ** 2 + tau[..., YY] ** 2 + tau[..., ZZ] ** 2)
        + tau[..., XY] ** 2
        + tau[..., XZ] ** 2
        + tau[..., YZ] ** 2
    )


def sps_stress(fw: SimFramework, grid: CellGrid, state: ParticleState,
               aux: CellAux, *, cells: Optional[torch.Tensor] = None):
    """SPS tau [N,6] (stored over rho, as the reference does) and the
    turbulent viscosity nu [N]; the general forces pass takes tau."""
    pp = fw.pp
    tau = shear_rate_tensor(fw, grid, state, aux, cells=cells)
    SijSij_bytwo = shear_rate_norm2(tau)
    S = torch.sqrt(SijSij_bytwo)
    nu_sps = pp.smagfactor * S  # Dalrymple & Rogers (2006) eq. 12
    divu = (2.0 / 3.0) * nu_sps * (tau[..., XX] + tau[..., YY] + tau[..., ZZ])
    bline = pp.kspsfactor * SijSij_bytwo

    rho = eos.physical_density(pp, state.rho, fluid_num(state.info))
    out = torch.stack([
        (2.0 * nu_sps * tau[..., XX] - divu - bline) / rho,
        nu_sps * tau[..., XY] / rho,
        nu_sps * tau[..., XZ] / rho,
        (2.0 * nu_sps * tau[..., YY] - divu - bline) / rho,
        nu_sps * tau[..., YZ] / rho,
        (2.0 * nu_sps * tau[..., ZZ] - divu - bline) / rho,
    ], dim=-1)
    return out, nu_sps


def effective_viscosity(fw: SimFramework, grid: CellGrid, state: ParticleState,
                        aux: CellAux, *, effpres: Optional[torch.Tensor] = None,
                        cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-particle effective KINEMATIC viscosity [N] of a shear-dependent
    rheology (effectiveViscDevice).  ``effpres`` feeds the granular yield
    stress: the chunk passes the ``effpres`` extra, which the EFFPRES
    Jacobi solve (``ops/jacobi.py:jacobi_effpres``) refreshed just before;
    zeros when None."""
    pp = fw.pp
    rt = fw.visc.rheologytype
    f_num = fluid_num(state.info)
    rho = eos.physical_density(pp, state.rho, f_num)

    def per_fluid(attr):
        return eos._per_fluid(pp, f_num, [getattr(f, attr) for f in pp.fluids])

    tau = shear_rate_tensor(fw, grid, state, aux, cells=cells)
    shrate = torch.clamp(torch.sqrt(shear_rate_norm2(tau)), min=1e-10)

    # the stored visccoeff is the consistency index (dynamic units) for
    # generalized-Newtonian rheologies (GPUSPH.cc:1480-1510)
    consistency = eos._per_fluid(pp, f_num, [f.kinematic_visc * f.rho0 for f in pp.fluids])
    nonlin = per_fluid("visc_nonlinear_param")
    ys = per_fluid("yield_strength")
    regm = per_fluid("visc_regularization_param")

    # shear term (visc_kernel.cu:500-540)
    if rt in (RheologyType.POWER_LAW, RheologyType.HERSCHEL_BULKLEY,
              RheologyType.ALEXANDROU):
        shear_term = consistency * torch.pow(shrate, nonlin - 1.0)
    elif rt in (RheologyType.DEKEE_TURCOTTE, RheologyType.ZHU):
        shear_term = consistency * torch.exp(-nonlin * shrate)
    elif rt == RheologyType.GRANULAR:
        sinpsi = per_fluid("sinpsi")
        if effpres is None:
            effpres = torch.zeros_like(shrate)
        sqrt3 = torch.sqrt(torch.tensor(3.0, dtype=torch.float32, device=shrate.device))
        tau_y = 2.0 * sqrt3 * sinpsi / (3.0 - sinpsi) * effpres
        sediment = has_flag(state.info, FG_SEDIMENT)
        shear_term = torch.where(sediment, tau_y / shrate, consistency)
    else:  # BINGHAM / PAPANASTASIOU: linear
        shear_term = consistency

    # yield term (visc_kernel.cu:455-500)
    if rt in (RheologyType.BINGHAM, RheologyType.HERSCHEL_BULKLEY):
        yield_term = ys / shrate
    elif rt in (RheologyType.PAPANASTASIOU, RheologyType.ALEXANDROU,
                RheologyType.DEKEE_TURCOTTE, RheologyType.ZHU):
        # regularized: ys (1 - exp(-m shrate)) / shrate, -> ys m as shrate -> 0
        mx = regm * shrate
        reg = torch.where(mx < 1e-4, regm * (1.0 - 0.5 * mx),
                          (1.0 - torch.exp(-mx)) / shrate)
        yield_term = ys * reg
    else:
        yield_term = torch.zeros_like(shrate)

    effvisc_dyn = shear_term + yield_term
    limit = pp.limiting_kinvisc * per_fluid("rho0")
    if rt == RheologyType.GRANULAR:
        effvisc_dyn = torch.minimum(torch.maximum(effvisc_dyn, consistency), limit)
    else:
        effvisc_dyn = torch.minimum(effvisc_dyn, limit)

    # the forces pass takes the KINEMATIC effective viscosity
    return effvisc_dyn / rho


__all__ = [
    "shear_rate_tensor",
    "shear_rate_norm2",
    "sps_stress",
    "effective_viscosity",
]
