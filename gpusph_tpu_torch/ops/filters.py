"""Density filters: Shepard and MLS.

Counterpart of the JAX package's ``ops/filters.py`` (the reference's
`shepardDevice` `src/cuda/forces_kernel.cu:422-505` and `MlsDevice`
`:512-737`), run every N iterations at the start of a step (FILTER phase,
`src/integrators/PredictorCorrectorIntegrator.cc:800-877`).

Both filters renormalize the fluid density from the current particle
distribution, in two plain PyTorch passes over ``ops/pair.neighbor_apply``
(one for Shepard).  Neighbor set: FLUID particles, plus BOUNDARY particles
under DYN boundaries.  The MLS 4x4 symmetric system is solved in closed form
through the first row of its adjugate, with the JAX package's regularisation
of near-singular neighborhoods.

Every pass takes ``cells``, the occupied cells of the rebuild
(``neighbor_apply``'s default finds them, which waits for the device).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..defs import BoundaryType, FilterType, ParticleType
from ..framework import SimFramework
from ..state import ParticleState, fluid_num, part_type
from . import eos
from .kernels import W as kernW
from .neighbors import CellAux, CellGrid
from .pair import neighbor_apply, split_vec


def _filter_fields(fw: SimFramework, state: ParticleState):
    f_num = fluid_num(state.info)
    return dict(
        **split_vec("pos", state.pos),
        mass=state.mass,
        rho=eos.physical_density(fw.pp, state.rho, f_num),
        ptype=part_type(state.info),
    )


def _neib_ok(fw: SimFramework, n_ptype):
    ok = n_ptype == ParticleType.FLUID
    if fw.boundarytype == BoundaryType.DYN_BOUNDARY:
        ok = ok | (n_ptype == ParticleType.BOUNDARY)
    return ok


def _apply(fw: SimFramework, grid: CellGrid, aux: CellAux, fields, pair_fn, cells):
    sp = fw.sp
    return neighbor_apply(grid, aux, fields, pair_fn,
                          max_parts_per_cell=sp.max_parts_per_cell,
                          influenceradius=sp.influenceradius, cells=cells)


def _self_w(fw: SimFramework, like: torch.Tensor) -> torch.Tensor:
    """W(0), the self term of every sum."""
    return kernW(fw.kerneltype, torch.zeros((), dtype=torch.float32, device=like.device),
                 fw.sp.slength)


def _set_fluid_rho(fw: SimFramework, state: ParticleState, rho_phys) -> ParticleState:
    f_num = fluid_num(state.info)
    new_rho = eos.numerical_density(fw.pp, rho_phys, f_num)
    fluid = part_type(state.info) == ParticleType.FLUID
    return state.replace(rho=torch.where(fluid, new_rho, state.rho))


def shepard_filter(fw: SimFramework, grid: CellGrid, state: ParticleState,
                   aux: CellAux, *, cells: Optional[torch.Tensor] = None
                   ) -> ParticleState:
    """Zeroth-order Shepard renormalization of the fluid density."""
    h = fw.sp.slength
    fields = _filter_fields(fw, state)

    def pair_fn(c, n, g):
        ok = g.mask & _neib_ok(fw, n["ptype"])
        w = kernW(fw.kerneltype, g.r, h) * n["mass"]
        return {"num": torch.where(ok, w, 0.0), "den": torch.where(ok, w / n["rho"], 0.0)}

    sums = _apply(fw, grid, aux, fields, pair_fn, cells)
    self_num = state.mass * _self_w(fw, state.mass)
    num = sums["num"] + self_num
    den = sums["den"] + self_num / fields["rho"]
    return _set_fluid_rho(fw, state, num / den)


def _sym4_det(m):
    """Determinant of a symmetric 4x4 given as a dict of its 10 upper
    components (reference `src/cuda/tensor.cu` det)."""
    a, b, c, d = m["xx"], m["xy"], m["xz"], m["xw"]
    e, f, g = m["yy"], m["yz"], m["yw"]
    h, i = m["zz"], m["zw"]
    j = m["ww"]
    # full symmetric matrix [[a,b,c,d],[b,e,f,g],[c,f,h,i],[d,g,i,j]]
    return (
        a * (e * (h * j - i * i) - f * (f * j - i * g) + g * (f * i - h * g))
        - b * (b * (h * j - i * i) - f * (c * j - i * d) + g * (c * i - h * d))
        + c * (b * (f * j - g * i) - e * (c * j - i * d) + g * (c * g - f * d))
        - d * (b * (f * i - g * h) - e * (c * i - h * d) + f * (c * g - f * d))
    )


def _sym4_adjugate_row1(m):
    """First row of the adjugate of the symmetric 4x4 (reference
    `adjugate_row1`, `src/cuda/tensor.cu`): M^-1 e1 times det."""
    b, c, d = m["xy"], m["xz"], m["xw"]
    e, f, g = m["yy"], m["yz"], m["yw"]
    h, i = m["zz"], m["zw"]
    j = m["ww"]
    a11 = e * (h * j - i * i) - f * (f * j - g * i) + g * (f * i - g * h)
    a12 = -(b * (h * j - i * i) - f * (c * j - d * i) + g * (c * i - d * h))
    a13 = b * (f * j - g * i) - e * (c * j - d * i) + g * (c * g - d * f)
    a14 = -(b * (f * i - g * h) - e * (c * i - d * h) + f * (c * g - d * f))
    return a11, a12, a13, a14


def mls_filter(fw: SimFramework, grid: CellGrid, state: ParticleState,
               aux: CellAux, *, cells: Optional[torch.Tensor] = None
               ) -> ParticleState:
    """First-order MLS renormalization of the fluid density."""
    h = fw.sp.slength
    fields = _filter_fields(fw, state)

    # pass 1: the MLS moment matrix (relative positions scaled by h)
    def mls_matrix(c, n, g):
        ok = g.mask & _neib_ok(fw, n["ptype"])
        w = torch.where(ok, kernW(fw.kerneltype, g.r, h) * n["mass"] / n["rho"], 0.0)
        x, y, z = g.relx / h, g.rely / h, g.relz / h
        return {
            "xx": w,
            "xy": w * x, "xz": w * y, "xw": w * z,
            "yy": w * x * x, "yz": w * x * y, "yw": w * x * z,
            "zz": w * y * y, "zw": w * y * z,
            "ww": w * z * z,
        }

    M = _apply(fw, grid, aux, fields, mls_matrix, cells)
    # the self term enters only the constant moment
    w0 = _self_w(fw, state.mass)
    M["xx"] = M["xx"] + state.mass * w0 / fields["rho"]

    det = _sym4_det(M)
    # near-singular neighborhoods (thin sheets, isolated particles): add
    # eps*I, as the JAX package does (reference fallback,
    # forces_kernel.cu:617-630)
    eps = torch.where(det.abs() < 1e-7, det.abs() + 1e-7, 0.0)
    Mr = dict(M)
    for k in ("xx", "yy", "zz", "ww"):
        Mr[k] = Mr[k] + eps
    det_r = _sym4_det(Mr)
    b0, b1, b2, b3 = (a / det_r for a in _sym4_adjugate_row1(Mr))
    # the linear coefficients back to world units
    fields2 = dict(fields, B0=b0, B1=b1 / h, B2=b2 / h, B3=b3 / h)

    # pass 2: the corrected density sum
    def mls_sum(c, n, g):
        ok = g.mask & _neib_ok(fw, n["ptype"])
        w = kernW(fw.kerneltype, g.r, h) * n["mass"]
        corr = c["B0"] + c["B1"] * g.relx + c["B2"] * g.rely + c["B3"] * g.relz
        return {"rho": torch.where(ok, w * corr, 0.0)}

    sums = _apply(fw, grid, aux, fields2, mls_sum, cells)
    return _set_fluid_rho(fw, state, sums["rho"] + b0 * w0 * state.mass)


FILTERS = {
    FilterType.SHEPARD: shepard_filter,
    FilterType.MLS: mls_filter,
}


def filters_due(fw: SimFramework, iteration: int):
    """The filters that run at the start of global iteration ``iteration``:
    each enabled one whose ``iteration % freq == freq - 1``."""
    return [FILTERS[FilterType(ftype)] for ftype, freq in fw.filters
            if freq > 0 and iteration % freq == freq - 1]


def apply_filters(fw: SimFramework, grid: CellGrid, state: ParticleState,
                  aux: CellAux, iteration: int, *,
                  cells: Optional[torch.Tensor] = None) -> ParticleState:
    """Run each enabled filter that is due at ``iteration`` (a host int: the
    cadence costs no device sync)."""
    for fn in filters_due(fw, iteration):
        state = fn(fw, grid, state, aux, cells=cells)
    return state


__all__ = ["shepard_filter", "mls_filter", "apply_filters", "filters_due", "FILTERS"]
