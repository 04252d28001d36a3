"""Grenier's multi-fluid sigma/volume formulation: the density and sigma pass.

Counterpart of the JAX package's ``ops/grenier.py`` (the reference's
COMPUTE_DENSITY phase for SPH_GRENIER, `densityGrenierDevice`
`src/cuda/forces_kernel.cu:286-350`), in plain PyTorch over
``ops/pair.neighbor_apply``:

* sigma_a = W(0) + sum_b W_ab, the number density over the neighbors the
  pass takes (fluid, plus boundary with DYN boundaries);
* the smoothed density rho_a = (m_a W(0) + sum_{b same} m_b W_ab) /
  ((W(0) + sum_{b same} W_ab) * omega_a), where "same" is the same fluid
  (and type, with DYN boundaries) and omega_a = exp(J_a) V0_a the
  particle's actual volume (J evolved by the continuity equation,
  `euler_kernel.def:213-216`).

The general forces pass then uses the sigma-weighted operators
(`ops/forces.py`, Grenier branches).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..defs import BoundaryType, ParticleType
from ..state import fluid_num, part_type
from . import eos
from .kernels import W as kernW
from .pair import neighbor_apply, split_vec


def grenier_volume(state):
    """Actual particle volume omega = exp(J) * V0."""
    return torch.exp(state.extras["grenier_J"]) * state.extras["grenier_vol0"]


def grenier_density_sigma(fw, grid, state, aux, *, cells: Optional[torch.Tensor] = None):
    """Returns (sigma [N], rho_tilde [N]) for the current configuration;
    ``cells`` are the occupied cells of the rebuild."""
    sp = fw.sp
    h = sp.slength
    vol = grenier_volume(state)
    ptype = part_type(state.info)
    f_num = fluid_num(state.info)
    fields = dict(**split_vec("pos", state.pos), mass=state.mass, ptype=ptype, f_num=f_num)
    dyn = fw.boundarytype == BoundaryType.DYN_BOUNDARY

    def pair_fn(c, n, g):
        n_ok = n["ptype"] == ParticleType.FLUID
        if dyn:
            n_ok = n_ok | (n["ptype"] == ParticleType.BOUNDARY)
        ok = g.mask & n_ok
        w = kernW(fw.kerneltype, g.r, h)
        # smoothed mass: same fluid, and same type with DYN boundaries
        # (forces_kernel.cu:330-340)
        same = c["f_num"] == n["f_num"]
        if dyn:
            same = same & (c["ptype"] == n["ptype"])
        wm = torch.where(ok & same, w, 0.0)
        return {"sigma": torch.where(ok, w, 0.0), "corr": wm, "mass_corr": wm * n["mass"]}

    sums = neighbor_apply(grid, aux, fields, pair_fn,
                          max_parts_per_cell=sp.max_parts_per_cell,
                          influenceradius=sp.influenceradius, cells=cells)
    w0 = kernW(fw.kerneltype, torch.zeros((), dtype=torch.float32, device=vol.device), h)
    sigma = sums["sigma"] + w0
    corr = sums["corr"] + w0
    mass_corr = sums["mass_corr"] + state.mass * w0

    rho_phys = mass_corr / (corr * torch.clamp(vol, min=1e-30))
    rho_tilde = eos.numerical_density(fw.pp, rho_phys, f_num)

    # only fluid (and DYN boundary) particles get the smoothed density
    upd = ptype == ParticleType.FLUID
    if dyn:
        upd = upd | (ptype == ParticleType.BOUNDARY)
    return sigma, torch.where(upd, rho_tilde, state.rho)


__all__ = ["grenier_density_sigma", "grenier_volume"]
