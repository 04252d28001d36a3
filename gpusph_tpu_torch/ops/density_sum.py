"""Density summation and dynamic gamma on SA walls.

Counterpart of the JAX package's ``ops/density_sum.py`` (the reference's
integral-form density update, `src/cuda/density_sum_kernel.cu`), in plain
PyTorch on ``ops/pair.py:neighbor_apply``.  Instead of integrating the
continuity equation, the new fluid density follows from the difference of
the kernel sums over the particles at step n and step n+1, and the wall's
share from gamma, carried as particle state (``extras["gamma"]`` and
``extras["gradgamma"]``) and integrated in time from the grad-gamma fluxes
(dynamic gamma, `USING_DYNAMIC_GAMMA`, `src/simflags.h`).  It runs after
each Euler half and full step (DENSITY_SUM, INTEGRATE_GAMMA,
`PredictorCorrectorIntegrator.cc:616-682`):

* ``volumic_terms``: sum_P m w^{n+1} - sum_P m w^n over fluid and vertex
  neighbors, with Hu & Adams' m_a/theta_a theta_b in place of m_b
  (`computeDensitySumVolumicTerms`, `density_sum_kernel.cu:200-322`);
* ``gamma_boundary_terms``: over segment neighbors, the trapezoidal
  increment sum_S h/2 (|grad gamma_as|^n + |grad gamma_as|^{n+1})
  (q^{n+1} - q^n) . n_s and the new grad gamma
  (`computeDensitySumBoundaryTerms`, `:422-483`), on the fluid-segment pairs
  alone (``ops/sa.py:PairSlots``);
* ``density_sum_update``: rho^{n+1} = (gamma^n rho^n + volumic sum) /
  gamma^{n+1}, gamma clipped after the update (`:606-655`);
* ``integrate_gamma``: gamma alone (`integrateGammaDevice`, `:669-684`);
* ``apply_density_diffusion``: the diffusion term as a pass of its own on
  the updated state (`PredictorCorrectorIntegrator.cc:641-661`);
* ``init_dynamic_gamma``: gamma and grad gamma seeded by quadrature
  (saInitGamma).

Each step's n+1 relative position of a fluid-segment pair is taken to the
neighbor's periodic image, as every other pair term takes it; the JAX
package leaves it unwrapped and so drops, on a periodic scene, the segments
across a periodic face from the n+1 grad gamma (ROADMAP section 3).  The
open-boundary branches (the inflow displacement, the imposed gamma) wait
for ROADMAP item 9b and raise.  Moving-body walls keep their segments'
vertex offsets rigid: only q changes between n and n+1, and vertices are
centrals too (`belem` is the n+1 normal at both ends of the trapezoid, as
in the JAX package).
"""
from __future__ import annotations

import torch

from ..defs import DensityDiffusionType, ParticleType, SPHFormulation
from ..state import fluid_num, part_type
from . import eos
from .forces import _density_diffusion
from .kernels import F as kernF
from .kernels import W as kernW
from .pair import min_image, neighbor_apply, split_vec
from .sa import PairSlots, compute_gamma, grad_gamma_wendland, sa_extra_fields, sa_pair_inputs


def _no_open_boundaries(fw, what):
    if fw.io is not None:
        raise NotImplementedError(
            f"{what}: not ported yet: open boundaries (ROADMAP item 9b)")


def _base_fields(state_n, new_pos):
    return dict(**split_vec("pos", state_n.pos), **split_vec("npos", new_pos),
                mass=state_n.mass, ptype=part_type(state_n.info))


def volumic_terms(fw, grid, state_n, new_pos, aux, *, cells=None):
    """The volumic sum of densitySumVolumicDevice per particle
    (`density_sum_kernel.cu:523-553`): over fluid and vertex neighbors of a
    fluid central, m w(r^{n+1}) - m w(r^n), each at the kernel's radius
    (the pass's search reaches dp/2 further, to catch pairs coming into
    range)."""
    _no_open_boundaries(fw, "density summation")
    sp = fw.sp
    h = sp.slength
    dev = state_n.pos.device
    rad = torch.tensor(sp.influenceradius, dtype=torch.float32, device=dev)
    rad2 = rad * rad
    ha = fw.sph_formulation == SPHFormulation.SPH_HA
    FLUID, VERTEX = ParticleType.FLUID, ParticleType.VERTEX
    wrap = min_image(grid, dev)

    fields = _base_fields(state_n, new_pos)
    if ha:
        # Hu & Adams: m_a/theta_a theta_b for m_b, theta = V0/dp^3
        # (density_sum_kernel.cu:257-322)
        rho0 = eos._per_fluid(fw.pp, fluid_num(state_n.info), [f.rho0 for f in fw.pp.fluids])
        fields["theta"] = state_n.mass / rho0 / sp.deltap**3

    def pair_fn(c, n, g):
        vol = (n["ptype"] == FLUID) | (n["ptype"] == VERTEX)
        base = g.mask & (c["ptype"] == FLUID) & vol
        if ha:
            m_eff = c["mass"] / torch.clamp(c["theta"], min=1e-30) * n["theta"]
        else:
            m_eff = n["mass"]
        # -sum m^n w^n
        wN = kernW(fw.kerneltype, g.r, h)
        sum_n = torch.where(base & (g.r2 < rad2), -m_eff * wN, 0.0)
        # +sum m^n w^{n+1}
        relx1 = wrap(c["npos_x"] - n["npos_x"], 0)
        rely1 = wrap(c["npos_y"] - n["npos_y"], 1)
        relz1 = wrap(c["npos_z"] - n["npos_z"], 2)
        r1 = torch.sqrt(relx1 * relx1 + rely1 * rely1 + relz1 * relz1)
        w1 = kernW(fw.kerneltype, r1, h)
        sum_np1 = torch.where(base & (r1 < rad), m_eff * w1, 0.0)
        return {"fw": sum_n + sum_np1}

    return neighbor_apply(grid, aux, fields, pair_fn,
                          max_parts_per_cell=sp.max_parts_per_cell,
                          influenceradius=sp.influenceradius + 0.5 * sp.deltap,
                          cells=cells)["fw"]


def gamma_boundary_terms(fw, grid, state_n, new_pos, aux, *, cells=None):
    """The trapezoidal gamma increment and the n+1 grad gamma over segment
    neighbors (`computeDensitySumBoundaryTerms`,
    `density_sum_kernel.cu:422-483`).  Returns per-particle sums
    ``ggdotr`` [N] and ``ggx/ggy/ggz`` [N]; fluid centrals, and vertices
    too where bodies move."""
    _no_open_boundaries(fw, "dynamic gamma")
    sp = fw.sp
    h = sp.slength
    inv_h = 1.0 / h
    FLUID, BOUND, VERTEX = ParticleType.FLUID, ParticleType.BOUNDARY, ParticleType.VERTEX
    wrap = min_image(grid, state_n.pos.device)
    central_vertex = fw.has_moving_bodies

    fields = _base_fields(state_n, new_pos)
    fields.update(sa_extra_fields(state_n))

    def pair_fn(c, n, g):
        c_ok = c["ptype"] == FLUID
        if central_vertex:
            c_ok = c_ok | (c["ptype"] == VERTEX)
        slots = PairSlots(g.mask & c_ok & (n["ptype"] == BOUND))
        take = slots.take
        qN, qvb, ns = sa_pair_inputs(n, g, h, slots)
        ggN = grad_gamma_wendland(qN, qvb, ns, h)
        # the n+1 relative position, at the neighbor's periodic image as
        # g.rel is (the JAX package leaves it unwrapped)
        q1 = tuple(wrap(take(c[f"npos_{ax}"]) - take(n[f"npos_{ax}"]), a) * inv_h
                   for a, ax in enumerate("xyz"))
        gg1 = grad_gamma_wendland(q1, qvb, ns, h)
        dq_dot_n = (q1[0] - qN[0]) * ns[0] + (q1[1] - qN[1]) * ns[1] + (q1[2] - qN[2]) * ns[2]
        return {
            # x h at the end (the reference multiplies gGamDotR by slength)
            "ggdotr": slots.put(0.5 * h * (ggN + gg1) * dq_dot_n),
            "ggx": slots.put(gg1 * ns[0]),
            "ggy": slots.put(gg1 * ns[1]),
            "ggz": slots.put(gg1 * ns[2]),
        }

    return neighbor_apply(grid, aux, fields, pair_fn,
                          max_parts_per_cell=sp.max_parts_per_cell,
                          influenceradius=sp.influenceradius + 0.5 * sp.deltap,
                          cells=cells)


def _gamma_update(state_n, sums):
    """(gamma^{n+1} unclipped, grad gamma^{n+1} [N,3]) from the pair sums."""
    gam1 = state_n.extras["gamma"] + sums["ggdotr"]
    gg1 = torch.stack([sums["ggx"], sums["ggy"], sums["ggz"]], dim=-1)
    return gam1, gg1


def density_sum_update(fw, grid, state_n, state_new, aux, *, cells=None):
    """DENSITY_SUM: ``state_new`` with its fluid densities from the
    kernel-sum difference between ``state_n``'s positions and its own, and
    its fluid gamma and grad gamma integrated (densitySumVolumicDevice +
    densitySumBoundaryDevice, `density_sum_kernel.cu:523,606`)."""
    sp = fw.sp
    ptype = part_type(state_n.info)
    is_fluid = ptype == ParticleType.FLUID
    f_num = fluid_num(state_n.info)

    fw_sum = volumic_terms(fw, grid, state_n, state_new.pos, aux, cells=cells)
    sums = gamma_boundary_terms(fw, grid, state_n, state_new.pos, aux, cells=cells)
    gam1, gg1 = _gamma_update(state_n, sums)

    gam_n = state_n.extras["gamma"]
    rho_n_phys = eos.physical_density(fw.pp, state_n.rho, f_num)
    rho1_phys = (gam_n * rho_n_phys + fw_sum) / torch.clamp(gam1, min=1e-6)
    rho1 = eos.numerical_density(fw.pp, rho1_phys, f_num)

    # gamma clipped AFTER the density update (density_sum_kernel.cu:643-648)
    gg_norm = torch.linalg.vector_norm(gg1, dim=-1) * sp.slength
    gam1 = torch.where((gam1 > 1.0) | (gg_norm < 1e-10), 1.0, gam1)
    gam1 = torch.clamp(gam1, min=0.1)

    extras = dict(state_new.extras)
    extras["gamma"] = torch.where(is_fluid, gam1, extras["gamma"])
    extras["gradgamma"] = torch.where(is_fluid[:, None], gg1, extras["gradgamma"])
    return state_new.replace(rho=torch.where(is_fluid, rho1, state_new.rho), extras=extras)


def integrate_gamma(fw, grid, state_n, state_new, aux, *, cells=None):
    """INTEGRATE_GAMMA (dynamic gamma without density summation): gamma^{n+1}
    = gamma^n + the trapezoidal increment, grad gamma from the n+1 geometry
    (`integrateGammaDeviceFunc`, `density_sum_kernel.cu:669-684`); fluid
    rows, and vertices too where bodies move."""
    ptype = part_type(state_n.info)
    upd = ptype == ParticleType.FLUID
    if fw.has_moving_bodies:
        upd = upd | (ptype == ParticleType.VERTEX)
    sums = gamma_boundary_terms(fw, grid, state_n, state_new.pos, aux, cells=cells)
    gam1, gg1 = _gamma_update(state_n, sums)
    extras = dict(state_new.extras)
    extras["gamma"] = torch.where(upd, gam1, extras["gamma"])
    extras["gradgamma"] = torch.where(upd[:, None], gg1, extras["gradgamma"])
    return state_new.replace(extras=extras)


def apply_density_diffusion(fw, grid, state, aux, dt, *, cells=None):
    """CALC/APPLY_DENSITY_DIFFUSION: with density summation the diffusion
    runs as a pass of its own on the updated state and adds dt x its rate
    to the fluid density (`PredictorCorrectorIntegrator.cc:641-661`), over
    fluid-fluid pairs with the general pass's formulas
    (``ops/forces.py:_density_diffusion``) under the constant gravity."""
    if fw.densitydiffusiontype == DensityDiffusionType.NONE:
        return state
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    FLUID = ParticleType.FLUID
    f_num = fluid_num(state.info)
    ptype = part_type(state.info)
    fields = dict(
        **split_vec("pos", state.pos),
        **split_vec("vel", state.vel),
        mass=state.mass,
        rho=eos.physical_density(pp, state.rho, f_num),
        press=eos.pressure(pp, state.rho, f_num),
        sspeed=eos.sound_speed(pp, state.rho, f_num),
        ptype=ptype,
        f_num=f_num,
    )

    def pair_fn(c, n, g):
        f = kernF(fw.kerneltype, g.r, h)
        ff = g.mask & (c["ptype"] == FLUID) & (n["ptype"] == FLUID)
        return {"dd": _density_diffusion(fw, c, n, g, f, ff, dt, pp.gravity)}

    dd = neighbor_apply(grid, aux, fields, pair_fn,
                        max_parts_per_cell=sp.max_parts_per_cell,
                        influenceradius=sp.influenceradius, cells=cells)["dd"]
    # the rate is in physical units; the state holds the relative density
    rho0 = eos._per_fluid(pp, f_num, [f.rho0 for f in pp.fluids])
    return state.replace(rho=torch.where(ptype == FLUID, state.rho + dt * dd / rho0,
                                         state.rho))


def init_dynamic_gamma(fw, grid, state, aux, *, cells=None):
    """saInitGamma: ``state`` with gamma and grad gamma seeded by quadrature
    (``ops/sa.py:compute_gamma``)."""
    gamma, ggam = compute_gamma(fw, grid, state, aux, cells=cells)
    return state.replace(extras=dict(state.extras, gamma=gamma, gradgamma=ggam))


__all__ = [
    "volumic_terms",
    "gamma_boundary_terms",
    "density_sum_update",
    "integrate_gamma",
    "apply_density_diffusion",
    "init_dynamic_gamma",
]
