"""The general forces pass: SPH continuity + momentum right-hand sides.

Counterpart of the JAX package's ``ops/forces.py`` (the reference's forces
megakernel, `forcesDevice` `src/cuda/forces_kernel.def:3923-4036`, and its
per-model contribution templates).  Every particle-type pair is computed in
one dense masked pass over cell blocks (``ops/pair.py:neighbor_apply``), in
plain PyTorch: it serves the configurations outside the hand kernel's
``kernel_supported`` (`ops/forces_kernel.py`), whose pass carries the same
physics for its subset.

Physics (reference anchor in parentheses):

* continuity, F1/F2, Grenier (DJ/Dt) and Hu & Adams forms
  (`forces_kernel.def:2016-2189`)
* pressure gradient: F1 P/rho^2, F2, Hu & Adams volumes, Grenier P/sigma
  with the pseudo surface tension between fluids (`:2212-2470`)
* artificial viscosity (`visc_kernel.cu:75-86`)
* Morris laminar viscosity with arithmetic/harmonic/geometric averaging
  (`:2606-2646`), Monaghan (`:2531-2561`), Espanol & Revenga (`:2650-2678`)
* SPS sub-particle-scale stress (`:2770-2790`)
* Lennard-Jones / Monaghan-Kajtar boundary repulsion (`forces_kernel.cu:75-133`)
* density diffusion: Ferrari / Molteni & Colagrossi / Brezzi, with the
  Grenier and Hu & Adams variants (`:1582-1996`)
* XSPH (reference factor 2) and internal energy (`:2986-2994`, `:3306-3316`)
* moving-body feedback rows, planes, a DEM terrain and a time-dependent
  gravity
* SA boundaries (`ops/sa.py`): vertices as volumic neighbors, the segment
  continuity term (`:2078-2091`) and pressure term (`:2416-2430`) with the
  analytic grad gamma, at a search radius expanded by dp/2

The finalize step (Grenier's fixup, the SA division by gamma, gravity, rho0
scaling, the CFL maxima) mirrors `finalizeforcesDevice`
(`forces_kernel.def:4037-4110`, fixup `:3183-3240`) and ``dtreduce``
(`forces.cu:557-600`).  Only the k-epsilon model raises
``NotImplementedError``: it waits for its slice (ROADMAP item 9a).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..defs import (
    AverageOperator,
    BoundaryType,
    DensityDiffusionType,
    ParticleType,
    SimFlags,
    SPHFormulation,
    TurbulenceModel,
    ViscousModel,
)
from ..state import fluid_num, part_type
from . import eos
from .kernels import F as kernF
from .kernels import W as kernW
from .pair import merge_vec, neighbor_apply, split_vec
from .sa import PairSlots, grad_gamma_wendland, sa_extra_fields, sa_pair_inputs


@dataclasses.dataclass
class ForcesOut:
    """Per-particle RHS + reduction results of one forces pass
    (the analogue of BUFFER_FORCES + BUFFER_XSPH + BUFFER_CFL)."""

    DvDt: torch.Tensor  # f32[N,3] acceleration
    DrDt: torch.Tensor  # f32[N] relative-density rate (already /rho0); Grenier: DJ/Dt
    xsph: torch.Tensor  # f32[N,3] XSPH mean velocity correction (zeros if off)
    DEDt: torch.Tensor  # f32[N] internal-energy rate (zeros unless enabled)
    max_accel: torch.Tensor  # f32[] max |a| over fluid particles (CFL force term)
    max_sspeed: torch.Tensor  # f32[] max local sound speed (CFL sound term)
    max_kinvisc: torch.Tensor  # f32[] max kinematic viscosity (CFL visc term)


def _powf(x, e: float):
    """x**e with exact repeated multiplication for small integer exponents
    (the LJ exponents are typically 12 and 6), in the JAX package's order."""
    if e == int(e) and 0 <= int(e) <= 16:
        n = int(e)
        out = torch.ones_like(x)
        base = x
        while n:
            if n & 1:
                out = out * base
            n >>= 1
            if n:
                base = base * base
        return out
    return x**e


def _avg(avgop: AverageOperator, a, b):
    """Pairwise averaging operators (reference `src/average.h`)."""
    if avgop == AverageOperator.ARITHMETIC:
        return 0.5 * (a + b)
    if avgop == AverageOperator.HARMONIC:
        return 2.0 * a * b / (a + b + 1e-30)
    return torch.sqrt(a * b)


def _unported(fw) -> Optional[str]:
    """The branch of the JAX pass this one lacks for ``fw``, or None."""
    if fw.visc.turbmodel == TurbulenceModel.KEPSILON:
        return "the k-epsilon model (ROADMAP item 9)"
    return None


def _pair_fields(fw, state, sps_tau=None, effvisc=None, sigma=None):
    """Per-particle scalar fields fed to the pair pass.

    ``sps_tau``/``effvisc`` are the per-step outputs of the viscosity engine
    (CALC_VISC, recomputed before every forces pass); ``sigma`` is
    Grenier's per-particle number density from the COMPUTE_DENSITY phase."""
    pp = fw.pp
    f_num = fluid_num(state.info)
    rho_phys = eos.physical_density(pp, state.rho, f_num)
    press = eos.pressure(pp, state.rho, f_num)
    fields = dict(
        **split_vec("pos", state.pos),
        **split_vec("vel", state.vel),
        mass=state.mass,
        rho=rho_phys,
        press=press,
        sspeed=eos.sound_speed(pp, state.rho, f_num),
        ptype=part_type(state.info),
        f_num=f_num,
    )
    # the momentum pressure; k-epsilon would add its turbulent pressure here
    # (pressure_for_precalc, forces_kernel.def:396-401)
    fields["press_mom"] = press
    if fw.sph_formulation == SPHFormulation.SPH_GRENIER:
        # Grenier precalc is P/sigma (forces_kernel.def:445-455)
        if sigma is None:
            sigma = torch.ones_like(press)
        fields["sigma"] = sigma
        fields["p_precalc"] = press / torch.clamp(sigma, min=1e-30)
        fields["g_vol"] = torch.exp(state.extras["grenier_J"]) * state.extras["grenier_vol0"]
    elif fw.sph_formulation == SPHFormulation.SPH_HA:
        # Hu & Adams precalc is plain P (forces_kernel.def:458-467)
        fields["p_precalc"] = press
    elif fw.sph_formulation != SPHFormulation.SPH_F2:
        # F1 and friends use P/rho^2 (forces_kernel.def:416-467)
        fields["p_precalc"] = press / (rho_phys * rho_phys)
    if not fw.is_inviscid:
        # per-particle dynamic viscosity for the laminar term; shear-dependent
        # rheologies give the effective kinematic viscosity
        visccoeff = (effvisc if effvisc is not None else
                     eos._per_fluid(pp, f_num, [f.kinematic_visc for f in pp.fluids]))
        fields["dyn_visc"] = visccoeff * rho_phys
        fields["kinvisc"] = visccoeff
        if fw.visc.viscmodel == ViscousModel.ESPANOL_REVENGA:
            # second (bulk) viscosity, always dynamic (d_visc2coeff,
            # forces_kernel.def:293-301)
            fields["bulk_visc"] = eos._per_fluid(pp, f_num, [f.bulk_visc for f in pp.fluids])
    if fw.visc.turbmodel == TurbulenceModel.SPS:
        if sps_tau is None:
            sps_tau = torch.zeros((state.capacity, 6), dtype=torch.float32,
                                  device=press.device)
        for c in range(6):
            fields[f"sps_tau{c}"] = sps_tau[:, c]
    if fw.sa_boundary:
        fields.update(sa_extra_fields(state))
    return fields


def gravity_vector(fw, t=None, device="cpu"):
    """The gravity of a pass at the 0-d f32 time ``t`` (0 on ``device`` when
    None): ``fw.gcallback(t)`` where the problem set one (three 0-d tensors
    on ``t``'s device, nothing read back to the host), else the constant
    ``pp.gravity``."""
    if fw.gcallback is None:
        return tuple(fw.pp.gravity)
    if t is None:
        t = torch.zeros((), dtype=torch.float32, device=device)
    return tuple(torch.as_tensor(c, dtype=torch.float32, device=t.device)
                 for c in fw.gcallback(t))


def compute_forces(fw, grid, state, aux, *, dt=None, sps_tau=None, effvisc=None,
                   sigma=None, t=None, cells=None, gamma=None) -> ForcesOut:
    """One forces pass over the (sorted) particle state on the general pair
    path.  ``dt`` feeds Brezzi's diffusion, ``t`` the gravity callback;
    ``cells`` are the occupied cells of the rebuild (``neighbor_apply``'s
    default finds them, which waits for the device); ``gamma`` is the SA
    wall-renormalization factor of ``ops/sa.py:compute_gamma`` (1 when
    None)."""
    missing = _unported(fw)
    if missing is not None:
        raise NotImplementedError(f"the general forces pass: not ported yet: {missing}")
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    fields = _pair_fields(fw, state, sps_tau=sps_tau, effvisc=effvisc, sigma=sigma)
    gvec = gravity_vector(fw, t, state.pos.device)

    eps = pp.epsartvisc
    dyn = fw.boundarytype == BoundaryType.DYN_BOUNDARY
    grenier = fw.sph_formulation == SPHFormulation.SPH_GRENIER
    ha = fw.sph_formulation == SPHFormulation.SPH_HA
    f2 = fw.sph_formulation == SPHFormulation.SPH_F2
    sa = fw.sa_boundary
    FLUID, BOUND, VERTEX = ParticleType.FLUID, ParticleType.BOUNDARY, ParticleType.VERTEX
    # SA: the pair mask reaches dp/2 past the influence radius for the
    # segments (boundNlSqInflRad); the volumic terms still cut at the
    # influence radius, since W and F are not masked beyond 2h
    nl_radius = sp.influenceradius + (0.5 * sp.deltap if sa else 0.0)
    kernel_rad2 = torch.tensor(sp.influenceradius**2, dtype=torch.float32,
                               device=state.pos.device)

    def pair_fn(c, n, g):
        f = kernF(fw.kerneltype, g.r, h)  # [C,K,NB]

        relvx = c["vel_x"] - n["vel_x"]
        relvy = c["vel_y"] - n["vel_y"]
        relvz = c["vel_z"] - n["vel_z"]
        vel_dot_pos = g.dot_rel(relvx, relvy, relvz)

        c_fluid = c["ptype"] == FLUID
        n_fluid = n["ptype"] == FLUID
        c_bound = c["ptype"] == BOUND
        n_bound = n["ptype"] == BOUND
        m_n = n["mass"]
        rho_c = c["rho"]
        rho_n = n["rho"]
        if sa:
            # vertices are mass-carrying volumic neighbors; segments add
            # only the grad-gamma terms of fluid centrals
            gmask = g.mask & (g.r2 < kernel_rad2)
            n_vol = n_fluid | (n["ptype"] == VERTEX)
            seg_mask = g.mask & c_fluid & n_bound
            slots = PairSlots(seg_mask)  # grad gamma on the segment pairs alone
            ggamAS = slots.put(grad_gamma_wendland(*sa_pair_inputs(n, g, h, slots), h))
            ns = (n["nrm_x"], n["nrm_y"], n["nrm_z"])
        else:
            gmask = g.mask
        ff_mask = gmask & c_fluid & n_fluid

        out = {}
        # --- continuity (forces_kernel.def:2139-2155): with DYN boundaries,
        # boundary particles both receive and produce continuity terms; with
        # LJ/MK boundaries they take no part in it
        if dyn:
            cont_mask = g.mask & (c_fluid | c_bound) & (n_fluid | n_bound)
        elif sa:
            cont_mask = gmask & c_fluid & n_vol
        else:
            cont_mask = ff_mask
        if grenier:
            # DJ/Dt = -(1/sigma) sum (v.r) F: no neighbor mass, 1/sigma in
            # the finalize (forces_kernel.def:2016-2028, fixup :3183-3190)
            DrDt_term = -vel_dot_pos * f
        elif ha:
            # the central mass replaces the neighbor mass (:2031-2046)
            DrDt_term = c["mass"] * vel_dot_pos * f
        else:
            DrDt_term = m_n * vel_dot_pos * f
            if f2:
                # density-ratio correction (:2156-2171)
                DrDt_term = DrDt_term * rho_c / rho_n
        DrDt = torch.where(cont_mask, DrDt_term, 0.0)
        if sa:
            # the SA boundary continuity term (forces_kernel.def:2078-2091):
            # DrDt -= rho_a (v_as . n_s) ||grad gamma_as||
            DrDt = DrDt - torch.where(
                seg_mask, rho_c * (relvx * ns[0] + relvy * ns[1] + relvz * ns[2]) * ggamAS,
                0.0)
        out["DrDt"] = DrDt + _density_diffusion(fw, c, n, g, f, ff_mask, dt, gvec)

        # --- momentum: pressure gradient ------------------------------------
        if sa:
            mom_mask = gmask & c_fluid & n_vol
        else:
            mom_mask = g.mask & c_fluid & ((n_fluid | n_bound) if dyn else n_fluid)
        if fw.has_moving_bodies:
            # body force feedback: boundary centrals accumulate the
            # hydrodynamic terms from fluid neighbors; euler ignores them,
            # the bodies subsystem reduces them per object
            mom_mask = mom_mask | (g.mask & c_bound & n_fluid)
        if f2:
            pgrad = (c["press_mom"] + n["press_mom"]) / (rho_c * rho_n)
        else:
            pgrad = c["p_precalc"] + n["p_precalc"]
        if ha:
            # (P_a V_a^2 + P_b V_b^2) with the volumes V = m/rho, weighted
            # 1/m_a (forces_kernel.def:2267-2285, :2432-2447)
            m_c = torch.clamp(c["mass"], min=1e-30)  # pad rows have zero mass
            v_c = m_c / rho_c
            v_n = m_n / rho_n
            pgrad = c["p_precalc"] * v_c * v_c + n["p_precalc"] * v_n * v_n
            s = torch.where(mom_mask, -(pgrad / m_c * f), 0.0)
        elif grenier:
            # pseudo surface tension between different fluids (:2212-2242)
            if pp.epsinterface != 0.0:
                diff_fluid = c["f_num"] != n["f_num"]
                pgrad = pgrad + torch.where(
                    diff_fluid & c_fluid & n_fluid,
                    pp.epsinterface * (torch.abs(c["p_precalc"]) + torch.abs(n["p_precalc"])),
                    0.0)
            # no neighbor mass; the 1/rho_a factor comes in the finalize
            # (forces_kernel.def:2386-2392)
            s = torch.where(mom_mask, -(pgrad * f), 0.0)
        else:
            # scalar pair coefficient s such that DvDt += s * rel
            s = torch.where(mom_mask, -(pgrad * m_n * f), 0.0)

        # --- viscosity --------------------------------------------------------
        if fw.visc.turbmodel == TurbulenceModel.ARTIFICIAL:
            # Monaghan artificial viscosity (visc_kernel.cu:75-86)
            art = (vel_dot_pos * (h * pp.artvisccoeff) * (c["sspeed"] + n["sspeed"])
                   / ((g.r2 + eps) * (rho_c + rho_n)))
            s = s + torch.where(mom_mask & (vel_dot_pos < 0.0), art * m_n * f, 0.0)

        sv = None  # accumulated relative-velocity coefficient
        if not fw.is_inviscid and fw.visc.viscmodel == ViscousModel.ESPANOL_REVENGA:
            # Espanol & Revenga volumic term (forces_kernel.def:2650-2678):
            # DvDt += coeff [(5 mu/3 - zeta) v_ab + 5 (mu/3 + zeta) (v.r)/(r^2+eps) r_ab]
            # with coeff = m_b/(rho_a rho_b) F  (Grenier: (1/s_a+1/s_b) F)
            visc_thirds = _avg(fw.visc.avgop, c["dyn_visc"], n["dyn_visc"]) / 3.0
            bulk = _avg(fw.visc.avgop, c["bulk_visc"], n["bulk_visc"])
            if grenier:
                vvc = (1.0 / c["sigma"] + 1.0 / n["sigma"]) * f
            else:
                vvc = m_n / (rho_c * rho_n) * f
            sv = torch.where(mom_mask, vvc * (5.0 * visc_thirds - bulk), 0.0)
            s = s + torch.where(
                mom_mask, vvc * 5.0 * (visc_thirds + bulk) * vel_dot_pos / (g.r2 + eps), 0.0)
        elif not fw.is_inviscid:
            # laminar term (forces_kernel.def:2606-2626 + visc_avg.cu):
            # DvDt += 2 avg(mu) m_j/(rho_i rho_j) F * (viscous vector)
            mu_avg = _avg(fw.visc.avgop, c["dyn_visc"], n["dyn_visc"])
            if grenier:
                # volumic coefficient (1/sigma_a + 1/sigma_b); 1/rho_a comes
                # from the fixup (forces_kernel.def:2633-2646, :2580-2586)
                visc_coeff = mu_avg * (1.0 / c["sigma"] + 1.0 / n["sigma"])
            else:
                visc_coeff = 2.0 * mu_avg * m_n / (rho_c * rho_n)
            if fw.visc.viscmodel == ViscousModel.MONAGHAN:
                # projection form (forces_kernel.def:2531-2561)
                mon = torch.where(vel_dot_pos < 0, vel_dot_pos / (g.r2 + eps), 0.0)
                coeff = pp.monaghan_visc_coeff
                if coeff != coeff:  # NaN -> default 1
                    coeff = 1.0
                s = s + torch.where(mom_mask, coeff * visc_coeff * f * mon, 0.0)
            else:  # MORRIS
                sv = torch.where(mom_mask, visc_coeff * f, 0.0)

        extra = None
        if fw.visc.turbmodel == TurbulenceModel.SPS:
            # SPS stress: DvDt += m_j F (tau_i + tau_j) . r_ij
            # (forces_kernel.def:2770-2790); tau as upper-tri 6-vector
            t0, t1, t2, t3, t4, t5 = (c[f"sps_tau{k}"] + n[f"sps_tau{k}"] for k in range(6))
            mf = torch.where(mom_mask, m_n * f, 0.0)
            extra = (mf * (t0 * g.relx + t1 * g.rely + t2 * g.relz),
                     mf * (t1 * g.relx + t3 * g.rely + t4 * g.relz),
                     mf * (t2 * g.relx + t4 * g.rely + t5 * g.relz))

        # --- repulsive boundary force (LJ / MK) -------------------------------
        if fw.repulsive_boundary:
            rep_mask = g.mask & c_fluid & n_bound
            if fw.boundarytype == BoundaryType.LJ_BOUNDARY:
                # LJForce (forces_kernel.cu:75-103)
                safe_r = torch.clamp(g.r, min=1e-3 * pp.r0)
                ratio = pp.r0 / safe_r
                lj = (pp.dcoeff * (_powf(ratio, pp.p1coeff) - _powf(ratio, pp.p2coeff))
                      / (safe_r * safe_r))
                lj = torch.clamp(lj, max=1e30)  # the kernel's clamp
                rep = torch.where(g.r < pp.r0, lj, 0.0)
            else:
                # MKForce (forces_kernel.cu:105-133): 1D Wendland shape
                q = g.r / h
                wmk = 1.8 * (1.0 - 0.5 * q) ** 4 * (2.0 * q + 1.0)
                dist = torch.clamp(g.r - pp.mk_d, min=eps)
                safe_r = torch.clamp(g.r, min=1e-12)
                rep = (pp.mk_k * wmk * 2.0 * m_n
                       / (pp.mk_beta * dist * safe_r * (c["mass"] + m_n)))
            s = s + torch.where(rep_mask, rep, 0.0)

        dv = [s * g.relx, s * g.rely, s * g.relz]
        if sv is not None:
            dv = [dv[0] + sv * relvx, dv[1] + sv * relvy, dv[2] + sv * relvz]
        if fw.flags & SimFlags.ENABLE_INTERNAL_ENERGY:
            # dU/dt -= (a_pair . v_ij)/2 (forces_kernel.def:3306-3316)
            dedt = s * vel_dot_pos
            if sv is not None:
                dedt = dedt + sv * (relvx * relvx + relvy * relvy + relvz * relvz)
            out["DEDt"] = -0.5 * dedt
        if sa:
            # the SA boundary pressure term (forces_kernel.def:2416-2430):
            # DvDt += pGradTerm rho_s ||grad gamma_as|| n_s
            sseg = torch.where(seg_mask, pgrad * rho_n * ggamAS, 0.0)
            dv = [dv[0] + sseg * ns[0], dv[1] + sseg * ns[1], dv[2] + sseg * ns[2]]
        if extra is not None:
            dv = [a + b for a, b in zip(dv, extra)]
        out["DvDt_x"], out["DvDt_y"], out["DvDt_z"] = dv

        # --- XSPH mean velocity (forces_kernel.def:2986-2994; the written
        # value carries a factor 2, write_xsph forces_kernel.def:3368)
        if fw.has_xsph:
            w = kernW(fw.kerneltype, g.r, h)
            xw = torch.where(ff_mask, -2.0 * m_n * w / (rho_c + rho_n), 0.0)
            out["xsph_x"] = xw * relvx
            out["xsph_y"] = xw * relvy
            out["xsph_z"] = xw * relvz
        return out

    sums = neighbor_apply(grid, aux, fields, pair_fn,
                          max_parts_per_cell=sp.max_parts_per_cell,
                          influenceradius=nl_radius, cells=cells)
    return finalize_general(fw, state, fields, sums, gvec, gamma)


def finalize_general(fw, state, fields, sums, gvec, gamma=None) -> ForcesOut:
    """The finalize step of the general pass (finalizeforcesDevice,
    forces_kernel.def:4037-4110): Grenier's fixup, the SA division by
    gamma, gravity, moving-body rows, planes, the DEM terrain, the
    relative-density rate and the CFL maxima."""
    from .planes import apply_plane_forces  # planes takes _powf from here

    pp = fw.pp
    grenier = fw.sph_formulation == SPHFormulation.SPH_GRENIER
    is_fluid_c = fields["ptype"] == ParticleType.FLUID
    dev = state.pos.device

    DvDt = merge_vec(sums, "DvDt")
    if grenier:
        # Grenier fixup: pair-sum force /= rho (forces_kernel.def:3183-3190),
        # before gravity
        DvDt = DvDt / fields["rho"][:, None]
    DrDt_sum = sums["DrDt"]
    if fw.sa_boundary:
        # SA fixup: the fluid rows' pair sums are divided by gamma before
        # gravity (forces_fixup, forces_kernel.def:3225-3240)
        if gamma is None:
            gamma = torch.ones_like(DrDt_sum)
        gdiv = torch.where(is_fluid_c, gamma, 1.0)
        DvDt = DvDt / gdiv[:, None]
        DrDt_sum = DrDt_sum / gdiv
    g = torch.stack([torch.as_tensor(c, dtype=torch.float32, device=dev) for c in gvec])
    DvDt = DvDt + torch.where(is_fluid_c[:, None], g[None, :], 0.0)
    if not fw.has_moving_bodies:
        # boundary particles never accelerate; with moving bodies their rows
        # carry the hydrodynamic force for the per-body reduction
        DvDt = torch.where(is_fluid_c[:, None], DvDt, 0.0)
    if fw.planes:
        DvDt = apply_plane_forces(fw, state.pos, state.vel, state.mass, is_fluid_c, DvDt)
    if fw.dem is not None:
        # the terrain's geometry force (geom_core.cu DemTangentPlane + LJ)
        from .dem import apply_dem_force

        DvDt = apply_dem_force(fw, state.pos, state.vel, state.mass, is_fluid_c, DvDt)
    if grenier:
        # DJ/Dt = (pair sum)/sigma; euler integrates J, the density comes
        # from the COMPUTE_DENSITY pass
        DrDt = DrDt_sum / torch.clamp(fields["sigma"], min=1e-30)
    else:
        # physical DrDt to the relative-density rate (forces_kernel.def:4581)
        rho0 = eos._per_fluid(pp, fields["f_num"], [f.rho0 for f in pp.fluids])
        DrDt = DrDt_sum / rho0
    xsph = merge_vec(sums, "xsph") if fw.has_xsph else torch.zeros_like(state.vel)
    DEDt = sums.get("DEDt", torch.zeros_like(DrDt))

    # --- CFL reductions (forces.cu:557-600)
    accel2 = (DvDt * DvDt).sum(dim=-1)
    max_accel = torch.sqrt(torch.where(is_fluid_c, accel2, 0.0).max())
    max_sspeed = torch.where(is_fluid_c, fields["sspeed"], 0.0).max()
    if not fw.is_inviscid:
        max_kinvisc = torch.where(is_fluid_c, fields["kinvisc"], 0.0).max()
    else:
        max_kinvisc = torch.zeros((), dtype=torch.float32, device=dev)
    return ForcesOut(DvDt=DvDt, DrDt=DrDt, xsph=xsph, DEDt=DEDt, max_accel=max_accel,
                     max_sspeed=max_sspeed, max_kinvisc=max_kinvisc)


def _density_diffusion(fw, c, n, g, f, ff_mask, dt, gvec):
    """Density-diffusion DrDt contribution (physical units), fluid-fluid
    pairs only: Ferrari (forces_kernel.def:1609-1640), Colagrossi
    (:1910-1953), Brezzi (:1763-1790), with the Grenier and Hu & Adams
    variants.  ``gvec`` is the pass's (possibly time-dependent) gravity."""
    ddt = fw.densitydiffusiontype
    if ddt == DensityDiffusionType.NONE:
        return torch.zeros_like(g.r2)

    pp, sp = fw.pp, fw.sp
    rho_c = c["rho"]
    rho_n = n["rho"]
    m_n = n["mass"]
    same_fluid = c["f_num"] == n["f_num"]
    g_dot_rel = g.dot_rel(*gvec)
    ha = fw.sph_formulation == SPHFormulation.SPH_HA
    if ha:
        # the actual volumes: Hu & Adams' variants replace the density
        # differences with mass/volume expressions (forces_kernel.def:1639-1678,
        # :1787-1815, :1954-1996)
        m_c = torch.clamp(c["mass"], min=1e-30)
        v_c = m_c / rho_c
        v_n = torch.clamp(m_n, min=1e-30) / rho_n

    if ddt == DensityDiffusionType.COLAGROSSI:
        # gate: only when the pressure jump exceeds the hydrostatic jump
        gate = torch.abs(c["press"] - n["press"]) >= torch.abs(g_dot_rel * rho_c)
        c0 = eos._per_fluid(pp, c["f_num"], [fl.c0 for fl in pp.fluids])
        coeff = sp.densityDiffCoeff * 2.0 * sp.slength  # xi*2h (ProblemCore.cc:1416)
        if fw.sph_formulation == SPHFormulation.SPH_GRENIER:
            # volume-based variant (forces_kernel.def:1582-1592, 1938-1952)
            diff = coeff * c0 * (c["g_vol"] / n["g_vol"] - 1.0) * f * (-1.0)
        elif ha:
            # volume ratio, weighted by the central mass (:1954-1996)
            diff = coeff * c0 * (v_c / v_n - 1.0) * f * c["mass"]
        else:
            diff = coeff * c0 * (rho_n / rho_c - 1.0) * f * m_n
        return torch.where(ff_mask & same_fluid & gate, -diff, 0.0)

    if ddt == DensityDiffusionType.FERRARI:
        sq_c0 = eos._per_fluid(pp, c["f_num"], [fl.c0 * fl.c0 for fl in pp.fluids])
        rho0_c = eos._per_fluid(pp, c["f_num"], [fl.rho0 for fl in pp.fluids])
        grav_corr = -g_dot_rel * rho0_c / sq_c0
        max_ss = torch.maximum(c["sspeed"], n["sspeed"])
        safe = g.r > 1e-4 * sp.slength
        if ha:
            # (rho_c - rho_n) becomes m_a (1/V_a - 1/V_n), same-fluid pairs
            # only (forces_kernel.def:1639-1678)
            dd = c["mass"] * (1.0 / v_c - 1.0 / v_n)
            ferr = torch.where(safe, max_ss * (dd + grav_corr) / rho_c * g.r, 0.0)
            return torch.where(ff_mask & same_fluid, sp.densityDiffCoeff * m_n * ferr * f, 0.0)
        ferr = torch.where(safe, max_ss * (rho_c - rho_n + grav_corr) / rho_c * g.r, 0.0)
        return torch.where(ff_mask, sp.densityDiffCoeff * m_n * ferr * f, 0.0)

    if ddt == DensityDiffusionType.BREZZI:
        if dt is None:
            dt = 0.0
        if ha:
            # 2/(rho_c+rho_n) becomes 2/(m_a (1/V_a + 1/V_n)) (:1787-1815)
            inv_rho_avg = 2.0 / (c["mass"] * (1.0 / v_c + 1.0 / v_n) + 1e-30)
        else:
            inv_rho_avg = 2.0 / (rho_c + rho_n)
        term = (sp.densityDiffCoeff * (inv_rho_avg * (c["press"] - n["press"]) - g_dot_rel)
                * m_n / rho_n * f * dt * 2.0 * rho_c)
        return torch.where(ff_mask, term, 0.0)

    raise ValueError(f"unsupported density diffusion {ddt}")


__all__ = ["ForcesOut", "compute_forces", "finalize_general", "gravity_vector"]
