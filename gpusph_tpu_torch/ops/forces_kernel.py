"""The forces pass through the hand-written Hopper kernel.

Counterpart of ``gpusph_tpu/ops/forces_pallas.py:564-984``.  A pass is

1. ``prop_table``: the per-particle property table (16 f32 columns), padded
   to ``(nG+1)*GROUP`` rows so that neighbor group ``g`` is rows
   ``16g .. 16g+15`` and group ``nG`` is the pad sentinel at ``PAD_POS``;
2. ``pair_forces``: the pair physics of every central slot over its block's
   flat tiles (`csrc/forces.cu` on the card; ``pair_forces_reference``, the
   plain PyTorch version, for tensors on the CPU);
3. ``compute_forces_kernel``: un-binning to particle order and the finalize
   step (gravity, moving-body masking, rho0 scaling, CFL maxima), as
   `finalizeforcesDevice` (`forces_kernel.def:4037-4110`) and ``dtreduce``
   (`forces.cu:557-600`).

Physics (reference formulas `src/cuda/forces_kernel.def`): continuity
(F1/F2, DYN gating), pressure gradient, artificial viscosity, Morris/Monaghan
laminar viscosity, LJ/MK boundary repulsion, Colagrossi/Ferrari density
diffusion, moving-body feedback, XSPH (reference factor 2) and internal
energy, all in f32.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..defs import (
    AverageOperator,
    BoundaryType,
    DensityDiffusionType,
    KernelType,
    ParticleType,
    SimFlags,
    SPHFormulation,
    TurbulenceModel,
    ViscousModel,
)
from ..framework import SimFramework
from ..state import ParticleState, fluid_num, is_active, part_type
from . import eos
from .block_plan import B, GPT, GROUP, PAD_POS, TS, BlockPlan
from .forces import ForcesOut, _avg, _powf
from .kernels import F as kernF
from .kernels import W as kernW
from .kernels import gaussian_coeffs
from .neighbors import CellGrid

# property-table columns
C_POSX, C_POSY, C_POSZ = 0, 1, 2
C_VELX, C_VELY, C_VELZ = 3, 4, 5
C_MASS, C_RHO, C_PPRE, C_SSPEED = 6, 7, 8, 9
C_PRESS, C_FLUID, C_BOUND, C_DVISC = 10, 11, 12, 13
NCOLS = 16

NOUT = 8  # DrDt, DvDt xyz, xsph xyz, DEDt

# CUDA launches of the forces kernel in this process; pair_forces adds one
# where it launches and nowhere else
launches = 0

# tiles per step of the plain version: bounds its [tiles, 64, 128] temporaries
REFERENCE_TILE_CHUNK = 256


def kernel_supported(fw: SimFramework, grid: CellGrid) -> bool:
    """Configurations covered by the forces kernel (the JAX package's
    ``pallas_supported``)."""
    if grid.fast_axis_periodic:
        return False  # candidate runs would wrap
    if fw.sa_boundary:
        return False
    if fw.sph_formulation not in (SPHFormulation.SPH_F1, SPHFormulation.SPH_F2):
        return False
    if fw.visc.turbmodel not in (
        TurbulenceModel.ARTIFICIAL,
        TurbulenceModel.LAMINAR_FLOW,
    ):
        return False
    if fw.densitydiffusiontype == DensityDiffusionType.BREZZI:
        return False  # needs the dt scalar
    if fw.densitydiffusiontype != DensityDiffusionType.NONE and len(fw.pp.fluids) > 1:
        # fluid 0's c0/rho0 are kernel constants and there is no
        # same-fluid-pair gate
        return False
    if not fw.is_inviscid and fw.visc.viscmodel == ViscousModel.ESPANOL_REVENGA:
        return False
    if fw.gcallback is not None:
        return False  # gravity is a kernel constant
    return True


def prop_table(fw: SimFramework, state: ParticleState) -> torch.Tensor:
    """f32[(nG+1)*GROUP, NCOLS] property table in kernel column order.

    Rows ``capacity`` and beyond are pad rows (PAD_POS, rho=1, zeros
    elsewhere); inactive particles are parked at PAD_POS so that no stale
    field can enter a pair.
    """
    pp = fw.pp
    N = state.capacity
    dev = state.pos.device
    f_num = fluid_num(state.info)
    ptype = part_type(state.info)
    rho_phys = eos.physical_density(pp, state.rho, f_num)
    press = eos.pressure(pp, state.rho, f_num)
    sspeed = eos.sound_speed(pp, state.rho, f_num)
    nG = -(-N // GROUP) if N else 1
    rows = (nG + 1) * GROUP

    # filled column by column, in place, in a fresh tensor
    P = torch.zeros((rows, NCOLS), dtype=torch.float32, device=dev)
    P[N:, C_POSX:C_POSZ + 1] = PAD_POS
    P[N:, C_RHO] = 1.0
    act = is_active(state.info)[:, None]
    P[:N, C_POSX:C_POSZ + 1] = torch.where(act, state.pos, PAD_POS)
    P[:N, C_VELX:C_VELZ + 1] = state.vel
    P[:N, C_MASS] = state.mass
    P[:N, C_RHO] = rho_phys
    P[:N, C_PPRE] = press / (rho_phys * rho_phys)
    P[:N, C_SSPEED] = sspeed
    P[:N, C_PRESS] = press
    P[:N, C_FLUID] = (ptype == ParticleType.FLUID).float()
    P[:N, C_BOUND] = (ptype == ParticleType.BOUNDARY).float()
    if not fw.is_inviscid:
        kinvisc = eos._per_fluid(pp, f_num, [f.kinematic_visc for f in pp.fluids])
        P[:N, C_DVISC] = kinvisc * rho_phys
    return P


# --- the kernel's run-time parameters ---------------------------------------

# lengths of the two parameter arrays: N_INT_PARAMS / N_FLOAT_PARAMS of
# csrc/forces.cu, checked against the library when it is loaded
N_INT_PARAMS = 14
N_FLOAT_PARAMS = 31


def kernel_params(fw: SimFramework, grid: CellGrid):
    """(ints, floats) in the order of ``ForcesParams`` in csrc/forces.cu."""
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    kt = KernelType(fw.kerneltype)
    gauss_wsub = 0.0
    if kt == KernelType.CUBICSPLINE:
        kw, kf = 1.0 / (math.pi * h**3), 3.0 / (4.0 * math.pi * h**4)
    elif kt == KernelType.QUADRATIC:
        kw, kf = 15.0 / (16.0 * math.pi * h**3), 15.0 / (32.0 * math.pi * h**4)
    elif kt == KernelType.GAUSSIAN:
        gauss_wsub, kw, kf = gaussian_coeffs(h)
    else:
        kw, kf = 21.0 / (16.0 * math.pi * h**3), 105.0 / (128.0 * math.pi * h**5)
    if fw.is_inviscid:
        visc = 0
    elif fw.visc.viscmodel == ViscousModel.MONAGHAN:
        visc = 2
    else:
        visc = 1
    repulsion = {BoundaryType.LJ_BOUNDARY: 1, BoundaryType.MK_BOUNDARY: 2}.get(
        fw.boundarytype, 0)

    def small_int(e):
        return int(e) if e == int(e) and 0 <= int(e) <= 16 else -1

    mon = pp.monaghan_visc_coeff
    if mon != mon:
        mon = 1.0
    Lx, Ly, Lz = grid.world_size
    c0 = pp.fluids[0].c0
    ints = [
        int(kt),
        int(fw.sph_formulation == SPHFormulation.SPH_F2),
        int(fw.boundarytype == BoundaryType.DYN_BOUNDARY),
        {DensityDiffusionType.FERRARI: 1,
         DensityDiffusionType.COLAGROSSI: 2}.get(fw.densitydiffusiontype, 0),
        int(fw.visc.turbmodel == TurbulenceModel.ARTIFICIAL),
        visc,
        int(AverageOperator(fw.visc.avgop)),
        repulsion,
        int(fw.has_moving_bodies),
        int(fw.has_xsph),
        int(bool(fw.flags & SimFlags.ENABLE_INTERNAL_ENERGY)),
        int(fw.periodicbound),
        small_int(pp.p1coeff),
        small_int(pp.p2coeff),
    ]
    floats = [
        h, sp.influenceradius * sp.influenceradius,
        Lx, Ly, Lz, 1.0 / Lx, 1.0 / Ly, 1.0 / Lz,
        kw, kf, gauss_wsub,
        *pp.gravity,
        c0, pp.fluids[0].rho0, c0 * c0,
        sp.densityDiffCoeff * 2.0 * sp.slength,
        sp.densityDiffCoeff,
        (1e-4 * h) ** 2,
        pp.epsartvisc,
        h * pp.artvisccoeff,
        mon,
        pp.r0, pp.dcoeff, pp.p1coeff, pp.p2coeff, 1e-3 * pp.r0,
        pp.mk_k, pp.mk_d, pp.mk_beta,
    ]
    return ints, floats


@functools.lru_cache(maxsize=16)
def _ctypes_params(fw: SimFramework, grid: CellGrid):
    """``kernel_params`` as the two ctypes arrays the launch passes, built
    once per (framework, grid)."""
    ints, floats = kernel_params(fw, grid)
    if (len(ints), len(floats)) != (N_INT_PARAMS, N_FLOAT_PARAMS):
        raise RuntimeError(f"kernel_params gives {len(ints)} ints + {len(floats)} floats, "
                           f"the kernel takes {N_INT_PARAMS} + {N_FLOAT_PARAMS}")
    return (ctypes.c_int * N_INT_PARAMS)(*ints), (ctypes.c_float * N_FLOAT_PARAMS)(*floats)


# --- plain PyTorch version of the kernel -------------------------------------

def _pair_sums(fw: SimFramework, grid: CellGrid, cen: torch.Tensor,
               win: torch.Tensor) -> torch.Tensor:
    """Pair physics of ``_pair_chunk`` for a batch of tiles: centrals
    ``cen`` [T, B, NCOLS] vs window slots ``win`` [T, TS, NCOLS].  Returns the
    per-central sums [T, B, NOUT]."""
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    dev = cen.device
    rad2 = torch.tensor(sp.influenceradius * sp.influenceradius,
                        dtype=torch.float32, device=dev)

    def ccol(c):
        return cen[:, :, c:c + 1]  # [T, B, 1]

    def wrow(c):
        return win[:, None, :, c]  # [T, 1, TS]

    cx, cy, cz = ccol(C_POSX), ccol(C_POSY), ccol(C_POSZ)
    c_rho = ccol(C_RHO)
    c_ss = ccol(C_SSPEED)
    c_fluid = ccol(C_FLUID)
    c_bound = ccol(C_BOUND)
    per = int(fw.periodicbound)
    dyn = fw.boundarytype == BoundaryType.DYN_BOUNDARY
    ddt = fw.densitydiffusiontype

    def rel(cc, wc, L, bit):
        rl = cc - wrow(wc)
        if per & bit:
            rl = rl - L * torch.round(rl * (1.0 / L))
        return rl

    Lx, Ly, Lz = grid.world_size
    relx = rel(cx, C_POSX, Lx, 1)
    rely = rel(cy, C_POSY, Ly, 2)
    relz = rel(cz, C_POSZ, Lz, 4)
    r2 = relx * relx + rely * rely + relz * relz
    fmask = ((r2 < rad2) & (r2 > 0.0)).float()
    r = torch.sqrt(torch.minimum(r2, rad2))
    fK = kernF(fw.kerneltype, r, h)

    relvx = ccol(C_VELX) - wrow(C_VELX)
    relvy = ccol(C_VELY) - wrow(C_VELY)
    relvz = ccol(C_VELZ) - wrow(C_VELZ)
    vdp = relvx * relx + relvy * rely + relvz * relz

    n_fluid = wrow(C_FLUID)
    n_bound = wrow(C_BOUND)
    m_n = wrow(C_MASS)
    rho_n = wrow(C_RHO)
    mfK = m_n * fK

    # continuity (forces_kernel.def:2139-2155)
    if dyn:
        c_any = c_fluid + c_bound - c_fluid * c_bound
        cont = fmask * c_any * (n_fluid + n_bound - n_fluid * n_bound)
    else:
        cont = fmask * c_fluid * n_fluid
    DrDt_term = vdp * mfK
    if fw.sph_formulation == SPHFormulation.SPH_F2:
        DrDt_term = DrDt_term * c_rho / rho_n
    DrDt = cont * DrDt_term

    ff = fmask * c_fluid * n_fluid

    if ddt != DensityDiffusionType.NONE:
        gx, gy, gz = pp.gravity
        g_dot_rel = gx * relx + gy * rely + gz * relz
    if ddt == DensityDiffusionType.COLAGROSSI:
        gate = (torch.abs(ccol(C_PRESS) - wrow(C_PRESS))
                >= torch.abs(g_dot_rel * c_rho)).float()
        coeff = sp.densityDiffCoeff * 2.0 * sp.slength
        DrDt = DrDt - ff * gate * coeff * pp.fluids[0].c0 * (rho_n / c_rho - 1.0) * mfK
    elif ddt == DensityDiffusionType.FERRARI:
        grav_corr = -g_dot_rel * pp.fluids[0].rho0 / (pp.fluids[0].c0 ** 2)
        max_ss = torch.maximum(c_ss, wrow(C_SSPEED))
        safe = (r2 > (1e-4 * h) ** 2).float()
        DrDt = DrDt + ff * safe * sp.densityDiffCoeff * max_ss * (
            c_rho - rho_n + grav_corr) / c_rho * r * mfK

    # momentum (pressure gradient)
    if dyn:
        mom = fmask * c_fluid * (n_fluid + n_bound - n_fluid * n_bound)
    else:
        mom = ff
    if fw.has_moving_bodies:
        mom = mom + fmask * c_bound * n_fluid  # body force feedback
    if fw.sph_formulation == SPHFormulation.SPH_F2:
        pgrad = (ccol(C_PRESS) + wrow(C_PRESS)) / (c_rho * rho_n)
    else:
        pgrad = ccol(C_PPRE) + wrow(C_PPRE)
    s = -mom * pgrad * mfK

    if fw.visc.turbmodel == TurbulenceModel.ARTIFICIAL:
        art = (vdp * (h * pp.artvisccoeff) * (c_ss + wrow(C_SSPEED))
               / ((r2 + pp.epsartvisc) * (c_rho + rho_n)))
        s = s + mom * (vdp < 0.0).float() * art * mfK

    sv = None
    if not fw.is_inviscid:
        mu_avg = _avg(fw.visc.avgop, ccol(C_DVISC), wrow(C_DVISC))
        visc_coeff = 2.0 * mu_avg * m_n / (c_rho * rho_n)
        if fw.visc.viscmodel == ViscousModel.MONAGHAN:
            mon = (vdp < 0).float() * vdp / (r2 + pp.epsartvisc)
            coeff = pp.monaghan_visc_coeff
            if coeff != coeff:
                coeff = 1.0
            s = s + mom * coeff * visc_coeff * fK * mon
        else:
            sv = mom * visc_coeff * fK

    if fw.repulsive_boundary:
        rep_mask = fmask * c_fluid * n_bound
        if fw.boundarytype == BoundaryType.LJ_BOUNDARY:
            inv_r = 1.0 / torch.clamp(r, min=1e-3 * pp.r0)
            ratio = pp.r0 * inv_r
            lj = (pp.dcoeff * (_powf(ratio, pp.p1coeff) - _powf(ratio, pp.p2coeff))
                  * inv_r * inv_r)
            lj = torch.clamp(lj, max=1e30)
            rep = torch.where(r < pp.r0, lj, 0.0)
        else:
            q = r / h
            wmk = 1.8 * (1.0 - 0.5 * q) ** 4 * (2.0 * q + 1.0)
            dist = torch.clamp(r - pp.mk_d, min=pp.epsartvisc)
            safe_r = torch.clamp(r, min=1e-12)
            rep = (pp.mk_k * wmk * 2.0 * m_n
                   / (pp.mk_beta * dist * safe_r * (ccol(C_MASS) + m_n)))
        s = s + rep_mask * rep

    DvDt_x = s * relx
    DvDt_y = s * rely
    DvDt_z = s * relz
    if sv is not None:
        DvDt_x = DvDt_x + sv * relvx
        DvDt_y = DvDt_y + sv * relvy
        DvDt_z = DvDt_z + sv * relvz

    sums = [DrDt.sum(2), DvDt_x.sum(2), DvDt_y.sum(2), DvDt_z.sum(2)]
    zero = torch.zeros_like(sums[0])
    if fw.has_xsph:
        # XSPH mean velocity, reference factor 2 (forces_kernel.def:3368)
        xw = ff * (-2.0 * m_n) * kernW(fw.kerneltype, r, h) / (c_rho + rho_n)
        sums += [(xw * relvx).sum(2), (xw * relvy).sum(2), (xw * relvz).sum(2)]
    else:
        sums += [zero, zero, zero]
    if fw.flags & SimFlags.ENABLE_INTERNAL_ENERGY:
        # dU/dt -= (a_pair . v_ij)/2 (forces_kernel.def:3306-3316)
        dedt = s * vdp
        if sv is not None:
            dedt = dedt + sv * (relvx * relvx + relvy * relvy + relvz * relvz)
        sums.append((-0.5 * dedt).sum(2))
    else:
        sums.append(zero)
    return torch.stack(sums, dim=-1)


def pair_forces_reference(fw: SimFramework, grid: CellGrid, P: torch.Tensor,
                          plan: BlockPlan) -> torch.Tensor:
    """Plain PyTorch version of the forces kernel: f32[NOUT, n_blocks*B]
    pair sums per central slot.  Works through the used tiles in chunks of
    ``REFERENCE_TILE_CHUNK`` so its memory stays bounded at any size; blocks
    that no tile visits get zeros."""
    nb = plan.n_blocks
    dev = P.device
    cen_tab = P[plan.cen_idx[: nb * B].long()].reshape(nb, B, NCOLS)
    Pg = P.reshape(-1, GROUP, NCOLS)
    fg = plan.flat_groups.long()
    t_used = int(plan.tile_off[-1])
    tb = plan.tile_block[:t_used].long()
    # each tile's rank within its block: the per-tile sums land in distinct
    # slots (written in place) and are then summed over the rank axis, so
    # the result does not depend on a scatter's order of accumulation
    rank = torch.arange(t_used, device=dev) - plan.tile_off.long()[tb]
    n_rank = int(rank.max()) + 1 if t_used else 1
    per_tile = torch.zeros((nb, n_rank, B, NOUT), dtype=torch.float32, device=dev)
    for s in range(0, t_used, REFERENCE_TILE_CHUNK):
        e = min(s + REFERENCE_TILE_CHUNK, t_used)
        win = Pg[fg[s * GPT:e * GPT]].reshape(e - s, TS, NCOLS)
        blk = tb[s:e]
        per_tile[blk, rank[s:e]] = _pair_sums(fw, grid, cen_tab[blk], win)
    return per_tile.sum(dim=1).permute(2, 0, 1).reshape(NOUT, nb * B)


def _launch(fw: SimFramework, grid: CellGrid, P: torch.Tensor,
            plan: BlockPlan) -> torch.Tensor:
    from .. import _build

    global launches
    nb = plan.n_blocks
    dev = P.device
    tensors = dict(flat_groups=plan.flat_groups, tile_off=plan.tile_off,
                   cen_idx=plan.cen_idx)
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"plan.{name} must be a contiguous int32 tensor "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if P.dtype != torch.float32 or not P.is_contiguous() or P.dim() != 2 \
            or P.shape[1] != NCOLS or P.shape[0] % GROUP:
        raise ValueError(f"property table must be contiguous f32[(nG+1)*{GROUP}, "
                         f"{NCOLS}], got {P.dtype} {tuple(P.shape)}")
    if plan.cen_idx.shape[0] != (nb + 1) * B:
        raise ValueError("plan.cen_idx does not match plan.tile_off")
    if plan.flat_groups.shape[0] % GPT:
        raise ValueError("plan.flat_groups is not a whole number of tiles")

    lib = _build.load_library()
    iarr, farr = _ctypes_params(fw, grid)
    out = torch.empty((NOUT, nb * B), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.gpusph_forces_launch(
            ctypes.addressof(iarr), ctypes.addressof(farr), P.data_ptr(),
            plan.flat_groups.data_ptr(), plan.tile_off.data_ptr(),
            plan.cen_idx.data_ptr(), out.data_ptr(), nb, stream)
    _build.check(lib, code, "forces kernel launch")
    launches += 1
    return out


def pair_forces(fw: SimFramework, grid: CellGrid, P: torch.Tensor,
                plan: BlockPlan) -> torch.Tensor:
    """Pair sums per central slot, f32[NOUT, n_blocks*B].

    On a CUDA tensor this launches the Hopper kernel (`csrc/forces.cu`) or
    raises; on a CPU tensor it runs the plain version.
    """
    if P.device.type == "cuda":
        return _launch(fw, grid, P, plan)
    if P.device.type == "cpu":
        return pair_forces_reference(fw, grid, P, plan)
    raise ValueError(f"no forces kernel for device {P.device}")


def compute_forces_kernel(fw: SimFramework, grid: CellGrid,
                          state: ParticleState, plan: BlockPlan) -> ForcesOut:
    """One forces pass of the *sorted* state over its rebuild-time plan."""
    if fw.planes:
        raise NotImplementedError("plane boundaries are not ported yet")
    if fw.dem is not None:
        raise NotImplementedError("DEM terrain is not ported yet")
    out = pair_forces(fw, grid, prop_table(fw, state), plan)
    return finalize_forces(fw, state, plan, out)


def finalize_forces(fw: SimFramework, state: ParticleState, plan: BlockPlan,
                    out: torch.Tensor) -> ForcesOut:
    """Per-particle forces from the pair sums ``out`` [NOUT, n_blocks*B] of
    ``pair_forces``: un-binning and the finalize step."""
    pp = fw.pp
    # un-bin: per-particle gather from the [NOUT, n_blocks*B] slot layout;
    # inactive rows are zeroed
    active = is_active(state.info)
    rows = out[:, plan.slot_of_sorted.long()]  # [NOUT, N]
    rows = torch.where(active[None, :], rows, 0.0)

    DrDt_phys = rows[0]
    DvDt = rows[1:4].T
    xsph = rows[4:7].T.contiguous() if fw.has_xsph else torch.zeros_like(state.vel)
    DEDt = rows[7]

    # finalize: gravity, unit conversion, CFL maxima (forces.cu:557-600)
    ptype = part_type(state.info)
    is_fluid_c = (ptype == ParticleType.FLUID)[:, None]
    gvec = torch.tensor(pp.gravity, dtype=torch.float32, device=state.pos.device)
    DvDt = torch.where(is_fluid_c, DvDt + gvec, DvDt)
    if not fw.has_moving_bodies:
        DvDt = torch.where(is_fluid_c, DvDt, 0.0)
    f_num = fluid_num(state.info)
    rho0 = eos._per_fluid(pp, f_num, [f.rho0 for f in pp.fluids])
    DrDt = DrDt_phys / rho0

    sspeed = eos.sound_speed(pp, state.rho, f_num)
    accel2 = (DvDt * DvDt).sum(dim=-1)
    is_fluid = is_fluid_c[:, 0]
    max_accel = torch.sqrt(torch.where(is_fluid, accel2, 0.0).max())
    max_sspeed = torch.where(is_fluid, sspeed, 0.0).max()
    if not fw.is_inviscid:
        kinvisc = eos._per_fluid(pp, f_num, [f.kinematic_visc for f in pp.fluids])
        max_kinvisc = torch.where(is_fluid, kinvisc, 0.0).max()
    else:
        max_kinvisc = torch.zeros((), dtype=torch.float32, device=state.pos.device)

    return ForcesOut(
        DvDt=DvDt.contiguous(),
        DrDt=DrDt,
        xsph=xsph,
        DEDt=DEDt,
        max_accel=max_accel,
        max_sspeed=max_sspeed,
        max_kinvisc=max_kinvisc,
    )


__all__ = [
    "kernel_supported",
    "prop_table",
    "kernel_params",
    "N_INT_PARAMS",
    "N_FLOAT_PARAMS",
    "pair_forces",
    "pair_forces_reference",
    "compute_forces_kernel",
    "finalize_forces",
    "NCOLS",
    "NOUT",
]
