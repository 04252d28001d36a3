"""Jacobi solver for the granular effective pressure.

Counterpart of the JAX package's ``ops/jacobi.py`` (the reference's
`src/cuda/visc_kernel.cu:815-1100` and the EFFPRES phases of
`src/integrators/PredictorCorrectorIntegrator.cc:1060-1185`).  The granular
rheology's yield stress takes the effective (inter-granular) pressure
p_eff, the solution of a Laplace problem over the sediment phase with

* a Dirichlet value at the sediment's free surface and phase interface
  (`jacobiFSBoundaryConditionsDevice`),
* a Neumann condition at the walls, through a Shepard interpolation of the
  neighbouring sediment values (`jacobiWallBoundaryConditionsDevice`),
* Jacobi iterations x <- D^-1 (B - R x) over the interior sediment
  (`jacobiBuildVectorsDevice` + `jacobiUpdateEffPresDevice`), until the
  fluid residual and the wall backward error both fall below their
  thresholds (`simparams.h:244-258`) or ``jacobi_maxiter`` is reached.

The surface and interface flags come from the two-pass cone criterion of
`post_process_kernel.cu:420-556`.  Every pass is a dense
``ops/pair.py:neighbor_apply``.

The stop test runs on the device, as the JAX package's ``lax.while_loop``
does: once an iteration meets both thresholds, a device flag freezes
p_eff and the iteration count, and the host reads the flag after
iterations 1, 2 and 4 and then every ``CHECK_EVERY`` iterations.  The loop
therefore stops at the same iteration as the JAX loop (a warm-started
solve, which converges in one iteration, after one), with a host sync per
``CHECK_EVERY`` iterations and at most ``CHECK_EVERY - 1`` frozen
iterations computed and thrown away.  The wall pass visits only the cells
that hold a boundary particle and the vector pass only those that hold
interior sediment: the other centrals' sums are never read, and a
central's sum does not depend on which cells are visited.  The
multi-device hooks of the JAX solver (``exchange`` of the halo rows,
``reduce_max`` of the stop test) come with the multi-GPU slice.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..defs import ParticleType
from ..framework import SimFramework
from ..state import FG_INTERFACE, FG_SEDIMENT, FG_SURFACE, ParticleState, fluid_num, \
    has_flag, part_type
from . import eos
from .kernels import F as kernF
from .kernels import W as kernW
from .neighbors import CellAux, CellGrid
from .pair import neighbor_apply, split_vec

# host reads of the stop flag: after iterations 1, 2 and 4, then one every
# CHECK_EVERY iterations
CHECK_EVERY = 8


def _delta_rho(fw: SimFramework) -> float:
    """The density jump that drives the effective pressure: rho0 of the
    single fluid, |rho0[0] - rho0[1]| with two (visc_kernel.cu:845-847)."""
    rho0s = [f.rho0 for f in fw.pp.fluids]
    return abs(rho0s[0] - rho0s[1]) if len(rho0s) > 1 else rho0s[0]


def _cells_holding(grid: CellGrid, aux: CellAux, flag: torch.Tensor) -> torch.Tensor:
    """The cells that hold a particle with ``flag`` set, in ascending order
    (waits for the device)."""
    h = aux.hash_sorted.long()[flag]
    return torch.unique(h[h < grid.n_cells])


def _volume(fw: SimFramework, state: ParticleState, f_num) -> torch.Tensor:
    rho = eos.physical_density(fw.pp, state.rho, f_num)
    return state.mass / torch.clamp(rho, min=1e-30)


def detect_surface_interface(fw: SimFramework, grid: CellGrid, state: ParticleState,
                             aux: CellAux, *,
                             cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``state.info`` with FG_SURFACE and FG_INTERFACE set on the fluid
    particles by the cone criterion (post_process_kernel.cu:420-556): a
    particle is at the surface when no neighbour lies inside the cone
    around its normal over all neighbours, at the interface when that
    holds for the normal over its own fluid and the boundary only."""
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    f_num = fluid_num(state.info)
    base = dict(**split_vec("pos", state.pos), vol=_volume(fw, state, f_num),
                f_num=f_num, ptype=part_type(state.info))
    kw = dict(max_parts_per_cell=sp.max_parts_per_cell,
              influenceradius=sp.influenceradius, cells=cells)

    def normals_fn(c, n, g):
        f = kernF(fw.kerneltype, g.r, h)
        same = (c["f_num"] == n["f_num"]) | (n["ptype"] != ParticleType.FLUID)
        m_if = g.mask & same
        return {
            "nfs_x": torch.where(g.mask, -f * g.relx, 0.0),
            "nfs_y": torch.where(g.mask, -f * g.rely, 0.0),
            "nfs_z": torch.where(g.mask, -f * g.relz, 0.0),
            "nif_x": torch.where(m_if, -f * g.relx, 0.0),
            "nif_y": torch.where(m_if, -f * g.rely, 0.0),
            "nif_z": torch.where(m_if, -f * g.relz, 0.0),
        }

    n1 = neighbor_apply(grid, aux, base, normals_fn, **kw)
    fields = dict(base, **n1)
    fields["nfs_len"] = torch.sqrt(n1["nfs_x"] ** 2 + n1["nfs_y"] ** 2 + n1["nfs_z"] ** 2)
    fields["nif_len"] = torch.sqrt(n1["nif_x"] ** 2 + n1["nif_y"] ** 2 + n1["nif_z"] ** 2)

    def cone_fn(c, n, g):
        n_fluid = n["ptype"] == ParticleType.FLUID
        coscone = torch.where(n_fluid, pp.cosconeanglefluid, pp.cosconeanglenonfluid)
        crit_fs = -(c["nfs_x"] * g.relx + c["nfs_y"] * g.rely + c["nfs_z"] * g.relz)
        crit_if = -(c["nif_x"] * g.relx + c["nif_y"] * g.rely + c["nif_z"] * g.relz)
        same = (c["f_num"] == n["f_num"]) | ~n_fluid
        in_fs = g.mask & (crit_fs > g.r * c["nfs_len"] * coscone)
        in_if = g.mask & same & (crit_if > g.r * c["nif_len"] * coscone)
        return {"nc_fs": in_fs.to(torch.float32), "nc_if": in_if.to(torch.float32)}

    n2 = neighbor_apply(grid, aux, fields, cone_fn, **kw)
    is_fluid = part_type(state.info) == ParticleType.FLUID
    surface = is_fluid & (n2["nc_fs"] < 0.5)
    interface = is_fluid & (n2["nc_if"] < 0.5) & (n2["nc_fs"] >= 0.5)
    info = state.info & ~(FG_SURFACE | FG_INTERFACE)
    info = info | torch.where(surface, FG_SURFACE, 0).to(info.dtype)
    return info | torch.where(interface, FG_INTERFACE, 0).to(info.dtype)


def jacobi_effpres(fw: SimFramework, grid: CellGrid, state: ParticleState, aux: CellAux,
                   effpres: Optional[torch.Tensor] = None, *,
                   cells: Optional[torch.Tensor] = None):
    """Solve for the effective pressure of the sediment phase from the
    start value ``effpres`` (zeros when None); ``cells`` are the occupied
    cells for the surface detection (found here when None).

    Returns (effpres [N], info with the surface flags, iterations as a 0-d
    int32 tensor): the iterations until one met both thresholds, as the JAX
    package counts them, at most ``jacobi_maxiter``."""
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    dev = state.pos.device
    gx, gy, gz = (float(c) for c in pp.gravity)
    g_mag = math.sqrt(gx * gx + gy * gy + gz * gz)
    drho = _delta_rho(fw)
    if effpres is None:
        effpres = torch.zeros((state.capacity,), dtype=torch.float32, device=dev)

    info = detect_surface_interface(fw, grid, state, aux, cells=cells)
    ptype = part_type(info)
    is_fluid = ptype == ParticleType.FLUID
    is_bound = ptype == ParticleType.BOUNDARY
    sediment = has_flag(info, FG_SEDIMENT)
    at_fs = has_flag(info, FG_SURFACE) | has_flag(info, FG_INTERFACE)
    # Dirichlet value at the sediment surface and interface
    # (jacobiFSBoundaryConditionsDevice)
    effpres = torch.where(is_fluid & sediment & at_fs, sp.deltap * drho * g_mag, effpres)
    interior = is_fluid & sediment & ~at_fs

    f_num = fluid_num(info)
    base = dict(**split_vec("pos", state.pos), vol=_volume(fw, state, f_num),
                sediment=sediment, interior=interior, is_bound=is_bound,
                is_fluid=is_fluid)
    # reference pressures of the wall backward error (visc_kernel.cu:957)
    # and of the fluid residual (:1080)
    refpres_wall = drho * (pp.fluids[0].c0 / 10.0) ** 2
    refpres_fluid = eos._per_fluid(pp, f_num, [f.rho0 * f.c0 * f.c0 / 100.0
                                               for f in pp.fluids])
    kw = dict(max_parts_per_cell=sp.max_parts_per_cell, influenceradius=sp.influenceradius)
    wall_cells = _cells_holding(grid, aux, is_bound)
    interior_cells = _cells_holding(grid, aux, interior)

    def wall_fn(c, n, g):
        # Shepard interpolation over the sediment neighbours with the
        # hydrostatic correction (jacobiWallBoundaryConditionsDevice)
        w = kernW(fw.kerneltype, g.r, h)
        sed_n = g.mask & n["sediment"] & n["is_fluid"]
        num = torch.clamp(n["vol"] * (n["ep"] + drho * g.dot_rel(gx, gy, gz)) * w, min=0.0)
        return {"wall_num": torch.where(sed_n, num, 0.0),
                "wall_alpha": torch.where(sed_n, n["vol"] * w, 0.0)}

    def vec_fn(c, n, g):
        # the Jacobi vectors over the interior sediment (jacobiBuildVectorsDevice)
        f = kernF(fw.kerneltype, g.r, h)
        sed_fluid = n["sediment"] & n["is_fluid"]
        contrib = g.mask & (sed_fluid | n["is_bound"])
        vf = n["vol"] * f
        inner = sed_fluid & n["interior"]
        return {"D": torch.where(contrib, vf, 0.0),
                "Rx": torch.where(contrib & inner, -vf * n["ep"], 0.0),
                "B": torch.where(contrib & ~inner, vf * n["ep"], 0.0)}

    def one_iteration(ep):
        ws = neighbor_apply(grid, aux, dict(base, ep=ep), wall_fn, cells=wall_cells, **kw)
        alpha = ws["wall_alpha"]
        wall_new = torch.where(alpha > 0.0,
                               ws["wall_num"] / torch.clamp(alpha, min=1e-30), 0.0)
        backerr = torch.where(is_bound & (alpha > 0.0),
                              torch.abs(wall_new - ep) / refpres_wall, 0.0)
        ep = torch.where(is_bound, wall_new, ep)

        vs = neighbor_apply(grid, aux, dict(base, ep=ep), vec_fn, cells=interior_cells, **kw)
        D, Rx, B = vs["D"], vs["Rx"], vs["B"]
        nonzero = torch.abs(D) > 0.0
        new = (B - Rx) / torch.where(nonzero, D, 1.0)
        new = torch.where(torch.isfinite(new) & nonzero, new, 0.0)
        residual = torch.where(interior, (D * new + Rx - B) / refpres_fluid, 0.0)
        ep = torch.where(interior, new, ep)
        return ep, torch.abs(residual).max(), backerr.max()

    iters = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(sp.jacobi_maxiter):
        if k and (k % CHECK_EVERY == 0 or k & (k - 1) == 0) and bool(done):
            break
        ep, res, berr = one_iteration(effpres)
        # an iteration after the converged one changes nothing
        effpres = torch.where(done, effpres, ep)
        iters = iters + (~done).to(torch.int32)
        # the negation of the JAX loop's condition (a NaN maximum stops it)
        done = done | ~((res >= sp.jacobi_residual) | (berr >= sp.jacobi_backerr))
    return effpres, info, iters


def effpres_slope(fw: SimFramework, pos: torch.Tensor, effpres: torch.Tensor,
                  info: torch.Tensor):
    """How p_eff falls with depth over the interior sediment (sediment
    fluid flagged neither surface nor interface): the least-squares line
    p = a z + b in f64 on the host.  Returns (-a in Pa/m, the fit's R^2, the
    particles fitted, and _delta_rho(fw) |g|, the lithostatic slope)."""
    sel = (has_flag(info, FG_SEDIMENT) & (part_type(info) == ParticleType.FLUID)
           & ~has_flag(info, FG_SURFACE) & ~has_flag(info, FG_INTERFACE)).cpu().numpy()
    z = pos[:, 2].cpu().numpy()[sel].astype(np.float64)
    p = effpres.cpu().numpy()[sel].astype(np.float64)
    a, b = np.polyfit(z, p, 1)
    r2 = 1.0 - float(((p - a * z - b) ** 2).sum()) / float(((p - p.mean()) ** 2).sum())
    return -float(a), r2, int(sel.sum()), _delta_rho(fw) * abs(fw.pp.gravity[2])


__all__ = ["jacobi_effpres", "detect_surface_interface", "effpres_slope", "CHECK_EVERY"]
