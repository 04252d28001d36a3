"""Particle repacking: pre-simulation relaxation of the initial lattice.

Counterpart of the JAX package's ``repacking.py``, the reference's
RepackingIntegrator (`src/integrators/RepackingIntegrator.cc:279-425`) and
its repack kernels (`repackDevice` `src/cuda/forces_kernel.def:4161`,
damping term `:4310`).

The mixing force is F = -a c0^2 grad(Gamma) with
grad(Gamma) = sum_j V_j grad W_ij, plus a velocity damping term
alpha * c0/dp * v.  Particles relax under this pseudo-dynamics for
``repack_maxiter`` iterations (or until kinetic energy stalls), after which
velocities are zeroed and the simulation proper starts from the repacked
positions (`--repack`, `src/main.cc:238-250`).  The pair sums run on the
state's device over the cell-pair combinator (`ops/pair.py`).
"""
from __future__ import annotations

import os

import torch

from .defs import ParticleType
from .framework import SimFramework
from .io.hotfile import save_hotfile
from .ops import eos
from .ops.kernels import F as kernF
from .ops.neighbors import CellAux, CellGrid, build_cells
from .ops.pair import merge_vec, neighbor_apply, split_vec
from .state import FG_INACTIVE, FG_SURFACE, ParticleState, fluid_num, has_flag, part_type


def repack_forces(fw: SimFramework, grid: CellGrid, state: ParticleState,
                  aux: CellAux):
    """Mixing + damping pseudo-forces (repackDevice)."""
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    f_num = fluid_num(state.info)
    c0 = eos._per_fluid(pp, f_num, [f.c0 for f in pp.fluids])

    fields = dict(
        **split_vec("pos", state.pos),
        mass=state.mass,
        rho=eos.physical_density(pp, state.rho, f_num),
        c0=c0,
        ptype=part_type(state.info),
    )

    def pair_fn(c, n, g):
        f = kernF(fw.kerneltype, g.r, h)
        c_fluid = c["ptype"] == ParticleType.FLUID
        # fluid centrals vs all (fluid + boundary) neighbors
        coeff = torch.where(
            g.mask & c_fluid,
            -sp.repack_a * c["c0"] * c["c0"] * n["mass"] / n["rho"] * f,
            0.0,
        )
        return {
            "DvDt_x": coeff * g.relx,
            "DvDt_y": coeff * g.rely,
            "DvDt_z": coeff * g.relz,
        }

    sums = neighbor_apply(
        grid, aux, fields, pair_fn,
        max_parts_per_cell=sp.max_parts_per_cell,
        influenceradius=sp.influenceradius,
    )
    DvDt = merge_vec(sums, "DvDt")
    # damping (forces_kernel.def:4310)
    DvDt = DvDt - (sp.repack_alpha * c0 / sp.deltap)[:, None] * state.vel
    is_fluid = part_type(state.info) == ParticleType.FLUID
    return torch.where(is_fluid[:, None], DvDt, 0.0)


def make_repack_chunk(fw: SimFramework, grid: CellGrid, nsteps: int = 10):
    """Repack chunk: one neighbor rebuild + ``nsteps`` pseudo-dynamic steps.
    Returns ``chunk(state) -> (state, ekin)`` with the fluid kinetic energy
    after the chunk as a 0-d tensor (it feeds the host-side stall
    criterion)."""
    c0max = max(f.c0 for f in fw.pp.fluids)
    dt = 0.1 * fw.sp.slength / c0max

    def chunk(state: ParticleState):
        state, aux = build_cells(grid, state)
        is_fluid = (part_type(state.info) == ParticleType.FLUID)[:, None]
        for _ in range(nsteps):
            dv = repack_forces(fw, grid, state, aux)
            vel = torch.where(is_fluid, state.vel + dv * dt, 0.0)
            pos = torch.where(is_fluid, state.pos + vel * dt, state.pos)
            state = state.replace(pos=pos, vel=vel)
        ekin = 0.5 * torch.sum(state.mass * torch.sum(state.vel * state.vel, dim=1))
        return state, ekin

    return chunk


def finish_repacking(state: ParticleState) -> ParticleState:
    """FINISH_REPACKING: deactivate free-surface *boundary* particles
    (DISABLE_FREE_SURF_PARTS — `disableFreeSurfPartsDevice`,
    `src/cuda/euler_kernel.cu:163`: SURFACE(info) && NOT_FLUID) and zero
    velocities (END_OF_REPACKING)."""
    kill = has_flag(state.info, FG_SURFACE) & (
        part_type(state.info) != ParticleType.FLUID
    )
    info = torch.where(kill, state.info | FG_INACTIVE, state.info)
    return state.replace(info=info, vel=torch.zeros_like(state.vel))


def run_repacking(sim, state: ParticleState, *, outdir=None,
                  stall_rel: float = 1e-3) -> ParticleState:
    """Run the repacking loop on the simulator's device until kinetic energy
    stalls (relative change of the chunk kinetic energy below
    ``stall_rel``, after the initial transient) or ``repack_maxiter``
    iterations, then finalize.

    When ``outdir`` is given, the repacked state is dumped as a hotfile
    (``repack.npz``) so the simulation proper can resume from it, matching
    the reference's end-of-repacking hot write
    (`RepackingIntegrator.cc`, `src/GPUSPH.cc:280-292`).
    """
    fw, grid = sim.fw, sim.grid
    nsteps = 10
    chunk = make_repack_chunk(fw, grid, nsteps)
    state = state.to(sim.device)
    iters = 0
    prev_ekin = None
    peak_ekin = 0.0
    while iters < fw.sp.repack_maxiter:
        state, ekin = chunk(state)
        ekin = float(ekin)  # waits for the device
        iters += nsteps
        peak_ekin = max(peak_ekin, ekin)
        if prev_ekin is not None and peak_ekin > 0:
            # stall: past the initial energy ramp and the chunk-to-chunk
            # change is a negligible fraction of the peak
            if ekin < peak_ekin and abs(ekin - prev_ekin) < stall_rel * peak_ekin:
                break
        prev_ekin = ekin
    state = finish_repacking(state)
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        save_hotfile(os.path.join(outdir, "repack.npz"), state,
                     t=0.0, dt=0.0, iterations=0)
    return state


__all__ = ["run_repacking", "repack_forces", "make_repack_chunk",
           "finish_repacking"]
