"""Predictor-corrector integrator: the simulation hot loop.

Counterpart of the JAX package's ``integrator.py`` (the reference's
Integrator command program, `src/integrators/PredictorCorrectorIntegrator.cc:386-685`,
and the GPUSPH manager loop, `src/GPUSPH.cc:747-759`).  A *chunk* rebuilds
the neighbor structure once (NEIBS_LIST phase, `src/Integrator.cc:95-250`:
cell sort + block plan) and then runs ``buildneibsfreq`` predictor/corrector
steps in a Python loop.  A step starts with the density filters that are
due at its global iteration (FILTER phase, `ops/filters.py`).  Each forces
pass first refreshes Grenier's sigma and density (COMPUTE_DENSITY,
`ops/grenier.py`), solves for the granular effective pressure (EFFPRES,
`ops/jacobi.py`), takes the SA walls' gamma (by quadrature, or the carried
dynamic gamma) and imposes their density (`ops/sa.py`), and computes the
SPS stress and the effective viscosity where the model needs them
(CALC_VISC, `ops/visc.py`).  With density summation each Euler step is
followed by the density-sum update and its diffusion pass
(`ops/density_sum.py`).  The forces engine follows the configuration:
the forces kernel (`ops/forces_kernel.py`; the CUDA kernel on the card,
its plain version on the CPU) where ``kernel_supported`` holds, else the
general pair path (`ops/forces.py`, on ``neighbor_apply``), which also
takes a time-dependent gravity and SA walls.  The host loop handles termination and the overflow
and dt checks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from .bodies import (
    BodiesState,
    apply_body_motion,
    init_bodies_state,
    reduce_body_forces,
    step_bodies,
)
from .defs import RheologyType, SimFlags, SPHFormulation, TurbulenceModel
from .framework import SimFramework
from .ops.block_plan import build_block_plan, plan_dims
from .ops.density_sum import apply_density_diffusion, density_sum_update, init_dynamic_gamma
from .ops.filters import apply_filters
from .ops.forces import compute_forces, gravity_vector
from .ops.forces_kernel import compute_forces_kernel, kernel_supported
from .ops.grenier import grenier_density_sigma
from .ops.integrate import compute_dt, euler_step
from .ops.jacobi import jacobi_effpres
from .ops.neighbors import CellGrid, build_cells
from .ops.sa import compute_gamma, impose_boundary_conditions
from .ops.visc import effective_viscosity, sps_stress
from .state import ParticleState


@dataclasses.dataclass
class StepStats:
    """Diagnostics of one sim chunk (the reference's TimingInfo,
    `src/timing.h:43-100`)."""

    max_occupancy: torch.Tensor  # i32[] max particles per cell at last rebuild
    n_active: torch.Tensor  # i32[]
    dt: torch.Tensor  # f32[] dt after the chunk
    max_accel: torch.Tensor
    max_sspeed: torch.Tensor
    max_run: torch.Tensor  # i32[] max kept groups per block (+1e6 on overflow)


class DtZeroException(RuntimeError):
    """dt underflow (reference `src/timing.h:183-196`)."""


class CellOverflowError(RuntimeError):
    """A cell or the neighbor-list plan overflowed its capacity — the
    analogue of the reference's CHECK_NEIBSNUM abort (`src/GPUSPH.cc:1851`)."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def _unported(fw: SimFramework) -> Optional[str]:
    """The missing slice a configuration needs, or None: SA boundaries run
    with gamma by quadrature or with density summation and a dynamic gamma,
    without the options that build on them."""
    if fw.visc.turbmodel == TurbulenceModel.KEPSILON:
        return "the k-epsilon model (ROADMAP item 9)"
    if fw.io is not None:
        return "open boundaries (ROADMAP item 9)"
    return None


def make_sim_chunk(fw: SimFramework, grid: CellGrid, *,
                   bodies_specs=None) -> Callable:
    """Build the chunk function for a framework + grid.

    Returns ``chunk(state, dt, t, iters, bodies) -> (state, dt, t, iters,
    bodies, stats)`` advancing ``buildneibsfreq`` steps after one neighbor
    rebuild.  ``dt`` and ``t`` are f32 0-d tensors on the state's device,
    ``iters`` the global iteration as an int (from a hotfile on resume): the
    filters' cadence follows it.  The forces engine is the kernel where
    ``kernel_supported`` holds, the general pair path otherwise.  Raises
    NotImplementedError for a configuration whose slice is not ported.
    """
    missing = _unported(fw)
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")
    sp = fw.sp
    nsteps = sp.buildneibsfreq
    adaptive = bool(fw.flags & SimFlags.ENABLE_DTADAPT)
    specs = tuple(bodies_specs or ())
    use_kernel = kernel_supported(fw, grid)
    grenier = fw.sph_formulation == SPHFormulation.SPH_GRENIER
    granular = fw.visc.rheologytype == RheologyType.GRANULAR
    needs_sps = fw.visc.turbmodel == TurbulenceModel.SPS
    needs_effvisc = fw.visc.needs_effective_visc
    sa = fw.sa_boundary
    # density summation with gamma carried as state (SA walls only,
    # framework.py); the JAX package's INTEGRATE_GAMMA branch, a dynamic
    # gamma without density summation, has no configuration there
    dyn_gamma = fw.dynamic_gamma

    def forces(state, plan, aux, cells, dt, t):
        """One forces pass at time t; returns it and the state, whose
        density Grenier's COMPUTE_DENSITY, whose effective pressure and
        surface flags the EFFPRES solve and whose wall density the SA
        boundary conditions refreshed."""
        sigma = sps_tau = effvisc = gamma = None
        if grenier:
            # densityGrenierDevice before every forces pass (JAX
            # integrator.py:124-130)
            sigma, rho = grenier_density_sigma(fw, grid, state, aux, cells=cells)
            state = state.replace(rho=rho)
        if granular:
            # the EFFPRES Jacobi solve from the carried effective pressure
            # (JAX integrator.py:127-133)
            ep, info, _ = jacobi_effpres(fw, grid, state, aux, state.extras["effpres"],
                                         cells=cells)
            state = state.replace(extras=dict(state.extras, effpres=ep), info=info)
        if sa:
            # gamma (carried, or by quadrature), then the wall density from
            # the fluid (JAX integrator.py:134-157)
            if dyn_gamma:
                gamma = state.extras["gamma"]
            else:
                gamma, _ = compute_gamma(fw, grid, state, aux, cells=cells, with_grad=False)
            state = impose_boundary_conditions(fw, grid, state, aux, gamma, cells=cells)
        # CALC_VISC before each forces pass (JAX integrator.py:95-106)
        if needs_sps:
            sps_tau, _ = sps_stress(fw, grid, state, aux, cells=cells)
        if needs_effvisc:
            effvisc = effective_viscosity(fw, grid, state, aux, cells=cells,
                                          effpres=state.extras.get("effpres"))
        if use_kernel:
            return compute_forces_kernel(fw, grid, state, plan, effvisc), state
        return compute_forces(fw, grid, state, aux, dt=dt, sps_tau=sps_tau,
                              effvisc=effvisc, sigma=sigma, t=t, cells=cells,
                              gamma=gamma), state

    def post_euler(state_n, state_new, dt_eff, aux, cells):
        """DENSITY_SUM from the step's base state n to the Euler step's
        state, then the diffusion pass on the summed state (JAX
        integrator.py:183-204)."""
        state_new = density_sum_update(fw, grid, state_n, state_new, aux, cells=cells)
        return apply_density_diffusion(fw, grid, state_new, aux, dt_eff, cells=cells)

    def pc_step(state, dt, t, bodies, plan, aux, cells, it):
        # FILTER: the density filters due at global iteration it
        state = apply_filters(fw, grid, state, aux, it, cells=cells)

        # PREDICTOR: forces at n, integrate to n* with dt/2
        f1, state = forces(state, plan, aux, cells, dt, t)
        half = euler_step(fw, state, f1, dt * 0.5, step=1, grid=grid)
        if specs:
            b1 = reduce_body_forces(specs, state, f1.DvDt, bodies)
            # the gravity callback at t, else the constant (JAX
            # integrator.py:175-176)
            b_half = step_bodies(specs, b1, gravity_vector(fw, t), t, dt * 0.5)
            half = apply_body_motion(specs, half, b_half, dt * 0.5)
        if dyn_gamma:
            half = post_euler(state, half, dt * 0.5, aux, cells)

        # CORRECTOR: forces at n*, integrate n -> n+1 with dt
        f2, half = forces(half, plan, aux, cells, dt, t + dt * 0.5)
        new_state = euler_step(fw, state, f2, dt, step=2, full_dt=dt, grid=grid)
        if specs:
            b2 = reduce_body_forces(specs, half, f2.DvDt, bodies)
            bodies = step_bodies(specs, b2, gravity_vector(fw, t + dt * 0.5), t + dt * 0.5,
                                 dt)
            new_state = apply_body_motion(specs, new_state, bodies, dt)
        if dyn_gamma:
            new_state = post_euler(state, new_state, dt, aux, cells)

        new_dt = compute_dt(fw, f2) if adaptive else dt
        return new_state, new_dt, t + dt, bodies, f2

    def chunk(state: ParticleState, dt, t, iters: int, bodies: BodiesState):
        state, aux = build_cells(grid, state)
        # the block plan serves the kernel path only
        plan = build_block_plan(fw, grid, state, aux) if use_kernel else None
        cells = None
        if not use_kernel or fw.filters or needs_effvisc or granular:
            # the occupied cells for the neighbor passes, found once per
            # chunk (waits for the device)
            cells = torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)
        f2 = None
        for k in range(nsteps):
            state, dt, t, bodies, f2 = pc_step(state, dt, t, bodies, plan, aux, cells,
                                               iters + k)
        stats = StepStats(
            max_occupancy=aux.max_occupancy,
            n_active=aux.n_active,
            dt=dt,
            max_accel=f2.max_accel,
            max_sspeed=f2.max_sspeed,
            max_run=plan.max_run if use_kernel else torch.zeros_like(aux.max_occupancy),
        )
        return state, dt, t, iters + nsteps, bodies, stats

    return chunk


@dataclasses.dataclass
class Simulator:
    """Host-side loop around the chunk — the reference's GPUSPH manager
    (`src/GPUSPH.cc:721-860`): termination, overflow and dt checks, perf
    counters (MIPPS).  Runs on ``cuda`` unless ``device`` names another."""

    fw: SimFramework
    grid: CellGrid
    bodies_specs: tuple = ()
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.fw = self.fw.finalize()
        self._chunk = make_sim_chunk(self.fw, self.grid,
                                     bodies_specs=self.bodies_specs)
        # the plan's per-block capacity for the overflow check; always on
        self._run_cap = plan_dims(self.fw, self.grid, 0)["RMAX"]
        self.iterations = 0
        self.t = 0.0
        self.dt = self.fw.sp.dt
        self.particle_steps = 0
        self.elapsed = 0.0
        self.bodies: Optional[BodiesState] = None  # created by run()
        self.finished = False  # set for the last on_write call of run()

    def initial_dt(self) -> float:
        """Initial dt: 0.1 h/c0 like the reference default when dt not set."""
        sp, pp = self.fw.sp, self.fw.pp
        if sp.dt > 0:
            return sp.dt
        c0max = max(f.c0 for f in pp.fluids)
        return 0.1 * sp.slength / c0max

    def run(
        self,
        state: ParticleState,
        *,
        tend: Optional[float] = None,
        maxiter: Optional[int] = None,
        on_write: Optional[Callable] = None,
        write_every: float = 0.0,
    ) -> ParticleState:
        """Run until tend/maxiter, calling ``on_write(sim, state)`` at the
        start, at the write cadence (the doWrite path, `src/GPUSPH.cc:1573`)
        and once at the end, with ``sim.finished`` set for that last call.
        The state is moved to the simulator's device first.  A resumed
        Simulator (``t``, ``dt``, ``iterations`` and ``bodies`` set from a
        hotfile) continues from them."""
        sp = self.fw.sp
        tend = sp.tend if tend is None else tend
        maxiter = sp.maxiter if maxiter is None else maxiter
        state = state.to(self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        dt = torch.tensor(self.dt if self.dt else self.initial_dt(), **f32)
        t = torch.tensor(self.t, **f32)
        iters = self.iterations
        next_write = self.t + write_every if write_every > 0 else float("inf")
        if self.bodies is None:
            self.bodies = init_bodies_state(self.bodies_specs, state)
        else:
            self.bodies = self.bodies.to(self.device)

        self.finished = False
        if self.fw.dynamic_gamma and self.iterations == 0:
            # dynamic gamma seeded by quadrature on a fresh start (saInitGamma);
            # a resume keeps the hotfile's (JAX integrator.py:340-351)
            state, aux = build_cells(self.grid, state)
            state = init_dynamic_gamma(self.fw, self.grid, state, aux)

        if on_write is not None:
            on_write(self, state)
        while True:
            t0 = time.perf_counter()
            state, dt, t, iters, self.bodies, stats = self._chunk(
                state, dt, t, iters, self.bodies)
            self._check(stats)  # reads the stats: waits for the device
            self.elapsed += time.perf_counter() - t0
            self.iterations = iters
            self.t = float(t)
            self.dt = float(stats.dt)
            self.particle_steps += int(stats.n_active) * sp.buildneibsfreq
            if (tend and self.t >= tend) or (maxiter and self.iterations >= maxiter):
                break
            if self.t >= next_write and on_write is not None:
                on_write(self, state)
                next_write += write_every
        self.finished = True
        if on_write is not None:
            on_write(self, state)
        return state

    def _check(self, stats: StepStats):
        occ = int(stats.max_occupancy)
        if occ > self.fw.sp.max_parts_per_cell:
            raise CellOverflowError(
                f"cell occupancy {occ} exceeds max_parts_per_cell="
                f"{self.fw.sp.max_parts_per_cell}; raise SimParams.max_parts_per_cell")
        run = int(stats.max_run)
        if run > self._run_cap:
            raise CellOverflowError(
                f"neighbor-list load {run} exceeds the per-block capacity "
                f"{self._run_cap} groups; raise SimParams.max_block_groups (or, "
                "if the value is >= 1e6: max_blocks / max_run_extent / "
                "max_flat_tiles)")
        dt = float(stats.dt)
        if not (dt > 1e-10):
            raise DtZeroException(f"timestep underflow: dt={dt}")

    @property
    def mipps(self) -> float:
        """Million particle-iterations per second (reference `src/timing.h:103-170`)."""
        if self.elapsed == 0:
            return 0.0
        return self.particle_steps / self.elapsed / 1e6


__all__ = ["Simulator", "make_sim_chunk", "StepStats", "DtZeroException",
           "CellOverflowError", "resolve_device"]
