"""Simulation and physical parameters.

Copy of the JAX package's ``params.py`` (pure Python): the analogue of the
reference's ``SimParams`` (`src/simparams.h:48-386`) and ``PhysParams``
(`src/physparams.h:113-421`).  Both are *static* (hashable, frozen)
dataclasses that the step functions close over; the forces kernel receives
their values as launch parameters — the analogue of the
reference uploading them to CUDA ``__constant__`` memory
(`src/cuda/forces.cu:270-430`).

Per-fluid quantities are tuples indexed by fluid number.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from .defs import (
    KERNEL_RADIUS,
    KernelType,
    Periodicity,
)


def _tuple_set(t: Tuple, i: int, v) -> Tuple:
    """Return tuple ``t`` with element ``i`` replaced by ``v`` (grow as needed)."""
    lst = list(t)
    while len(lst) <= i:
        lst.append(None)
    lst[i] = v
    return tuple(lst)


@dataclass(frozen=True)
class Fluid:
    """Physical properties of one fluid (reference `src/physparams.h` per-fluid arrays).

    Density is stored everywhere as the *relative* density
    ``rho_tilde = rho/rho0 - 1`` (reference `src/cuda/phys_core.cu:139-152`),
    so ``rho0`` only ever appears in the EOS coefficients and in
    conversions at the IO boundary.
    """

    rho0: float = 1000.0  # at-rest density [kg/m^3]
    gamma: float = 7.0  # EOS polytropic exponent
    c0: float = 10.0  # at-rest sound speed [m/s]
    # Laminar viscosity. kinematic_visc = dynamic_visc / rho0.
    kinematic_visc: float = 1.0e-6  # [m^2/s]
    # Non-Newtonian / granular parameters (reference `src/physparams.h:151-220`)
    bulk_visc: float = 0.0  # second (bulk) viscosity, Espanol & Revenga
    yield_strength: float = 0.0  # Bingham / Herschel-Bulkley tau_0
    visc_nonlinear_param: float = 1.0  # power-law / HB exponent n; Zhu/DeKee coeff
    visc_regularization_param: float = 100.0  # Papanastasiou / Alexandrou m
    sinpsi: float = 0.0  # granular: sin(internal friction angle)
    cohesion: float = 0.0  # granular: cohesion

    # --- derived EOS coefficients ------------------------------------------
    @property
    def bcoeff(self) -> float:
        """EOS stiffness B = rho0 c0^2 / gamma (reference `d_bcoeff`)."""
        return self.rho0 * self.c0 * self.c0 / self.gamma

    @property
    def sspowercoeff(self) -> float:
        """(gamma-1)/2, exponent of the sound-speed law (`d_sspowercoeff`)."""
        return (self.gamma - 1.0) / 2.0

    @property
    def dynamic_visc(self) -> float:
        return self.kinematic_visc * self.rho0


@dataclass(frozen=True)
class PhysParams:
    """Physical parameters shared by all kernels (reference `src/physparams.h:113-421`)."""

    fluids: Tuple[Fluid, ...] = (Fluid(),)
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)

    # Lennard-Jones boundary repulsion (reference `d_dcoeff/d_p1coeff/d_p2coeff/d_r0`)
    r0: float = 0.0  # influence distance of the LJ boundary force (~deltap)
    dcoeff: float = 0.0  # LJ force magnitude D (typically 5 g H)
    p1coeff: float = 12.0
    p2coeff: float = 6.0

    # Monaghan-Kajtar boundary repulsion (reference `d_MK_*`)
    mk_k: float = 0.0  # typically max velocity squared or g*H
    mk_d: float = 0.0  # typically distance between boundary particles
    mk_beta: float = 0.0  # typically h / MK_d

    # Artificial viscosity (reference `src/physparams.h:151-165`)
    artvisccoeff: float = 0.3
    epsartvisc: float = float("nan")  # defaults to 0.01 h^2 (set in finalize())

    # XSPH correction factor (reference `src/physparams.h` epsxsph)
    epsxsph: float = 0.5

    # SPS (Smagorinsky) factors: smagfactor = (Cs*dp)^2, kspsfactor = (2*Ci/3)*dp^2
    smagorinsky_constant: float = 0.12
    isotropic_sps_constant: float = 0.0066
    smagfactor: float = float("nan")
    kspsfactor: float = float("nan")

    # Upper bound on kinematic viscosity (granular; reference `d_limiting_kinvisc`)
    limiting_kinvisc: float = float("inf")
    # Monaghan viscous-model multiplicative coefficient
    monaghan_visc_coeff: float = float("nan")

    # free-surface detection cone angles (reference `d_cosconeangle*`)
    cosconeanglefluid: float = 0.86
    cosconeanglenonfluid: float = 0.5

    # interface epsilon for Grenier's pseudo surface tension
    epsinterface: float = 0.0

    # particle surface, typically deltap^2 (plane viscous force)
    partsurf: float = 0.0

    # repacking parameters (reference `d_repack_alpha/d_repack_a`)
    repack_alpha: float = 0.01
    repack_a: float = 0.1

    @property
    def num_fluids(self) -> int:
        return len(self.fluids)

    @property
    def rho0s(self) -> Tuple[float, ...]:
        return tuple(f.rho0 for f in self.fluids)

    def with_fluid(self, i: int, fluid: Fluid) -> "PhysParams":
        return replace(self, fluids=_tuple_set(self.fluids, i, fluid))


@dataclass(frozen=True)
class SimParams:
    """Numerical simulation parameters (reference `src/simparams.h:48-386`)."""

    # discretization
    deltap: float = 0.0  # inter-particle distance
    sfactor: float = 1.3  # smoothing factor: h = sfactor * deltap
    kerneltype: KernelType = KernelType.WENDLAND

    # time stepping
    dt: float = 0.0  # initial/fixed dt (0 -> derived in finalize())
    dtadaptfactor: float = 0.3  # CFL safety factor
    viscdtfactor: float = 0.03  # explicit viscous-diffusion dt factor (h^2/nu)
    tend: float = 0.0  # simulated end time (0 = no limit)
    maxiter: int = 0  # max iterations (0 = no limit)

    # neighbor list
    buildneibsfreq: int = 10  # rebuild the neighbor structure every N iters
    neiblistsize: int = 128  # kept for API parity; the cell bins are sized instead
    neibboundpos: int = 255
    # max particles per cell in the binned-cell neighbor structure;
    # the analogue of the reference's neighbor-list capacity (CHECK_NEIBSNUM).
    # Bulk cells hold ~(cellsize/dp)^3 ~= 18-21 particles; wall corners with
    # stacked dynamic-boundary layers can reach the high 30s.  Keeping
    # 3*K <= 128 kept the JAX package's Pallas kernel on single-tile candidate runs.
    max_parts_per_cell: int = 40
    # Max particles in any SPAN+2 consecutive fast-axis cells (the forces
    # kernel's candidate-run extent).  0 -> worst case (SPAN+2) *
    # max_parts_per_cell.  Problems auto-size this from the initial
    # occupancy; exceeded at runtime -> abort (CHECK_NEIBSNUM analogue).
    max_run_extent: int = 0
    # Forces-kernel per-rebuild neighbor-list capacity, in 16-particle groups per
    # 64-central block (the analogue of the reference's neiblistsize,
    # `simparams.h:96`).  0 -> worst case (every candidate group kept);
    # Problems auto-probe a tight value.  Exceeded at runtime -> abort.
    max_block_groups: int = 0
    # Static bound on forces-kernel central blocks (0 -> worst case); auto-probed.
    max_blocks: int = 0
    # Static capacity of the flat per-rebuild window-tile list (sum over
    # blocks of ceil(kept_groups / groups_per_tile)); 0 -> worst case
    # (max_blocks * max_block_groups / groups_per_tile).  Auto-probed.
    max_flat_tiles: int = 0
    # Expansion factor applied to the influence radius when building the
    # neighbor list, so pairs approaching within a chunk are still found
    # (reference `simparams.h:100`; Spheric2SA.cu:70 uses 1.1).
    nlexpansionfactor: float = 1.0
    # kept for field parity with the JAX package, where it selects a
    # bfloat16 pair chain; the port's forces kernel computes in f32 and
    # ignores it
    pairs_bf16: bool = False

    # periodicity
    periodicbound: Periodicity = Periodicity.NONE

    # open boundaries
    numOpenBoundaries: int = 0

    # density filters: {FilterType: frequency}; frozen as a tuple of pairs
    filters: Tuple[Tuple[int, int], ...] = ()

    # Ferrari density diffusion length scale
    ferrariLengthScale: float = float("nan")
    densityDiffCoeff: float = float("nan")

    # gage positions etc. live in the Problem, not here

    # repacking
    repack_maxiter: int = 100
    repack_a: float = 0.1
    repack_alpha: float = 0.01

    # Jacobi effective-pressure solver (granular rheology,
    # reference `src/simparams.h:244-258`)
    jacobi_maxiter: int = 1000
    jacobi_backerr: float = 1e-5
    jacobi_residual: float = 1e-6

    # internal-energy computation
    # (reference tracks this via ENABLE_INTERNAL_ENERGY simflag)

    @property
    def slength(self) -> float:
        """Smoothing length h = sfactor * deltap (reference `src/simparams.h:331`)."""
        return self.sfactor * self.deltap

    @property
    def kernelradius(self) -> float:
        return KERNEL_RADIUS[self.kerneltype]

    @property
    def influenceradius(self) -> float:
        """Kernel support radius = h * kernelradius (reference `src/simparams.h:370`)."""
        return self.slength * self.kernelradius

    def set_smoothing(self, smooth: float) -> "SimParams":
        return replace(self, sfactor=smooth)


def finalize_physparams(sp: SimParams, pp: PhysParams) -> PhysParams:
    """Fill in derived defaults that depend on both param structs.

    Mirrors the reference's deferred initialization in
    ``ProblemCore::check_default_values`` and the constant-upload path
    (`src/cuda/forces.cu:270-430`).
    """
    h = sp.slength
    updates = {}
    if math.isnan(pp.epsartvisc):
        updates["epsartvisc"] = 0.01 * h * h
    if math.isnan(pp.smagfactor):
        cs_dp = pp.smagorinsky_constant * sp.deltap
        updates["smagfactor"] = cs_dp * cs_dp
    if math.isnan(pp.kspsfactor):
        updates["kspsfactor"] = (2.0 * pp.isotropic_sps_constant / 3.0) * sp.deltap * sp.deltap
    if pp.partsurf == 0.0:
        updates["partsurf"] = sp.deltap * sp.deltap
    if pp.r0 == 0.0:
        updates["r0"] = sp.deltap
    return replace(pp, **updates) if updates else pp


__all__ = [
    "Fluid",
    "PhysParams",
    "SimParams",
    "finalize_physparams",
]
