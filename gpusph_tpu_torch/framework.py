"""SimFramework: the static model configuration that selects kernel variants.

Copy of the JAX package's ``framework.py`` (pure Python).  It is the
analogue of the reference's compile-time framework factory
``CUDASimFramework<...>`` (`src/cuda/cudasimframework.cu:130-233`) and the
abstract engine container ``SimFramework`` (`src/simframework.h:65-136`): a
frozen, hashable bundle of option enums + parameter structs.  The port's step
functions close over it and its options select branches at run time; the
CUDA forces kernel receives them as a struct of run-time values.

The option-combination validity matrix mirrors
`src/cuda/cudasimframework.cu:148-189`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Tuple

from .defs import (
    AverageOperator,
    BoundaryType,
    ComputationalViscosityType,
    DensityDiffusionType,
    FilterType,
    KernelType,
    Periodicity,
    PostProcessType,
    RheologyType,
    SHEAR_DEPENDENT_RHEOLOGIES,
    SimFlags,
    SPHFormulation,
    TurbulenceModel,
    ViscousModel,
)
from .params import PhysParams, SimParams, finalize_physparams


@dataclass(frozen=True)
class ViscSpec:
    """Viscous model specification (reference `src/visc_spec.h:250-320`)."""

    rheologytype: RheologyType = RheologyType.NEWTONIAN
    turbmodel: TurbulenceModel = TurbulenceModel.LAMINAR_FLOW
    compvisc: ComputationalViscosityType = ComputationalViscosityType.KINEMATIC
    viscmodel: ViscousModel = ViscousModel.MORRIS
    avgop: AverageOperator = AverageOperator.ARITHMETIC

    @property
    def is_inviscid(self) -> bool:
        return self.rheologytype == RheologyType.INVISCID

    @property
    def needs_effective_visc(self) -> bool:
        return self.rheologytype in SHEAR_DEPENDENT_RHEOLOGIES


@dataclass(frozen=True)
class SimFramework:
    """Full static model configuration."""

    kerneltype: KernelType = KernelType.WENDLAND
    sph_formulation: SPHFormulation = SPHFormulation.SPH_F1
    densitydiffusiontype: DensityDiffusionType = DensityDiffusionType.NONE
    boundarytype: BoundaryType = BoundaryType.LJ_BOUNDARY
    periodicbound: Periodicity = Periodicity.NONE
    visc: ViscSpec = field(default_factory=ViscSpec)
    flags: SimFlags = SimFlags.ENABLE_DTADAPT
    simparams: SimParams = field(default_factory=SimParams)
    physparams: PhysParams = field(default_factory=PhysParams)
    # density filters: ((FilterType, frequency), ...)
    filters: Tuple[Tuple[FilterType, int], ...] = ()
    # enabled post-processing passes
    postprocess: Tuple[PostProcessType, ...] = ()
    # geometric plane boundaries ((point3, normal3), ...) for ENABLE_PLANES
    # (reference `src/planes.h`, GeometryForce `forces_kernel.cu:190-210`)
    planes: Tuple[Tuple[Tuple[float, float, float], Tuple[float, float, float]], ...] = ()
    # DEM terrain descriptor (ENABLE_DEM): packed hashable height field,
    # see ops/dem.pack_dem (reference TopoCube + geom_core.cu DEM force)
    dem: Optional[tuple] = None
    # open-boundary spec (ENABLE_INLET_OUTLET): ops/io_boundary.IOSpec with
    # the problem's imposed velocity/pressure callbacks + outflow region
    io: Optional[tuple] = None
    # variable gravity: traceable t -> (gx, gy, gz), evaluated inside the
    # step before each forces pass (the reference's per-iteration
    # ProblemCore::g_callback, `src/ProblemCore.h:539` + simparams gcallback;
    # used e.g. by Seiche, `src/problems/Seiche.cu:93-100`).  None = constant
    # physparams.gravity.  Compared by identity.
    gcallback: Optional[Callable] = None

    def __post_init__(self):
        self.validate()

    # --- option-combination validity (cudasimframework.cu:148-189) ---------
    def validate(self) -> None:
        v = self.visc
        if v.turbmodel == TurbulenceModel.ARTIFICIAL and v.rheologytype not in (
            RheologyType.INVISCID,
            RheologyType.NEWTONIAN,
        ):
            raise ValueError("artificial viscosity only supports inviscid/Newtonian rheology")
        if v.rheologytype == RheologyType.GRANULAR and v.turbmodel not in (
            TurbulenceModel.LAMINAR_FLOW,
        ):
            raise ValueError("granular rheology does not support turbulence models")
        if v.turbmodel == TurbulenceModel.KEPSILON and self.boundarytype != BoundaryType.SA_BOUNDARY:
            raise ValueError("k-epsilon requires SA boundaries")
        if (self.flags & SimFlags.ENABLE_INLET_OUTLET) and self.boundarytype != BoundaryType.SA_BOUNDARY:
            raise ValueError("open boundaries require SA boundaries")
        if (self.flags & SimFlags.ENABLE_DENSITY_SUM) and self.boundarytype != BoundaryType.SA_BOUNDARY:
            raise ValueError("density summation requires SA boundaries")
        if (self.flags & SimFlags.ENABLE_DENSITY_SUM) and (
            self.flags & SimFlags.ENABLE_GAMMA_QUADRATURE
        ):
            # reference cudasimframework.cu invalid-combination check
            raise ValueError("density summation is incompatible with gamma quadrature")
        if self.sph_formulation == SPHFormulation.SPH_GRENIER and self.boundarytype == BoundaryType.SA_BOUNDARY:
            raise ValueError("Grenier's formulation does not support SA boundaries")
        if self.sph_formulation == SPHFormulation.SPH_GRENIER:
            if self.densitydiffusiontype not in (
                DensityDiffusionType.NONE,
                DensityDiffusionType.COLAGROSSI,
            ):
                raise ValueError(
                    "Grenier's formulation only supports Molteni & Colagrossi "
                    "density diffusion (volume-ratio variant)"
                )
            if not v.is_inviscid and v.viscmodel not in (
                ViscousModel.MORRIS,
                ViscousModel.ESPANOL_REVENGA,
            ):
                raise ValueError(
                    "Grenier's formulation requires the Morris or "
                    "Espanol-Revenga viscous model"
                )
        if (
            self.densitydiffusiontype == DensityDiffusionType.BREZZI
            and self.sph_formulation != SPHFormulation.SPH_HA
            and not (self.flags & SimFlags.ENABLE_DENSITY_SUM)
            and self.boundarytype == BoundaryType.SA_BOUNDARY
        ):
            # Brezzi with SA prefers density sum; reference warns, we allow
            pass

    # --- convenience -------------------------------------------------------
    @property
    def sp(self) -> SimParams:
        return self.simparams

    @property
    def pp(self) -> PhysParams:
        return self.physparams

    @property
    def slength(self) -> float:
        return self.simparams.slength

    @property
    def influenceradius(self) -> float:
        return self.simparams.influenceradius

    @property
    def is_inviscid(self) -> bool:
        return self.visc.is_inviscid

    @property
    def has_xsph(self) -> bool:
        return bool(self.flags & SimFlags.ENABLE_XSPH)

    @property
    def has_moving_bodies(self) -> bool:
        return bool(self.flags & SimFlags.ENABLE_MOVING_BODIES)

    @property
    def dyn_boundary(self) -> bool:
        return self.boundarytype == BoundaryType.DYN_BOUNDARY

    @property
    def sa_boundary(self) -> bool:
        return self.boundarytype == BoundaryType.SA_BOUNDARY

    @property
    def repulsive_boundary(self) -> bool:
        return self.boundarytype in (BoundaryType.LJ_BOUNDARY, BoundaryType.MK_BOUNDARY)

    @property
    def dynamic_gamma(self) -> bool:
        """USING_DYNAMIC_GAMMA (reference `src/simflags.h`): gamma carried as
        per-particle state and integrated in time from grad-gamma fluxes
        instead of re-quadratured each pass.  Density sum always implies it;
        plain SA configs keep the quadrature engine unless they set
        ENABLE_DENSITY_SUM (this build's conservative default — the
        reference defaults to dynamic for all SA)."""
        return self.sa_boundary and bool(self.flags & SimFlags.ENABLE_DENSITY_SUM)

    def finalize(self) -> "SimFramework":
        """Fill derived parameter defaults (see params.finalize_physparams)
        and propagate the framework periodicity into SimParams."""
        sp = replace(self.simparams, periodicbound=self.periodicbound)
        pp = finalize_physparams(sp, self.physparams)
        return replace(self, simparams=sp, physparams=pp)


def setup_framework(**kwargs) -> SimFramework:
    """Named-option framework construction, in the spirit of the reference's
    ``SETUP_FRAMEWORK(kernel<WENDLAND>, viscosity<ARTVISC>, ...)``
    (`src/ProblemCore.h:117`).

    Accepts: kernel, formulation, density_diffusion, boundary, periodicity,
    rheology, turbulence_model, computational_visc, visc_model, visc_average,
    flags, simparams, physparams, filters, postprocess.
    """
    visc_kwargs = {}
    for src, dst in (
        ("rheology", "rheologytype"),
        ("turbulence_model", "turbmodel"),
        ("computational_visc", "compvisc"),
        ("visc_model", "viscmodel"),
        ("visc_average", "avgop"),
    ):
        if src in kwargs:
            visc_kwargs[dst] = kwargs.pop(src)

    mapped = {}
    rename = {
        "kernel": "kerneltype",
        "formulation": "sph_formulation",
        "density_diffusion": "densitydiffusiontype",
        "boundary": "boundarytype",
        "periodicity": "periodicbound",
    }
    for k, v in kwargs.items():
        if k == "filters" and isinstance(v, dict):
            # accept {FilterType: freq} (reference addFilter style) as well
            # as ((FilterType, freq), ...)
            v = tuple(v.items())
        mapped[rename.get(k, k)] = v
    if visc_kwargs:
        mapped["visc"] = ViscSpec(**visc_kwargs)
    return SimFramework(**mapped)


__all__ = ["SimFramework", "ViscSpec", "setup_framework"]
