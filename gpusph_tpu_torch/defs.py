"""Model-option enums: the compile-time option space of the simulation framework.

This mirrors the reference's named-template-option space (GPUSPH
`src/particledefine.h:79-299`, `src/simflags.h`, `src/visc_spec.h:52-120`) as
plain Python enums.  A concrete combination of these options — a
:class:`gpusph_tpu_torch.framework.SimFramework` — selects which kernel
branches run, playing the role of the reference's
``CUDASimFramework<...>`` template instantiation
(`src/cuda/cudasimframework.cu:130-233`).

Everything here is *static* configuration: values are Python ints used as
static arguments at trace time, never traced values.
"""
from __future__ import annotations

import enum


class IntEnum(enum.IntEnum):
    """IntEnum whose str() is just the member name (for summaries/CLIs)."""

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


class KernelType(IntEnum):
    """Smoothing kernel type (reference `src/particledefine.h:79-104`)."""

    CUBICSPLINE = 1
    QUADRATIC = 2
    WENDLAND = 3
    GAUSSIAN = 4


#: Kernel radius (cutoff in units of the smoothing length h) per kernel type,
#: reference `src/particledefine.h:106-118`.
KERNEL_RADIUS = {
    KernelType.CUBICSPLINE: 2.0,
    KernelType.QUADRATIC: 2.0,
    KernelType.WENDLAND: 2.0,
    KernelType.GAUSSIAN: 3.0,
}


class SPHFormulation(IntEnum):
    """SPH formulation (reference `src/particledefine.h:120-135`)."""

    SPH_F1 = 1  # single-fluid
    SPH_F2 = 2  # density-ratio corrected
    SPH_GRENIER = 3  # Grenier's multi-fluid sigma/volume formulation
    SPH_HA = 4  # Hu & Adams multi-fluid formulation


class DensityDiffusionType(IntEnum):
    """Density diffusion model (reference `src/particledefine.h:150-165`)."""

    NONE = 0
    FERRARI = 1
    COLAGROSSI = 2  # Molteni & Colagrossi 2009
    BREZZI = 3


class BoundaryType(IntEnum):
    """Boundary model (reference `src/particledefine.h:180-200`)."""

    LJ_BOUNDARY = 0  # Lennard-Jones repulsive boundary force
    MK_BOUNDARY = 1  # Monaghan-Kajtar repulsive boundary force
    SA_BOUNDARY = 2  # semi-analytical boundaries (Ferrand et al.)
    DYN_BOUNDARY = 3  # dynamic boundary particles (Dalrymple)


class ParticleType(IntEnum):
    """Particle type (reference `src/particleinfo.h:132-138`)."""

    FLUID = 0
    BOUNDARY = 1
    VERTEX = 2
    TESTPOINT = 3
    NONE = 4  # inactive / padding slot


class RheologyType(IntEnum):
    """Rheology (reference `src/visc_spec.h:52-76`)."""

    INVISCID = 0
    NEWTONIAN = 1
    BINGHAM = 2
    PAPANASTASIOU = 3
    POWER_LAW = 4
    HERSCHEL_BULKLEY = 5
    ALEXANDROU = 6  # regularized Herschel-Bulkley
    DEKEE_TURCOTTE = 7
    ZHU = 8
    GRANULAR = 9


#: Rheologies whose effective viscosity depends on the local shear rate and
#: therefore need a per-particle effective-viscosity pass (reference
#: `src/visc_spec.h` NEEDS_EFFECTIVE_VISC).
SHEAR_DEPENDENT_RHEOLOGIES = frozenset(
    {
        RheologyType.BINGHAM,
        RheologyType.PAPANASTASIOU,
        RheologyType.POWER_LAW,
        RheologyType.HERSCHEL_BULKLEY,
        RheologyType.ALEXANDROU,
        RheologyType.DEKEE_TURCOTTE,
        RheologyType.ZHU,
        RheologyType.GRANULAR,
    }
)


class TurbulenceModel(IntEnum):
    """Turbulence model (reference `src/visc_spec.h:78-99`)."""

    LAMINAR_FLOW = 0
    ARTIFICIAL = 1  # artificial viscosity ("ARTVISC")
    SPS = 2  # sub-particle-scale (Smagorinsky)
    KEPSILON = 3


class ViscousModel(IntEnum):
    """Discretization of the viscous operator (reference `src/visc_spec.h:101-113`)."""

    MORRIS = 0
    MONAGHAN = 1
    ESPANOL_REVENGA = 2


class ComputationalViscosityType(IntEnum):
    """Whether the user-given viscosity is kinematic or dynamic
    (reference `src/visc_spec.h:115-120`)."""

    KINEMATIC = 0
    DYNAMIC = 1


class AverageOperator(IntEnum):
    """Averaging operator for the viscosity of a pair (reference `src/average.h`)."""

    ARITHMETIC = 0
    HARMONIC = 1
    GEOMETRIC = 2


class FilterType(IntEnum):
    """Density filters (reference `src/particledefine.h:255-260`)."""

    SHEPARD = 0
    MLS = 1


class PostProcessType(IntEnum):
    """Post-processing passes (reference `src/particledefine.h:290-299`)."""

    VORTICITY = 0
    TESTPOINTS = 1
    SURFACE_DETECTION = 2
    INTERFACE_DETECTION = 3
    FLUX_COMPUTATION = 4
    CALC_PRIVATE = 5


class WriterType(IntEnum):
    """Particle-dump writer kinds (reference `src/Writer.h:58-75`; UDP /
    Display/Catalyst writers are not applicable in this headless target —
    the CallbackWriter analogue is ``Simulator.run(on_write=...)``)."""

    TEXTWRITER = 0
    VTKWRITER = 1
    VTKLEGACYWRITER = 2
    COMMONWRITER = 3
    HOTWRITER = 4


class Periodicity(enum.IntFlag):
    """Periodic boundary axes (reference `src/particledefine.h:231-243`)."""

    NONE = 0
    X = 1
    Y = 2
    Z = 4
    XY = 3
    XZ = 5
    YZ = 6
    XYZ = 7


class SimFlags(enum.IntFlag):
    """Run-time feature flags (reference `src/simflags.h`)."""

    NONE = 0
    ENABLE_XSPH = 1 << 0
    ENABLE_DTADAPT = 1 << 1
    ENABLE_PLANES = 1 << 2
    ENABLE_DEM = 1 << 3
    ENABLE_INLET_OUTLET = 1 << 4
    ENABLE_DENSITY_SUM = 1 << 5
    ENABLE_GAMMA_QUADRATURE = 1 << 6
    ENABLE_INTERNAL_ENERGY = 1 << 7
    ENABLE_MOVING_BODIES = 1 << 8
    ENABLE_REPACKING = 1 << 9
    ENABLE_WATER_DEPTH = 1 << 10
    ENABLE_MULTIFLUID = 1 << 11


class IntegratorType(IntEnum):
    """Integrator scheme (reference `src/Integrator.h` + `src/integrators/`)."""

    PREDITOR_CORRECTOR = 0  # [sic] — reference spelling, kept for parity
    REPACKING = 1
