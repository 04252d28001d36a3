"""gpusph_tpu_torch: the PyTorch/CUDA port of gpusph_tpu for NVIDIA Hopper.

The JAX package ``gpusph_tpu`` is the reference; this package imports none of
it.  Plain tensor code is PyTorch; the SPH forces pass is a CUDA C++ kernel
written for ``sm_90a`` (``csrc/forces.cu``), built by ``nvcc`` at first use.
Entry points (``Simulator``, ``python -m gpusph_tpu_torch``) run on the card
unless the caller passes ``device="cpu"``.

Ported so far: DamBreak3D end to end (cell sort, block plan, forces kernel,
predictor-corrector Euler, moving-body feedback, adaptive dt).
"""
from .defs import (
    BoundaryType,
    DensityDiffusionType,
    KernelType,
    ParticleType,
    RheologyType,
    SimFlags,
    SPHFormulation,
    TurbulenceModel,
    ViscousModel,
)
from .framework import SimFramework, setup_framework
from .params import Fluid, PhysParams, SimParams

__all__ = [
    "BoundaryType",
    "DensityDiffusionType",
    "KernelType",
    "ParticleType",
    "RheologyType",
    "SimFlags",
    "SPHFormulation",
    "TurbulenceModel",
    "ViscousModel",
    "SimFramework",
    "setup_framework",
    "Fluid",
    "PhysParams",
    "SimParams",
]
