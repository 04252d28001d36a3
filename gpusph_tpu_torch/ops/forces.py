"""Forces-pass output and pair helpers.

The part of the JAX package's ``ops/forces.py`` that the forces kernel path
needs: the output record and the small helpers of the pair physics.  The
general pair path (``compute_forces``) is not ported yet; the kernel path
lives in ``ops/forces_kernel.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..defs import AverageOperator


@dataclasses.dataclass
class ForcesOut:
    """Per-particle RHS + reduction results of one forces pass
    (the analogue of BUFFER_FORCES + BUFFER_XSPH + BUFFER_CFL)."""

    DvDt: torch.Tensor  # f32[N,3] acceleration
    DrDt: torch.Tensor  # f32[N] relative-density rate (already /rho0)
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


__all__ = ["ForcesOut"]
