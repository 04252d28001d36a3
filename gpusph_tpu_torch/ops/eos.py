"""Cole (Tait) equation of state and sound speed.

Counterpart of the JAX package's ``ops/eos.py`` (reference
`src/cuda/phys_core.cu:105-152`, host helpers `src/ProblemCore.h:234-273`).
All state carries the *relative* density ``rho_tilde = rho/rho0 - 1``; the
per-fluid coefficients are Python floats selected by fluid number with a
short ``torch.where`` chain.
"""
from __future__ import annotations

import torch

from ..params import PhysParams


def _per_fluid(pp: PhysParams, fluid_num: torch.Tensor, values):
    """Select a per-fluid constant by fluid number (f32, shape of
    ``fluid_num``)."""
    out = torch.full(fluid_num.shape, float(values[0]), dtype=torch.float32,
                     device=fluid_num.device)
    for i in range(1, len(values)):
        out = torch.where(fluid_num == i, float(values[i]), out)
    return out


def _pow_maybe_int(x, exponents):
    """x**e per element, by repeated multiplication when every fluid's
    exponent is the same small integer (the common gamma=7 case), in the
    same order as the JAX package so both round alike."""
    uniq = set(float(e) for e in exponents)
    if len(uniq) == 1:
        e = uniq.pop()
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
        return torch.pow(x, e)
    return None


def pressure(pp: PhysParams, rho_tilde, fluid_num):
    """P(rho) = B[(rho/rho0)^gamma - 1] (reference `phys_core.cu:108-113`)."""
    b = _per_fluid(pp, fluid_num, [f.bcoeff for f in pp.fluids])
    rho_ratio = rho_tilde + 1.0
    powed = _pow_maybe_int(rho_ratio, [f.gamma for f in pp.fluids])
    if powed is None:
        gamma = _per_fluid(pp, fluid_num, [f.gamma for f in pp.fluids])
        powed = torch.pow(rho_ratio, gamma)
    return b * (powed - 1.0)


def sound_speed(pp: PhysParams, rho_tilde, fluid_num):
    """c(rho) = c0 (rho/rho0)^((gamma-1)/2) (reference `phys_core.cu:136-142`)."""
    c0 = _per_fluid(pp, fluid_num, [f.c0 for f in pp.fluids])
    powed = _pow_maybe_int(rho_tilde + 1.0, [f.sspowercoeff for f in pp.fluids])
    if powed is None:
        powcoeff = _per_fluid(pp, fluid_num, [f.sspowercoeff for f in pp.fluids])
        powed = torch.pow(rho_tilde + 1.0, powcoeff)
    return c0 * powed


def physical_density(pp: PhysParams, rho_tilde, fluid_num):
    """rho = (rho_tilde + 1) rho0 (reference `phys_core.cu:144-148`)."""
    rho0 = _per_fluid(pp, fluid_num, [f.rho0 for f in pp.fluids])
    return (rho_tilde + 1.0) * rho0


def numerical_density(pp: PhysParams, rho, fluid_num):
    """rho_tilde = rho/rho0 - 1 (reference `phys_core.cu:150-156`)."""
    rho0 = _per_fluid(pp, fluid_num, [f.rho0 for f in pp.fluids])
    return rho / rho0 - 1.0


def hydrostatic_density(pp: PhysParams, depth: torch.Tensor, fluid_num: int):
    """Relative density at a given depth (f32 tensor) under gravity
    (host-side helper, reference `src/ProblemCore.cc` hydrostatic_density)."""
    f = pp.fluids[fluid_num]
    g = abs(pp.gravity[2])
    p = f.rho0 * g * depth
    return torch.pow(p / f.bcoeff + 1.0, 1.0 / f.gamma) - 1.0


__all__ = [
    "pressure",
    "sound_speed",
    "physical_density",
    "numerical_density",
    "hydrostatic_density",
]
