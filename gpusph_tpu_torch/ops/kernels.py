"""SPH smoothing kernels W and their radial derivative factor F = (1/r) dW/dr.

Counterpart of the JAX package's ``ops/kernels.py`` (reference
`src/cuda/sph_core.cu:66-195`, normalizations `src/cuda/forces.cu:273-309`):

* cubic spline: W coeff 1/(pi h^3), F coeff 3/(4 pi h^4)
* quadratic:    W coeff 15/(16 pi h^3), F coeff 15/(32 pi h^4)
* Wendland:     W coeff 21/(16 pi h^3), F coeff 105/(128 pi h^5)
* Gaussian:     truncated at R=kernelradius (3), normalized so the truncated
                kernel integrates to 1 over the support.

All functions take a float32 tensor of distances ``r`` and the smoothing
length ``h`` (a Python float) and return a tensor of the same shape.  They do
NOT mask at the cutoff; callers apply the ``r < influenceradius`` mask.  The
CUDA forces kernel (`csrc/forces.cu`) carries the same formulas.
"""
from __future__ import annotations

import math

import torch

from ..defs import KERNEL_RADIUS, KernelType


def w_cubicspline(r, h: float):
    R = r / h
    coeff = 1.0 / (math.pi * h**3)
    inner = 1.0 - 1.5 * R * R + 0.75 * R * R * R
    outer = 0.25 * (2.0 - R) ** 3
    return coeff * torch.where(R < 1.0, inner, outer)


def f_cubicspline(r, h: float):
    R = r / h
    coeff = 3.0 / (4.0 * math.pi * h**4)
    inner = (-4.0 + 3.0 * R) / h
    # guard r=0 in the outer branch (unused there: outer only for R>=1)
    outer = -((-2.0 + R) ** 2) / torch.where(r > 0, r, torch.ones_like(r))
    return coeff * torch.where(R < 1.0, inner, outer)


def w_quadratic(r, h: float):
    R = r / h
    coeff = 15.0 / (16.0 * math.pi * h**3)
    return coeff * (0.25 * R * R - R + 1.0)


def f_quadratic(r, h: float):
    R = r / h
    coeff = 15.0 / (32.0 * math.pi * h**4)
    return coeff * (-2.0 + R) / torch.where(r > 0, r, torch.full_like(r, math.inf))


def w_wendland(r, h: float):
    R = r / h
    coeff = 21.0 / (16.0 * math.pi * h**3)
    val = 1.0 - 0.5 * R
    val = val * val
    val = val * val  # (1 - R/2)^4
    return coeff * val * (1.0 + 2.0 * R)


def f_wendland(r, h: float):
    qm2 = r / h - 2.0
    coeff = 105.0 / (128.0 * math.pi * h**5)
    return coeff * qm2 * qm2 * qm2


def gaussian_coeffs(h: float):
    """(exp(-R^2), W coefficient, F coefficient) of the truncated Gaussian
    (reference `src/cuda/forces.cu:300-309`)."""
    R = KERNEL_RADIUS[KernelType.GAUSSIAN]
    R2 = R * R
    exp_R2 = math.exp(-R2)
    norm = (-2.0 * exp_R2 / 3.0 * h**3 * math.pi * R * (3.0 + 2.0 * R2)
            + h**3 * math.pi ** 1.5 * math.erf(R))
    wcoeff = 1.0 / norm
    fcoeff = wcoeff * 2.0 / (h * h)
    return exp_R2, wcoeff, fcoeff


def w_gaussian(r, h: float):
    R = r / h
    wsub, wcoeff, _ = gaussian_coeffs(h)
    return wcoeff * (torch.exp(-R * R) - wsub)


def f_gaussian(r, h: float):
    R = r / h
    _, _, fcoeff = gaussian_coeffs(h)
    return -torch.exp(-R * R) * fcoeff


_W = {
    KernelType.CUBICSPLINE: w_cubicspline,
    KernelType.QUADRATIC: w_quadratic,
    KernelType.WENDLAND: w_wendland,
    KernelType.GAUSSIAN: w_gaussian,
}

_F = {
    KernelType.CUBICSPLINE: f_cubicspline,
    KernelType.QUADRATIC: f_quadratic,
    KernelType.WENDLAND: f_wendland,
    KernelType.GAUSSIAN: f_gaussian,
}


def W(kerneltype: KernelType, r, h: float):
    """Kernel value at distance r for smoothing length h."""
    return _W[KernelType(kerneltype)](r, h)


def F(kerneltype: KernelType, r, h: float):
    """(1/r) dW/dr at distance r — so that grad_i W(r_ij) = F * (x_i - x_j)."""
    return _F[KernelType(kerneltype)](r, h)


__all__ = ["W", "F", "gaussian_coeffs"]
