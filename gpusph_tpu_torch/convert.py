"""Carry particle and body state across as numpy arrays.

The field names are those of the JAX package's ``ParticleState``
(``pos, vel, rho, mass, info, id, extras``) and ``BodiesState``, so a dict of
numpy arrays taken from either package feeds the other.  ``info`` and ``id``
are uint32 in the JAX package and int32 (same bits) here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .bodies import BODY_FIELDS, BodiesState
from .state import ParticleState

_F32_FIELDS = ("pos", "vel", "rho", "mass")
_BIT_FIELDS = ("info", "id")


def _bits_to_int32(a) -> np.ndarray:
    a = np.array(a)  # a writable copy
    if a.dtype in (np.uint32, np.int32):
        return a.view(np.int32)
    return a.astype(np.int64).astype(np.uint32).view(np.int32)


def state_from_numpy(d: Mapping, device="cpu") -> ParticleState:
    """ParticleState on ``device`` from a mapping of numpy arrays (or an
    object with those attributes, such as the JAX package's state)."""
    get = d.__getitem__ if isinstance(d, Mapping) else lambda k: getattr(d, k)
    extras = (d.get("extras") if isinstance(d, Mapping)
              else getattr(d, "extras", None)) or {}
    fields = {k: torch.as_tensor(np.array(get(k), np.float32), device=device)
              for k in _F32_FIELDS}
    fields.update({k: torch.as_tensor(_bits_to_int32(get(k)), device=device)
                   for k in _BIT_FIELDS})
    fields["extras"] = {k: torch.as_tensor(np.array(v), device=device)
                        for k, v in extras.items()}
    return ParticleState(**fields)


def state_to_numpy(state: ParticleState) -> dict:
    """Numpy arrays of every field; ``info`` and ``id`` as uint32, the JAX
    package's type."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _F32_FIELDS}
    out.update({k: getattr(state, k).detach().cpu().numpy().view(np.uint32)
                for k in _BIT_FIELDS})
    out["extras"] = {k: v.detach().cpu().numpy() for k, v in state.extras.items()}
    return out


def bodies_from_numpy(d: Mapping, device="cpu") -> BodiesState:
    get = d.__getitem__ if isinstance(d, Mapping) else lambda k: getattr(d, k)
    return BodiesState(**{
        k: torch.as_tensor(np.array(get(k), np.float32), device=device)
        for k in BODY_FIELDS})


def bodies_to_numpy(bodies: BodiesState) -> dict:
    return {k: getattr(bodies, k).detach().cpu().numpy() for k in BODY_FIELDS}


__all__ = ["state_from_numpy", "state_to_numpy", "bodies_from_numpy",
           "bodies_to_numpy"]
