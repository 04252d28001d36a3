"""Particle state: a struct-of-arrays dataclass of tensors with fixed capacity.

Counterpart of the JAX package's ``state.py`` (the reference's buffer system,
`src/buffer.h`, `src/define_buffers.h:48-357`).  Capacity is static (padded):
dead slots carry ``ParticleType.NONE`` and are masked out of every
interaction.

``info`` packs type/flags/fluid-or-object number into 32 bits, mirroring the
reference's ``particleinfo`` (`src/particleinfo.h:79-160`):

* bits 0-2   particle type (ParticleType)
* bits 3-15  flags (FG_*)
* bits 16-23 fluid number (fluid particles) or object number (body particles)
* bits 24-31 open-boundary object number

PyTorch has almost no ``uint32`` arithmetic, so ``info`` and ``id`` are stored
as ``int32`` holding the same bit pattern: bits 24-31 may set the sign bit.
Every helper masks after shifting, so the arithmetic right shift of a
negative word still yields the unsigned field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .defs import ParticleType

# --- info bit layout -------------------------------------------------------

TYPE_BITS = 3
TYPE_MASK = (1 << TYPE_BITS) - 1

# flags (reference `src/particleinfo.h:150-160`)
FG_COMPUTE_FORCE = 1 << 3  # particle contributes to rigid-body force feedback
FG_MOVING_BOUNDARY = 1 << 4  # particle belongs to a moving/floating body
FG_INLET = 1 << 5
FG_OUTLET = 1 << 6
FG_VELOCITY_DRIVEN = 1 << 7  # open boundary with imposed velocity (else pressure)
FG_CORNER = 1 << 8  # corner vertex at open boundaries
FG_SURFACE = 1 << 9  # free-surface particle (set by post-processing)
FG_SEDIMENT = 1 << 10  # granular sediment particle
FG_INACTIVE = 1 << 11  # disabled particle (kept for id continuity)
FG_INTERFACE = 1 << 12  # sediment/phase interface particle (post-processing)

FLUID_NUM_SHIFT = 16
FLUID_NUM_MASK = 0xFF
IO_OBJ_SHIFT = 24
IO_OBJ_MASK = 0xFF


def to_int32_bits(word: int) -> int:
    """The int32 value holding the bit pattern of an unsigned 32-bit word."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word & 0x80000000 else word


def make_info(ptype, flags=0, fluid_or_object=0, io_object=0) -> int:
    """Pack particle type, flags, fluid/object and IO object numbers into
    the int32 info word (a Python int)."""
    word = (
        (int(ptype) & TYPE_MASK)
        | int(flags)
        | ((int(fluid_or_object) & FLUID_NUM_MASK) << FLUID_NUM_SHIFT)
        | ((int(io_object) & IO_OBJ_MASK) << IO_OBJ_SHIFT)
    )
    return to_int32_bits(word)


def part_type(info: torch.Tensor) -> torch.Tensor:
    return info & TYPE_MASK


def fluid_num(info: torch.Tensor) -> torch.Tensor:
    return (info >> FLUID_NUM_SHIFT) & FLUID_NUM_MASK


object_num = fluid_num  # same field, reference `src/particleinfo.h` object()


def io_object_num(info: torch.Tensor) -> torch.Tensor:
    return (info >> IO_OBJ_SHIFT) & IO_OBJ_MASK


def has_flag(info: torch.Tensor, flag: int) -> torch.Tensor:
    return (info & to_int32_bits(flag)) != 0


def is_fluid(info):
    return part_type(info) == ParticleType.FLUID


def is_boundary(info):
    return part_type(info) == ParticleType.BOUNDARY


def is_vertex(info):
    return part_type(info) == ParticleType.VERTEX


def is_active(info):
    """A slot takes part in the simulation: real type and not disabled."""
    return (part_type(info) != ParticleType.NONE) & ~has_flag(info, FG_INACTIVE)


@dataclasses.dataclass
class ParticleState:
    """Fixed-capacity struct-of-arrays particle state.

    The density is the relative density ``rho/rho0 - 1``.  ``extras`` holds
    model-dependent per-particle fields keyed by the reference's buffer
    names.  Functions of the port return new states; none updates a state
    in place.
    """

    pos: torch.Tensor  # f32[N,3]
    vel: torch.Tensor  # f32[N,3]
    rho: torch.Tensor  # f32[N] relative density rho/rho0 - 1
    mass: torch.Tensor  # f32[N]
    info: torch.Tensor  # i32[N] packed type/flags/fluid-object bits
    id: torch.Tensor  # i32[N] persistent particle id
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def active(self) -> torch.Tensor:
        return is_active(self.info)

    def count_active(self) -> torch.Tensor:
        return self.active.sum(dtype=torch.int32)

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "ParticleState":
        """Apply ``fn`` to every tensor field (extras included)."""
        return ParticleState(
            pos=fn(self.pos), vel=fn(self.vel), rho=fn(self.rho),
            mass=fn(self.mass), info=fn(self.info), id=fn(self.id),
            extras={k: fn(v) for k, v in self.extras.items()},
        )

    def to(self, device) -> "ParticleState":
        return self.map(lambda a: a.to(device))


def empty_state(capacity: int, extras: Dict[str, torch.Tensor] | None = None
                ) -> ParticleState:
    """All-dead state of the given capacity, on the CPU."""
    f32 = dict(dtype=torch.float32)
    return ParticleState(
        pos=torch.zeros((capacity, 3), **f32),
        vel=torch.zeros((capacity, 3), **f32),
        rho=torch.zeros((capacity,), **f32),
        mass=torch.zeros((capacity,), **f32),
        info=torch.full((capacity,), int(ParticleType.NONE), dtype=torch.int32),
        id=torch.arange(capacity, dtype=torch.int32),
        extras=dict(extras or {}),
    )


__all__ = [
    "ParticleState",
    "empty_state",
    "make_info",
    "to_int32_bits",
    "part_type",
    "fluid_num",
    "object_num",
    "io_object_num",
    "has_flag",
    "is_fluid",
    "is_boundary",
    "is_vertex",
    "is_active",
    "FG_COMPUTE_FORCE",
    "FG_MOVING_BOUNDARY",
    "FG_INLET",
    "FG_OUTLET",
    "FG_VELOCITY_DRIVEN",
    "FG_CORNER",
    "FG_SURFACE",
    "FG_SEDIMENT",
    "FG_INACTIVE",
    "FG_INTERFACE",
]
