"""Moving & floating rigid bodies (quaternion 6-DOF).

Counterpart of the JAX package's ``bodies.py``: the per-body force/torque
reduction (REDUCE_BODIES_FORCES, `src/engine_forces.h:78-84`), the 6-DOF
integration (MOVE_BODIES, `src/GPUSPH.cc:802-830`) and the rigid
rototranslation of body particles (`src/cuda/euler_kernel.def:474-510`).

Bodies are a small fixed-count dataclass of tensors (``BodiesState``, row 0
is a zero "no body" slot) carrying a unit quaternion orientation, so Euler's
equations are solved in the body (principal) frame:

    I dw_b/dt + w_b x (I w_b) = R^T tau_world

Prescribed motions are callbacks ``motion(t) -> (linvel f32[3], angvel
f32[3])`` on the device of ``t``, built with :func:`body_velocity`;
floating bodies integrate Newton-Euler from the fluid forces, reduced with
``index_add_`` over the particle object numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .state import (
    FG_COMPUTE_FORCE,
    FG_MOVING_BOUNDARY,
    ParticleState,
    has_flag,
    object_num,
)

BODY_FIELDS = ("cg", "quat", "linvel", "angvel", "force", "torque")


@dataclasses.dataclass(frozen=True)
class BodySpec:
    """Static description of one rigid body (object_idx >= 1).

    ``inertia`` is the principal (body-frame) inertia tensor diagonal; the
    body frame initially coincides with the world frame.
    """

    object_idx: int
    mass: float = 1.0
    inertia: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    floating: bool = False
    # prescribed kinematics: motion(t) -> (linvel f32[3], angvel f32[3]) on
    # t's device (body_velocity); ignored for floating bodies
    motion: Optional[Callable] = None
    # hinge / rotation center; None -> use center of gravity of particles
    rotation_center: Optional[Tuple[float, float, float]] = None


@dataclasses.dataclass
class BodiesState:
    """Dynamic state of all bodies; row 0 is a zero 'no body' slot."""

    cg: torch.Tensor  # f32[NB+1,3] rotation/force reference point
    quat: torch.Tensor  # f32[NB+1,4] world<-body orientation (w,x,y,z)
    linvel: torch.Tensor  # f32[NB+1,3]
    angvel: torch.Tensor  # f32[NB+1,3] world frame
    force: torch.Tensor  # f32[NB+1,3] last reduced fluid force
    torque: torch.Tensor  # f32[NB+1,3]

    def replace(self, **kw) -> "BodiesState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "BodiesState":
        return BodiesState(**{k: getattr(self, k).to(device) for k in BODY_FIELDS})


# --- quaternion helpers (w,x,y,z convention, like EulerParameters
#     src/geometries/EulerParameters.h) -------------------------------------

def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_from_axis_angle(aa):
    """Unit quaternion from axis-angle vectors [...,3]."""
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    safe = torch.clamp(theta, min=1e-12)
    half = 0.5 * theta
    xyz = aa / safe * torch.sin(half)
    w = torch.cos(half)
    q = torch.cat([w, xyz], dim=-1)
    ident = torch.cat([torch.ones_like(w), torch.zeros_like(xyz)], dim=-1)
    return torch.where(theta > 1e-12, q, ident)


def quat_rotate(q, v):
    """Rotate vectors v [...,3] by quaternions q [...,4] (world <- body)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_rotate_inv(q, v):
    """Rotate by the conjugate (body <- world)."""
    qc = torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)
    return quat_rotate(qc, v)


def identity_quat(n, device="cpu"):
    q = torch.zeros((n, 4), dtype=torch.float32, device=device)
    q[:, 0] = 1.0
    return q


def body_velocity(t: torch.Tensor, linvel=(0.0, 0.0, 0.0),
                  angvel=(0.0, 0.0, 0.0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a motion callback returns: ``(linvel f32[3], angvel f32[3])`` on
    the device of the 0-d f32 time ``t``.  Each component is a number or a
    0-d tensor computed from ``t`` (``torch.where`` of a time window);
    numbers are filled on the device, so nothing waits for it or copies from
    the host."""
    def vec(parts):
        return torch.stack([c if isinstance(c, torch.Tensor) else torch.full_like(t, c)
                            for c in parts]).to(torch.float32)

    return vec(linvel), vec(angvel)


def init_bodies_state(specs: Sequence[BodySpec], state: ParticleState) -> BodiesState:
    """Initial body state on the state's device; cg from particle masses
    (computed on the host in f32, as the JAX package does) unless a hinge
    is given."""
    nb = len(specs)
    dev = state.pos.device
    cg = np.zeros((nb + 1, 3), np.float32)
    obj = object_num(state.info).cpu().numpy()
    moving = has_flag(state.info, FG_MOVING_BOUNDARY).cpu().numpy()
    pos = state.pos.cpu().numpy()
    mass = state.mass.cpu().numpy()
    for s in specs:
        if s.rotation_center is not None:
            cg[s.object_idx] = s.rotation_center
        else:
            sel = moving & (obj == s.object_idx)
            m = mass[sel]
            if len(m):
                cg[s.object_idx] = (pos[sel] * m[:, None]).sum(0) / m.sum()
    z = torch.zeros((nb + 1, 3), dtype=torch.float32, device=dev)
    return BodiesState(
        cg=torch.as_tensor(cg, device=dev),
        quat=identity_quat(nb + 1, dev),
        linvel=z,
        angvel=z,
        force=z,
        torque=z,
    )


def reduce_body_forces(
    specs: Sequence[BodySpec],
    state: ParticleState,
    DvDt: torch.Tensor,
    bodies: BodiesState,
) -> BodiesState:
    """Per-body fluid force/torque from the boundary particles' hydrodynamic
    accelerations (REDUCE_BODIES_FORCES; the reference sums rbforces and
    rbtorques per object, `src/GPUSPH.cc:802-830`).  ``index_add_`` fills
    fresh zero tensors in place."""
    nb = len(specs)
    obj = object_num(state.info).long()
    contributes = has_flag(state.info, FG_COMPUTE_FORCE) & has_flag(
        state.info, FG_MOVING_BOUNDARY)
    seg = torch.where(contributes, obj, 0)
    f = torch.where(contributes[:, None], DvDt * state.mass[:, None], 0.0)
    force = torch.zeros((nb + 1, 3), dtype=torch.float32, device=f.device)
    force.index_add_(0, seg, f)
    arm = state.pos - bodies.cg[seg]
    tq = torch.where(contributes[:, None], torch.linalg.cross(arm, f), 0.0)
    torque = torch.zeros_like(force)
    torque.index_add_(0, seg, tq)
    return bodies.replace(force=force, torque=torque)


def step_bodies(
    specs: Sequence[BodySpec],
    bodies: BodiesState,
    gravity,
    t,
    dt,
) -> BodiesState:
    """MOVE_BODIES: prescribed kinematics or Newton-Euler integration with
    body-frame inertia (Euler's equations incl. the gyroscopic term).
    ``gravity`` is three numbers, or three 0-d tensors of a gravity
    callback.  Per-body rows are written into fresh copies in place."""
    dev = bodies.cg.device
    linvel = bodies.linvel.clone()
    angvel = bodies.angvel.clone()
    quat = bodies.quat
    g = torch.stack([torch.as_tensor(c, dtype=torch.float32, device=dev) for c in gravity])
    for s in specs:
        i = s.object_idx
        if s.floating:
            acc = bodies.force[i] / s.mass + g
            linvel[i] = linvel[i] + acc * dt
            # Euler's equations in the principal (body) frame:
            #   I dw/dt = tau_b - w x (I w)
            inertia = torch.tensor(s.inertia, dtype=torch.float32, device=dev)
            q = quat[i]
            w_b = quat_rotate_inv(q, angvel[i])
            tau_b = quat_rotate_inv(q, bodies.torque[i])
            dw_b = (tau_b - torch.linalg.cross(w_b, inertia * w_b)) / inertia
            w_b = w_b + dw_b * dt
            angvel[i] = quat_rotate(q, w_b)
        elif s.motion is not None:
            # the callback's tensors are on t's device: no host round trip
            linvel[i], angvel[i] = s.motion(t)
        # bodies without motion stay fixed (feedback-only obstacles)
    cg = bodies.cg + linvel * dt
    # advance orientation by the step's incremental rotation
    dq = quat_from_axis_angle(angvel * dt)
    quat = quat_mul(dq, quat)
    quat = quat / torch.clamp(
        torch.linalg.vector_norm(quat, dim=-1, keepdim=True), min=1e-12)
    return bodies.replace(cg=cg, quat=quat, linvel=linvel, angvel=angvel)


def _axis_angle_rotate(v, axis_angle):
    """Rodrigues rotation of vectors v [N,3] by per-row axis-angle [N,3]."""
    theta = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    safe = torch.clamp(theta, min=1e-12)
    k = axis_angle / safe
    c = torch.cos(theta)
    s = torch.sin(theta)
    kxv = torch.linalg.cross(k, v)
    kdotv = (k * v).sum(dim=-1, keepdim=True)
    rot = v * c + kxv * s + k * kdotv * (1.0 - c)
    return torch.where(theta > 1e-12, rot, v)


def apply_body_motion(
    specs: Sequence[BodySpec],
    state: ParticleState,
    bodies: BodiesState,
    dt,
) -> ParticleState:
    """Rigid rototranslation of body particles over one (sub)step
    (`euler_kernel.def:474-510`): rotate the lever arm about the *pre-step*
    cg by omega*dt, translate by v_cg*dt, set particle velocity to
    v_cg + omega x r.  ``bodies`` is the post-step state, so the pre-step
    cg is cg - linvel*dt."""
    if not specs:
        return state
    obj = object_num(state.info).long()
    moving = has_flag(state.info, FG_MOVING_BOUNDARY)
    seg = torch.where(moving, obj, 0)

    cg = bodies.cg[seg]
    lv = bodies.linvel[seg]
    av = bodies.angvel[seg]

    rel = state.pos - (cg - lv * dt)  # lever arm about the pre-step cg
    rel_rot = _axis_angle_rotate(rel, av * dt)
    new_pos = cg + rel_rot
    new_vel = lv + torch.linalg.cross(av, rel_rot)

    m = moving[:, None]
    return state.replace(
        pos=torch.where(m, new_pos, state.pos),
        vel=torch.where(m, new_vel, state.vel),
    )


def bodies_to_dict(bodies) -> dict:
    """JSON-serializable body state for HotFile checkpoints (the reference
    persists moving-body state in the HotFile, `src/writers/HotFile.h:45-75`).
    ``bodies`` is a BodiesState on any device, or its host copy as a mapping
    of numpy arrays (``convert.bodies_to_numpy``)."""
    if bodies is None:
        return {}
    if isinstance(bodies, BodiesState):
        bodies = {k: getattr(bodies, k).detach().cpu().numpy() for k in BODY_FIELDS}
    return {k: np.asarray(bodies[k]).tolist() for k in BODY_FIELDS}


def bodies_from_dict(d: dict) -> Optional[BodiesState]:
    """Inverse of :func:`bodies_to_dict`, on the CPU; None for an empty
    dict."""
    if not d:
        return None
    return BodiesState(**{k: torch.tensor(d[k], dtype=torch.float32) for k in BODY_FIELDS})


__all__ = [
    "BodySpec",
    "BodiesState",
    "body_velocity",
    "bodies_to_dict",
    "bodies_from_dict",
    "BODY_FIELDS",
    "init_bodies_state",
    "reduce_body_forces",
    "step_bodies",
    "apply_body_motion",
    "quat_mul",
    "quat_rotate",
    "quat_from_axis_angle",
]
