"""Semi-analytical (SA) boundaries: gamma quadrature, analytic grad-gamma,
and the segment/vertex boundary-condition pass.

Counterpart of the JAX package's ``ops/sa.py`` (the reference's SA
machinery, Ferrand et al.), in plain PyTorch on ``ops/pair.py:neighbor_apply``:

* ``gamma`` / ``grad gamma``: the wall-renormalization factor
  gamma_a = 1 - sum_s gamma_as and its gradient sum_s ||grad gamma_as|| n_s,
  with gamma_as evaluated by a 5th-order Gaussian quadrature over each
  boundary element (triangle) and ||grad gamma_as|| by the analytical
  Wendland formula (`src/cuda/gamma.cuh:96-515`: wendlandOnSegment,
  gaussQuadratureO5, gradGamma<WENDLAND>, Gamma<WENDLAND, PT_FLUID>;
  `initGammaDevice`, `boundary_conditions_kernel.cu:1893`).  Gamma is
  recomputed by quadrature before every forces pass (the reference's
  QUADRATURE gamma mode); the dynamic gamma of density summation waits for
  its slice (ROADMAP item 8b).
* boundary conditions: segments and vertices get their density imposed from
  the Shepard-weighted, hydrostatically corrected fluid pressure
  (`saSegmentBoundaryConditionsDevice` fluid loop + impose_solid_bc,
  `src/cuda/boundary_conditions_kernel.cu:1427-1530,1290-1320`).  The
  k-epsilon wall values and the open-boundary Riemann imposition raise:
  they wait for ROADMAP items 9a and 9b.

Segment data lives in the particle state's extras: ``belem`` [N,3] (inward
unit normal; also set for vertices, the averaged adjacent segment normals)
and ``vr0/vr1/vr2`` [N,3] (triangle vertex positions relative to the
segment barycenter; zeros for non-segments).  The mesh builder
(``geometry/sa_mesh.py``) keeps the counter-clockwise vertex order
(cross(v1-v0, v2-v0) parallel to the inward normal) that the analytic
grad-gamma formula requires.  Every formula keeps the JAX package's f32
operation order, so the CPU results meet it within the libm differences of
atan2, acosh and sqrt.
"""
from __future__ import annotations

import math

import torch

from ..defs import ParticleType, TurbulenceModel
from ..state import fluid_num, part_type
from . import eos
from .kernels import W as kernW
from .pair import neighbor_apply, split_vec

# 5th-order Gaussian quadrature on the triangle (gamma.cuh:43-55), with the
# multiplicities expanded to the 7 explicit (weight, b0, b1, b2) points
_GQ5 = []
_gq_w = (0.225, 0.132394152788506, 0.125939180544827)
_gq_p = (
    (0.333333333333333, 0.333333333333333, 0.333333333333333),
    (0.059715871789770, 0.470142064105115, 0.470142064105115),
    (0.797426985353087, 0.101286507323456, 0.101286507323456),
)
_gq_mult = (1, 3, 3)
for _i in range(3):
    for _j in range(_gq_mult[_i]):
        _p = _gq_p[_i]
        _GQ5.append((_gq_w[_i], _p[_j % 3], _p[(_j + 1) % 3], _p[(_j + 2) % 3]))

# integrated Wendland coefficient 1/(32 pi) (gamma.cuh:102)
_WENDLAND_I = 1.0 / (32.0 * math.pi)


def _wendland_on_segment(q):
    """Integral of the Wendland kernel over the half-line (gamma.cuh:94-113)."""
    qs = torch.clamp(q, min=1e-6)
    tmp = torch.clamp(1.0 - 0.5 * qs, min=0.0)
    t2 = tmp * tmp
    t5 = t2 * t2 * tmp
    uq = 1.0 / qs
    val = _WENDLAND_I * t5 * ((((8.0 * uq + 20.0) * uq + 30.0) * uq) + 21.0)
    return torch.where(q < 2.0, val, 0.0)


def _wendland_on_seg_len(x, y, z):
    return _wendland_on_segment(torch.sqrt(x * x + y * y + z * z))


def _gauss_quadrature_o5(u0, u1, u2, q):
    """Surface integral of the integrated-Wendland function over the
    triangle with vertices u0,u1,u2 (h-units, relative to barycenter),
    evaluated at the particle position q (gamma.cuh:139-165).  All
    arguments are (x,y,z) component triples of broadcastable tensors."""
    val = 0.0
    for (w, b0, b1, b2) in _GQ5:
        pax = u0[0] * b0 + u1[0] * b1 + u2[0] * b2 - q[0]
        pay = u0[1] * b0 + u1[1] * b1 + u2[1] * b2 - q[1]
        paz = u0[2] * b0 + u1[2] * b1 + u2[2] * b2 - q[2]
        val = val + w * _wendland_on_seg_len(pax, pay, paz)
    # triangle area (in h^2 units)
    e1 = tuple(u1[k] - u0[k] for k in range(3))
    e2 = tuple(u2[k] - u0[k] for k in range(3))
    cx = e1[1] * e2[2] - e1[2] * e2[1]
    cy = e1[2] * e2[0] - e1[0] * e2[2]
    cz = e1[0] * e2[1] - e1[1] * e2[0]
    vol = 0.5 * torch.sqrt(cx * cx + cy * cy + cz * cz)
    return val * vol


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm3(a):
    return torch.sqrt(torch.clamp(_dot3(a, a), min=1e-20))


def _normalize3(a):
    n = _norm3(a)
    return tuple(c / n for c in a)


def _cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _sign(x):
    """copysign(1, x): -1 where x carries the sign bit (-0 included)."""
    return torch.copysign(torch.ones_like(x), x)


def grad_gamma_wendland(q, qvb, ns, slength):
    """|| grad gamma_as || — the analytic Wendland formula, a vectorized
    port of `gradGamma<WENDLAND>` (gamma.cuh:247-371).

    ``q``: particle position relative to the segment barycenter (h-units),
    component triple; ``qvb``: tuple of 3 component triples, the *negated*
    vertex positions relative to the barycenter in h-units (the reference's
    calcVertexRelPos convention, gamma.cuh:197-226); ``ns``: inward unit
    normal triple.
    """
    pas = _dot3(ns, q)
    qas = torch.abs(pas)
    qas2 = qas * qas
    qas4 = qas2 * qas2
    qas5 = qas4 * qas

    gradG = 0.0
    totalSumAngles = 0.0
    sumAngles = 0.0

    for e in range(3):
        s0 = qvb[e % 3]
        s1 = qvb[(e + 1) % 3]
        v01 = _normalize3(tuple(s0[k] - s1[k] for k in range(3)))
        ne = _normalize3(_cross3(ns, v01))
        qm0 = tuple(q[k] - s0[k] for k in range(3))
        qm1 = tuple(q[k] - s1[k] for k in range(3))
        pae = _dot3(ne, qm0)
        # distance from the particle to the edge line
        qae = _norm3(tuple(pas * ns[k] + pae * ne[k] for k in range(3)))
        pav0 = -_dot3(qm0, v01)
        pav1 = -_dot3(qm1, v01)

        abs_pae = torch.abs(pae)
        ang = torch.atan2(pav1, abs_pae) - torch.atan2(pav0, abs_pae)
        ang = torch.copysign(ang, pae)
        totalSumAngles = totalSumAngles + ang

        near = qae < 2.0
        qae_c = torch.clamp(qae, max=2.0 - 1e-6)
        lim = torch.sqrt(torch.clamp(4.0 - qae_c * qae_c, min=0.0))
        pav0c = torch.copysign(torch.minimum(torch.abs(pav0), lim), pav0)
        pav1c = torch.copysign(torch.minimum(torch.abs(pav1), lim), pav1)
        pav02 = pav0c * pav0c
        pav12 = pav1c * pav1c
        qav0 = torch.clamp(torch.sqrt(qae_c * qae_c + pav02), max=2.0)
        qav1 = torch.clamp(torch.sqrt(qae_c * qae_c + pav12), max=2.0)
        pae2 = pae * pae
        pae4 = pae2 * pae2
        pae6 = pae4 * pae2

        COEFF = 1.0 / 2048.0 / math.pi
        qae_f = torch.clamp(qae_c, min=1e-7)
        term = COEFF * (
            48.0 * qas5 * (28.0 + qas2) * (
                torch.atan2(qas * pav1c, pae * qav1) - torch.atan2(pav1c, pae)
                - (torch.atan2(qas * pav0c, pae * qav0) - torch.atan2(pav0c, pae))
            )
            + pae * (
                pav1c * (
                    3.0 * qas4 * (-420.0 + 29.0 * qav1)
                    + pae4 * (-420.0 + 33.0 * qav1)
                    + 2.0 * qas2 * (-210.0 * (8.0 + pav12) + 756.0 * qav1 + 19.0 * pav12 * qav1)
                    + 4.0 * (336.0 + pav12 * (pav12 * (-21.0 + 2.0 * qav1) + 28.0 * (-5.0 + 3.0 * qav1)))
                    + 2.0 * pae2 * (420.0 * (-2.0 + qav1) + 6.0 * qas2 * (-105.0 + 8.0 * qav1) + pav12 * (-140.0 + 13.0 * qav1))
                )
                - pav0c * (
                    3.0 * qas4 * (-420.0 + 29.0 * qav0)
                    + pae4 * (-420.0 + 33.0 * qav0)
                    + 2.0 * qas2 * (-210.0 * (8.0 + pav02) + 756.0 * qav0 + 19.0 * pav02 * qav0)
                    + 4.0 * (336.0 + pav02 * (pav02 * (-21.0 + 2.0 * qav0) + 28.0 * (-5.0 + 3.0 * qav0)))
                    + 2.0 * pae2 * (420.0 * (-2.0 + qav0) + 6.0 * qas2 * (-105.0 + 8.0 * qav0) + pav02 * (-140.0 + 13.0 * qav0))
                )
                + 3.0 * (
                    5.0 * pae6 + 21.0 * pae4 * (8.0 + qas2)
                    + 35.0 * pae2 * qas2 * (16.0 + qas2) + 35.0 * qas4 * (24.0 + qas2)
                ) * (
                    _sign(pav1c) * torch.acosh(torch.clamp(qav1 / qae_f, min=1.0))
                    - _sign(pav0c) * torch.acosh(torch.clamp(qav0 / qae_f, min=1.0))
                )
            )
        )
        gradG = gradG + torch.where(near, term, 0.0)
        # the reference adds the *clipped* pav angles here (pav0/pav1 are
        # reassigned before the sumAngles line, gamma.cuh:356)
        ang_c = torch.copysign(
            torch.atan2(pav1c, abs_pae) - torch.atan2(pav0c, abs_pae), pae)
        sumAngles = sumAngles + torch.where(near, ang_c, 0.0)

    # clipped-vertex / non-intersected-edge correction (gamma.cuh:362-369)
    tmp1 = torch.clamp(1.0 - 0.5 * qas, min=0.0)
    t2 = tmp1 * tmp1
    t5 = t2 * t2 * tmp1
    COEFF2 = 3.0 / 16.0 / math.pi
    gradG = gradG + (sumAngles - totalSumAngles) * COEFF2 * t5 * (
        2.0 + 5.0 * qas + 4.0 * qas2
    )
    return torch.where(qas < 2.0, gradG / slength, 0.0)


def gamma_fluid_wendland(q, qvb, ns, epsilon=0.01):
    """gamma_as for a (fluid) particle vs one segment, quadrature form
    (Gamma<WENDLAND, PT_FLUID>, gamma.cuh:398-436)."""
    pas = _dot3(ns, q)
    q_aSigma = torch.clamp(torch.abs(pas), max=2.0)
    # quadrature vertices are the *positive* vertex rel positions (-qvb)
    u0 = tuple(-c for c in qvb[0])
    u1 = tuple(-c for c in qvb[1])
    u2 = tuple(-c for c in qvb[2])
    g = _gauss_quadrature_o5(u0, u1, u2, q) * pas
    return torch.where((q_aSigma < 2.0) & (q_aSigma > epsilon), g, 0.0)


class PairSlots:
    """The pair slots of a ``neighbor_apply`` block where ``mask`` holds.

    A segment term is non-zero on a few pairs of a block (a fluid particle
    near a wall against the segments within reach): ``take`` gathers a
    tensor broadcastable to the block's [C,K,NB] shape at those slots, and
    ``put`` scatters values computed there back into a [C,K,NB] tensor of
    zeros, the value ``torch.where(mask, value, 0.0)`` would give.  Finding
    the slots waits for the device once per block."""

    def __init__(self, mask):
        self.shape = mask.shape
        _, K, NB = mask.shape
        self.flat = torch.nonzero(mask.reshape(-1)).squeeze(1)
        self.idx = (self.flat // (K * NB), (self.flat // NB) % K, self.flat % NB)

    def take(self, t):
        return t[tuple(i if n > 1 else 0 for i, n in zip(self.idx, t.shape))]

    def put(self, v):
        out = torch.zeros(self.shape.numel(), dtype=v.dtype, device=v.device)
        out[self.flat] = v
        return out.reshape(self.shape)


def sa_pair_inputs(n, g, slength, slots):
    """Common geometry of fluid-vs-segment pair terms at the pair ``slots``
    (a :class:`PairSlots`): q (relative position in h-units), qvb (negated
    vertex relative positions in h-units) and ns (the neighbor's normal)."""
    inv_h = 1.0 / slength
    take = slots.take
    q = (take(g.relx) * inv_h, take(g.rely) * inv_h, take(g.relz) * inv_h)
    ns = (take(n["nrm_x"]), take(n["nrm_y"]), take(n["nrm_z"]))
    qvb = tuple(
        tuple(-take(n[f"vr{i}_{ax}"]) * inv_h for ax in "xyz") for i in range(3)
    )
    return q, qvb, ns


def sa_extra_fields(state):
    """Per-particle SA fields of the pair passes: the normals and the
    triangles' vertex offsets (zeros off segment rows)."""
    out = split_vec("nrm", state.extras["belem"])
    for i in range(3):
        out.update(split_vec(f"vr{i}", state.extras[f"vr{i}"]))
    return out


def compute_gamma(fw, grid, state, aux, *, cells=None, with_grad=True):
    """(gamma [N], grad gamma [N,3]) of every particle by quadrature over
    its segment neighbors (initGammaDevice semantics, run every pass).

    Fluid rows get 1 - sum gamma_as clipped to [1e-3, 1]; segment and vertex
    rows sit on the wall, where the quadrature is singular, and get the
    flat-wall value 0.5 (used only as a Shepard floor).  ``with_grad=False``
    skips the grad-gamma sums (None in their place): the quadrature path
    needs gamma alone."""
    sp = fw.sp
    h = sp.slength
    ptype = part_type(state.info)
    fields = dict(**split_vec("pos", state.pos), ptype=ptype, **sa_extra_fields(state))
    BOUND = ParticleType.BOUNDARY

    def pair_fn(c, n, g):
        # the quadrature and grad gamma run on the segment pairs alone
        slots = PairSlots(g.mask & (n["ptype"] == BOUND))
        q, qvb, ns = sa_pair_inputs(n, g, h, slots)
        out = {"gamma_def": slots.put(gamma_fluid_wendland(q, qvb, ns))}
        if with_grad:
            gg = grad_gamma_wendland(q, qvb, ns, h)
            out["gg_x"] = slots.put(gg * ns[0])
            out["gg_y"] = slots.put(gg * ns[1])
            out["gg_z"] = slots.put(gg * ns[2])
        return out

    sums = neighbor_apply(
        grid, aux, fields, pair_fn,
        max_parts_per_cell=sp.max_parts_per_cell,
        # segments interact through their whole triangle: the expanded
        # search radius (reference boundNlSqInflRad, GPUWorker.cc:1890)
        influenceradius=sp.influenceradius + 0.5 * sp.deltap,
        cells=cells,
    )
    gamma = torch.clamp(1.0 - sums["gamma_def"], 1e-3, 1.0)
    gamma = torch.where(ptype != ParticleType.FLUID, 0.5, gamma)
    if not with_grad:
        return gamma, None
    return gamma, torch.stack([sums["gg_x"], sums["gg_y"], sums["gg_z"]], dim=-1)


def impose_boundary_conditions(fw, grid, state, aux, gamma, *, cells=None):
    """The state with the density of segments and vertices imposed from
    the fluid (saSegment/VertexBoundaryConditionsDevice fluid loops +
    impose_solid_bc): the Shepard average of the hydrostatically corrected
    fluid pressure on the wall's inner side, its Shepard sum floored at
    0.1 gamma, through the inverse equation of state."""
    if fw.visc.turbmodel == TurbulenceModel.KEPSILON:
        raise NotImplementedError(
            "SA wall conditions: not ported yet: the k-epsilon model (ROADMAP item 9a)")
    if fw.io is not None:
        raise NotImplementedError(
            "SA wall conditions: not ported yet: open boundaries (ROADMAP item 9b)")
    sp, pp = fw.sp, fw.pp
    h = sp.slength
    f_num = fluid_num(state.info)
    ptype = part_type(state.info)
    fields = dict(
        **split_vec("pos", state.pos),
        rho=eos.physical_density(pp, state.rho, f_num),
        press=eos.pressure(pp, state.rho, f_num),
        ptype=ptype,
        **split_vec("nrm", state.extras["belem"]),
    )
    gvec = pp.gravity
    FLUID = ParticleType.FLUID
    rad2 = torch.tensor(sp.influenceradius**2, dtype=torch.float32, device=state.pos.device)

    def pair_fn(c, n, g):
        # fluid on the inner side of the wall normal (r_wall - r_fluid
        # against the inward normal); the wall sums are fluid-kernel sums,
        # at the true influence radius
        inner = (c["nrm_x"] * g.relx + c["nrm_y"] * g.rely + c["nrm_z"] * g.relz) < 0.0
        ok = (g.mask & (c["ptype"] != FLUID) & (n["ptype"] == FLUID) & inner
              & (g.r2 < rad2))
        w = kernW(fw.kerneltype, g.r, h)
        # hydrostatically corrected wall pressure (bc_kernel.cu:1513)
        g_dot_rel = gvec[0] * g.relx + gvec[1] * g.rely + gvec[2] * g.relz
        pwall = torch.clamp(n["press"] + n["rho"] * g_dot_rel, min=0.0)
        return {"sumpWall": torch.where(ok, pwall * w, 0.0),
                "shepard": torch.where(ok, w, 0.0)}

    sums = neighbor_apply(grid, aux, fields, pair_fn,
                          max_parts_per_cell=sp.max_parts_per_cell,
                          influenceradius=sp.influenceradius, cells=cells)
    shepard = torch.maximum(sums["shepard"], 0.1 * gamma)
    rho_wall = eos.density_from_pressure(pp, sums["sumpWall"] / shepard, f_num)
    is_wall = (ptype == ParticleType.BOUNDARY) | (ptype == ParticleType.VERTEX)
    return state.replace(rho=torch.where(is_wall, rho_wall, state.rho))


__all__ = [
    "compute_gamma",
    "impose_boundary_conditions",
    "grad_gamma_wendland",
    "gamma_fluid_wendland",
    "sa_extra_fields",
    "sa_pair_inputs",
    "PairSlots",
]
