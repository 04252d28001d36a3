"""Post-processing passes run at write-out: vorticity, test points, surface
detection.

Counterpart of the JAX package's ``ops/postprocess.py`` and of the
reference's post-process engine (`AbstractPostProcessEngine`
`src/engine_postprocess.h:50`, kernels in `src/cuda/post_process_kernel.cu`):
per-particle derived quantities computed on demand at write-out time
(saveParticles POSTPROCESS pass, `src/GPUSPH.cc:1732`), on the state's
device, over the cell-pair combinator (`ops/pair.py`).

* vorticity: omega_i = sum_j m_j/rho_j (v_ij x grad W_ij)
  (`post_process_kernel.cu` vorticityDevice)
* test points: SPH interpolation of velocity/pressure at TESTPOINT particles
  (`calcTestpointsVelocityDevice`); only the cells that hold a test point
  are visited, the other rows do not depend on the sums
* surface detection: free-surface flag from the kernel-gradient cone
  criterion (`calcSurfaceparticleDevice`): a particle is surface if no
  neighbor lies inside the cone around the (normalized) density-gradient
  direction

The IO flux pass (FLUX_COMPUTATION) belongs to open boundaries, a later
slice of the port.
"""
from __future__ import annotations

import torch

from ..defs import ParticleType, PostProcessType
from ..framework import SimFramework
from ..state import FG_SURFACE, ParticleState, fluid_num, is_active, part_type
from . import eos
from .kernels import F as kernF
from .kernels import W as kernW
from .neighbors import CellAux, CellGrid, build_cells, cell_hash
from .pair import merge_vec, neighbor_apply, split_vec


def _fields(fw: SimFramework, state: ParticleState):
    f_num = fluid_num(state.info)
    return dict(
        **split_vec("pos", state.pos),
        **split_vec("vel", state.vel),
        mass=state.mass,
        rho=eos.physical_density(fw.pp, state.rho, f_num),
        press=eos.pressure(fw.pp, state.rho, f_num),
        ptype=part_type(state.info),
    )


def _apply(fw, grid, aux, fields, pair_fn, cells=None):
    return neighbor_apply(
        grid, aux, fields, pair_fn,
        max_parts_per_cell=fw.sp.max_parts_per_cell,
        influenceradius=fw.sp.influenceradius,
        cells=cells,
    )


def vorticity(fw: SimFramework, grid: CellGrid, state: ParticleState,
              aux: CellAux):
    """omega = curl(v) per fluid particle (BUFFER_VORTICITY)."""
    h = fw.sp.slength

    def pair_fn(c, n, g):
        ok = g.mask & (c["ptype"] == ParticleType.FLUID) & (
            n["ptype"] == ParticleType.FLUID
        )
        f = kernF(fw.kerneltype, g.r, h)
        coeff = torch.where(ok, n["mass"] / n["rho"] * f, 0.0)
        relvx = c["vel_x"] - n["vel_x"]
        relvy = c["vel_y"] - n["vel_y"]
        relvz = c["vel_z"] - n["vel_z"]
        # v_ij x (r_ij * f): grad W = f * rel
        return {
            "w_x": coeff * (relvy * g.relz - relvz * g.rely),
            "w_y": coeff * (relvz * g.relx - relvx * g.relz),
            "w_z": coeff * (relvx * g.rely - relvy * g.relx),
        }

    sums = _apply(fw, grid, aux, _fields(fw, state), pair_fn)
    return merge_vec(sums, "w")


def testpoint_values(fw: SimFramework, grid: CellGrid, state: ParticleState,
                     aux: CellAux):
    """Shepard-weighted interpolation of velocity and pressure at TESTPOINT
    particles (calcTestpointsVelocityDevice).  Returns (vel [N,3] with the
    interpolated velocity on test-point rows, press [N], 0 elsewhere)."""
    h = fw.sp.slength
    is_tp = part_type(state.info) == ParticleType.TESTPOINT
    # the cells that hold a test point (the trash cell holds inactive ones)
    cells = torch.unique(aux.hash_sorted[is_tp])
    cells = cells[cells < grid.n_cells]

    def pair_fn(c, n, g):
        ok = g.mask & (n["ptype"] == ParticleType.FLUID)
        w = torch.where(ok, kernW(fw.kerneltype, g.r, h) * n["mass"] / n["rho"], 0.0)
        return {
            "shepard": w,
            "v_x": w * n["vel_x"],
            "v_y": w * n["vel_y"],
            "v_z": w * n["vel_z"],
            "p": w * n["press"],
        }

    sums = _apply(fw, grid, aux, _fields(fw, state), pair_fn, cells)
    den = torch.clamp(sums["shepard"], min=1e-10)
    vel = merge_vec(sums, "v") / den[:, None]
    press = sums["p"] / den
    return (
        torch.where(is_tp[:, None], vel, state.vel),
        torch.where(is_tp, press, 0.0),
    )


def surface_detection(fw: SimFramework, grid: CellGrid, state: ParticleState,
                      aux: CellAux):
    """Free-surface flags via the kernel-gradient cone criterion
    (calcSurfaceparticleDevice): compute the renormalized density-gradient
    normal, then flag particles with no neighbor inside the cone around it.

    Returns (new_info with FG_SURFACE set, normals [N,3]).
    """
    h = fw.sp.slength
    fields = _fields(fw, state)

    # pass 1: surface normal = - sum m_j grad W (direction of density grad)
    def normal_fn(c, n, g):
        f = kernF(fw.kerneltype, g.r, h)
        coeff = torch.where(g.mask, n["mass"] / n["rho"] * f, 0.0)
        return {
            "n_x": coeff * g.relx,
            "n_y": coeff * g.rely,
            "n_z": coeff * g.relz,
        }

    normal = -merge_vec(_apply(fw, grid, aux, fields, normal_fn), "n")
    nn = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal_hat = normal / torch.clamp(nn, min=1e-10)

    fields2 = dict(fields, **split_vec("nrm", normal_hat))

    # pass 2: cone check — any neighbor within the cone kills the flag
    cosangle = fw.pp.cosconeanglefluid

    def cone_fn(c, n, g):
        inv_r = 1.0 / torch.clamp(g.r, min=1e-10)
        # cos of angle between (neighbor - central) and the normal
        cosang = -(
            c["nrm_x"] * g.relx + c["nrm_y"] * g.rely + c["nrm_z"] * g.relz
        ) * inv_r
        inside = g.mask & (cosang > cosangle)
        return {"blockers": torch.where(inside, 1.0, 0.0)}

    blockers = _apply(fw, grid, aux, fields2, cone_fn)["blockers"]
    surface = (part_type(state.info) == ParticleType.FLUID) & (blockers < 0.5)
    info = torch.where(surface, state.info | FG_SURFACE, state.info & ~FG_SURFACE)
    return info, normal_hat


def make_write_postprocess(fw: SimFramework, grid: CellGrid):
    """POSTPROCESS pass for write-out (the reference runs the enabled
    post-process engines inside ``saveParticles``, `src/GPUSPH.cc:1732`).

    Returns ``run(state) -> dict`` of per-particle tensors on the state's
    device, aligned with the *input* particle order (the writer's order),
    or ``None`` when the framework enables no post-processing.  Keys:
    ``Vorticity`` [N,3], ``TestpointVel`` [N,3] / ``TestpointPress`` [N]
    (testpoint rows only), ``Info`` (with FG_SURFACE refreshed) and
    ``Normals`` [N,3].  Raises NotImplementedError for FLUX_COMPUTATION.
    """
    pps = tuple(fw.postprocess)
    if not pps:
        return None
    if PostProcessType.FLUX_COMPUTATION in pps:
        raise NotImplementedError(
            "not ported yet: the IO flux post-process pass (FLUX_COMPUTATION) "
            "comes with the open-boundary slice")

    def run(state: ParticleState):
        # local sort (the write-out state has evolved since the last rebuild)
        h = cell_hash(grid, state.pos, is_active(state.info))
        order = torch.argsort(h, stable=True)
        inv = torch.argsort(order, stable=True)
        sstate, aux = build_cells(grid, state)
        out = {}
        if PostProcessType.VORTICITY in pps:
            w = vorticity(fw, grid, sstate, aux)
            out["Vorticity"] = w[inv]
        if PostProcessType.TESTPOINTS in pps:
            vel, press = testpoint_values(fw, grid, sstate, aux)
            out["TestpointVel"] = vel[inv]
            out["TestpointPress"] = press[inv]
        if PostProcessType.SURFACE_DETECTION in pps:
            info, normals = surface_detection(fw, grid, sstate, aux)
            out["Info"] = info[inv]
            out["Normals"] = normals[inv]
        return out

    return run


__all__ = [
    "vorticity",
    "testpoint_values",
    "surface_detection",
    "make_write_postprocess",
]
