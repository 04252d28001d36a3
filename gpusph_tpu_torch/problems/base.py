"""Problem API: declarative scene construction, on the host in numpy.

Counterpart of the JAX package's ``problems/base.py`` (the reference's
``ProblemCore``, `src/ProblemCore.h:522-682`, and ``ProblemAPI<1>``,
`src/problem_api/ProblemAPI_1.h:49-307`), holding what DamBreak3D uses: a
Problem subclass configures the framework in ``__init__``, declares geometry
with ``add_box`` and ``build()`` produces the (grid, initial ParticleState)
pair — the reference's ``fill_parts`` + ``copy_to_array``
(`src/GPUSPH.cc:252,397`).  The state is built on the CPU; the Simulator
moves it to its device.

Not ported yet: the other geometry kinds (spheres, cylinders, STL, HDF5,
SA meshes), planes, open boundaries and the writers, which ``add_writer``
records for a later slice.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..defs import ParticleType, PostProcessType, SimFlags
from ..framework import SimFramework, setup_framework
from ..geometry import primitives as geo
from ..ops import eos
from ..ops.block_plan import SPAN, probe_plan_numpy
from ..ops.forces_kernel import kernel_supported
from ..ops.neighbors import CellGrid, make_grid
from ..params import Fluid, SimParams
from ..state import (
    FG_COMPUTE_FORCE,
    FG_MOVING_BOUNDARY,
    ParticleState,
    empty_state,
    make_info,
)


class GeometryType(enum.IntEnum):
    """Reference `src/problem_api/ProblemAPI_1.h:49-63`."""

    FLUID = 0
    FIXED_BOUNDARY = 1
    OPENBOUNDARY = 2
    FLOATING_BODY = 3
    MOVING_BODY = 4
    PLANE = 5
    DEM = 6
    TESTPOINT = 7


class FillType(enum.IntEnum):
    """Reference `src/problem_api/ProblemAPI_1.h:64-70`."""

    NOFILL = 0
    SOLID = 1
    BORDER = 2


@dataclasses.dataclass
class Geometry:
    """One placed geometry (reference's GeometryInfo)."""

    gtype: GeometryType
    points: np.ndarray  # [n,3] float64 particle positions
    fluid_idx: int = 0
    object_idx: int = 0
    feedback: bool = False  # enableFeedback: accumulate forces on this body


PROBLEM_REGISTRY: Dict[str, type] = {}


class Problem:
    """Base class for user problems (reference `ProblemCore`/`XProblem`)."""

    name = "Problem"

    def __init__(self, options: Optional[dict] = None):
        self.options = dict(options or {})
        self.geometries: List[Geometry] = []
        self.testpoints: List[Tuple[float, float, float]] = []
        self.origin = (0.0, 0.0, 0.0)
        self.size = (1.0, 1.0, 1.0)
        self.deltap = 0.0
        self.fw: SimFramework = SimFramework()
        self.water_level: Optional[float] = None  # hydrostatic init level
        self.max_fall: Optional[float] = None
        self.dyn_layers = 3
        self.vtk_write_every = 0.0  # recorded for the writers slice

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        PROBLEM_REGISTRY[cls.__name__] = cls

    # --- options (reference `src/Options.h:125-165`) -----------------------
    def get_option(self, name: str, default):
        v = self.options.get(name, default)
        if isinstance(default, bool) and isinstance(v, str):
            return v.lower() in ("1", "true", "yes", "on")
        if default is not None and not isinstance(v, type(default)):
            try:
                return type(default)(v)
            except (TypeError, ValueError):
                return v
        return v

    # --- framework setup ---------------------------------------------------
    def setup_framework(self, **kwargs):
        """SETUP_FRAMEWORK analogue (reference `src/ProblemCore.h:117`)."""
        self.fw = setup_framework(**kwargs)
        return self.fw

    def _update_sp(self, **kw):
        self.fw = dataclasses.replace(
            self.fw, simparams=dataclasses.replace(self.fw.simparams, **kw))

    def _update_pp(self, **kw):
        self.fw = dataclasses.replace(
            self.fw, physparams=dataclasses.replace(self.fw.physparams, **kw))

    def set_deltap(self, dp: float):
        self.deltap = dp
        self._update_sp(deltap=dp)

    def set_tend(self, tend: float):
        self._update_sp(tend=tend)

    def set_gravity(self, gz_or_vec):
        g = ((0.0, 0.0, float(gz_or_vec))
             if not isinstance(gz_or_vec, (tuple, list)) else tuple(gz_or_vec))
        self._update_pp(gravity=g)

    def get_gravity_magnitude(self) -> float:
        return float(np.linalg.norm(self.fw.pp.gravity))

    def set_max_fall(self, h: float):
        self.max_fall = h

    def set_water_level(self, level: float):
        self.water_level = level

    def add_fluid(self, rho0: float):
        """Append a fluid (reference `ProblemCore::add_fluid`).  The first
        call replaces the placeholder default fluid."""
        self._fluids_added = getattr(self, "_fluids_added", 0) + 1
        if self._fluids_added == 1:
            new = (Fluid(rho0=rho0),)
        else:
            new = self.fw.pp.fluids + (Fluid(rho0=rho0),)
        self._update_pp(fluids=new)
        return len(new) - 1

    def set_equation_of_state(self, fluid_idx: int, gamma: float, c0: float):
        """c0 <= 0 means: derive from max fall height as 10*sqrt(2 g H)
        (reference `ProblemCore::set_equation_of_state`)."""
        if c0 <= 0:
            if self.max_fall is None:
                raise ValueError("set_max_fall before auto sound speed")
            c0 = 10.0 * math.sqrt(2 * self.get_gravity_magnitude() * self.max_fall)
        f = dataclasses.replace(self.fw.pp.fluids[fluid_idx], gamma=gamma, c0=c0)
        fluids = list(self.fw.pp.fluids)
        fluids[fluid_idx] = f
        self._update_pp(fluids=tuple(fluids))

    def set_dynamic_boundaries_layers(self, n: int):
        self.dyn_layers = n

    def add_writer(self, writer_type=None, freq: float = 0.0):
        """Record a particle-dump writer (reference ``add_writer``).  The
        writers are a later slice of the port: the frequency is kept and
        nothing is written."""
        self.vtk_write_every = freq

    def use_planes(self):
        raise NotImplementedError("plane boundaries are not ported yet")

    # --- geometry ----------------------------------------------------------
    def make_universe_box(self, origin, size):
        self.origin = tuple(float(x) for x in origin)
        self.size = tuple(float(x) for x in size)

    def _add(self, g: Geometry):
        self.geometries.append(g)
        return len(self.geometries) - 1

    def add_box(self, gtype: GeometryType, fill: FillType, origin, sx, sy, sz, **kw):
        dp = self.deltap
        if fill == FillType.SOLID:
            pts = geo.fill_box(origin, (sx, sy, sz), dp)
        elif fill == FillType.BORDER:
            layers = self.dyn_layers if self.fw.dyn_boundary else 1
            pts = geo.fill_box_border(origin, (sx, sy, sz), dp, layers=layers,
                                      open_top=kw.pop("open_top", False))
        else:
            pts = np.zeros((0, 3))
        return self._add(Geometry(gtype, pts, **kw))

    def add_testpoint(self, p):
        self.testpoints.append(tuple(p))

    def rotate(self, geom_id: int, rx: float, ry: float, rz: float, center=None):
        """Rotate a geometry about ``center`` (default: its min corner) by
        sequential X, Y, Z axis rotations (ProblemAPI_1::rotate)."""
        g = self.geometries[geom_id]
        if center is None:
            center = g.points.min(axis=0)
        for axis, ang in ((0, rx), (1, ry), (2, rz)):
            if ang:
                g.points = geo.rotate_axis(g.points, center, axis, ang)

    def enable_feedback(self, geom_id: int):
        self.geometries[geom_id].feedback = True

    def erase_fluid_inside(self, predicate):
        for g in self.geometries:
            if g.gtype == GeometryType.FLUID:
                g.points = geo.erase_inside(g.points, predicate)

    # --- initial conditions -----------------------------------------------
    def _hydrostatic_filling(self) -> bool:
        """Hydrostatic density filling applies with a single fluid and purely
        vertical gravity (reference `ProblemAPI_1.cc:331-344`)."""
        g = self.fw.pp.gravity
        return (self.fw.pp.num_fluids == 1 and g[0] == 0.0 and g[1] == 0.0
                and g[2] != 0.0)

    def initial_density(self, pts: np.ndarray, fluid_idx: int) -> np.ndarray:
        """Relative density at particle positions: hydrostatic below the water
        level (reference `ProblemAPI_1.cc:308-311,1770-1791`), in f32."""
        if self.water_level is None or not self._hydrostatic_filling():
            return np.zeros(len(pts))
        depth = np.maximum(0.0, self.water_level - pts[:, 2])
        rt = eos.hydrostatic_density(
            self.fw.pp, torch.as_tensor(depth, dtype=torch.float32), fluid_idx)
        return rt.numpy().astype(np.float64)

    # --- bodies ------------------------------------------------------------
    def body_specs(self):
        """BodySpec list for MOVING/FLOATING geometries (object indices are
        assigned by ``build()``)."""
        from ..bodies import BodySpec

        specs = []
        for g in self.geometries:
            if g.gtype not in (GeometryType.MOVING_BODY, GeometryType.FLOATING_BODY):
                continue
            n = max(1, len(g.points))
            total_mass = self.fw.pp.fluids[0].rho0 * self.deltap**3 * n
            # crude inertia from the particle cloud (diagonal)
            pts = (g.points - g.points.mean(axis=0)
                   if len(g.points) else np.zeros((1, 3)))
            pm = total_mass / n
            inertia = tuple(
                max(float(pm * ((pts**2).sum() - (pts[:, a] ** 2).sum())), 1e-9)
                for a in range(3))
            specs.append(BodySpec(
                object_idx=g.object_idx,
                mass=total_mass,
                inertia=inertia,
                floating=g.gtype == GeometryType.FLOATING_BODY,
            ))
        return tuple(specs)

    # --- build -------------------------------------------------------------
    def _probe_cells(self):
        """Size the cell capacity and the candidate-run extent from the
        initial occupancy, plus headroom for transient compression (the
        runtime CHECK_NEIBSNUM-style abort still guards the margin)."""
        probe = make_grid(self.origin, self.size, self.fw.influenceradius,
                          periodic=self.fw.periodicbound)
        occ = 1.0
        for cs_ in probe.cell_size:
            occ *= cs_ / self.deltap
        occ0 = 0
        pts = [g.points for g in self.geometries if len(g.points)]
        if pts:
            allp = np.concatenate(pts)
            ijk = np.clip(
                np.floor((allp - np.asarray(probe.origin))
                         / np.asarray(probe.cell_size)).astype(np.int64),
                0, np.asarray(probe.ncells) - 1)
            a0, a1, a2 = probe.order
            n0, n1 = probe.ncells[a0], probe.ncells[a1]
            lin = (ijk[:, a2] * n1 + ijk[:, a1]) * n0 + ijk[:, a0]
            counts = np.bincount(lin, minlength=probe.n_cells)
            occ0 = int(counts.max())
            # max particles over SPAN+2 consecutive fast-axis cells (the
            # forces kernel's candidate-run extent)
            cgrid = counts.reshape(probe.ncells[a2], probe.ncells[a1],
                                   probe.ncells[a0])
            csum = np.zeros((cgrid.shape[0], cgrid.shape[1], cgrid.shape[2] + 1),
                            np.int64)
            np.cumsum(cgrid, axis=2, out=csum[:, :, 1:])
            wlen = min(SPAN + 2, cgrid.shape[2])
            runw = csum[:, :, wlen:] - csum[:, :, :-wlen]
            runmax = int(runw.max()) if runw.size else int(cgrid.sum())
            self._update_sp(max_run_extent=int(-(-int(runmax * 1.15 + 16) // 8) * 8))
        k_auto = max(int(occ * 1.7 + 8), int(occ0 * 1.15 + 8))
        k_auto = -(-k_auto // 8) * 8
        if k_auto > self.fw.sp.max_parts_per_cell:
            self._update_sp(max_parts_per_cell=k_auto)
        self.fw = self.fw.finalize()

    def build(self, capacity: Optional[int] = None) -> Tuple[CellGrid, ParticleState]:
        """Assemble grid + initial particle state on the CPU (fill_parts +
        copy_to_array)."""
        if any(g.gtype in (GeometryType.MOVING_BODY, GeometryType.FLOATING_BODY)
               for g in self.geometries):
            self.fw = dataclasses.replace(
                self.fw, flags=self.fw.flags | SimFlags.ENABLE_MOVING_BODIES)
        if self.testpoints and PostProcessType.TESTPOINTS not in self.fw.postprocess:
            # declaring test points implies the TESTPOINTS post-process pass
            # (reference addPostProcess(TESTPOINTS), e.g. DamBreak3D.cu:63)
            self.fw = dataclasses.replace(
                self.fw, postprocess=self.fw.postprocess + (PostProcessType.TESTPOINTS,))
        # generic override of the cell capacity, e.g. --max_ppc 64
        max_ppc = self.get_option("max_ppc", 0)
        if max_ppc:
            self._update_sp(max_parts_per_cell=int(max_ppc))
        self.fw = self.fw.finalize()
        if not max_ppc and self.fw.sp.max_parts_per_cell == SimParams().max_parts_per_cell:
            self._probe_cells()
        dp = self.deltap
        if dp <= 0:
            raise ValueError("set_deltap first")

        # auto LJ dcoeff from max fall height (reference ProblemCore defaults)
        if self.fw.repulsive_boundary and self.fw.pp.dcoeff == 0.0:
            H = self.max_fall or self.size[2]
            self._update_pp(dcoeff=5.0 * self.get_gravity_magnitude() * H)
            self.fw = self.fw.finalize()

        grid = make_grid(self.origin, self.size, self.fw.influenceradius,
                         periodic=self.fw.periodicbound)

        # auto water level: highest fluid particle (ProblemAPI_1.cc:308-311)
        if self.water_level is None and self._hydrostatic_filling():
            zs = [g.points[:, 2].max() for g in self.geometries
                  if g.gtype == GeometryType.FLUID and len(g.points)]
            if zs:
                self.water_level = float(max(zs)) + self.deltap / 2

        pos_list, vel_list, rho_list, mass_list, info_list = [], [], [], [], []
        obj_idx = 0
        for g in self.geometries:
            n = len(g.points)
            if n == 0:
                continue
            if g.gtype == GeometryType.FLUID:
                ptype, flags, fluid_or_obj = ParticleType.FLUID, 0, g.fluid_idx
            elif g.gtype in (GeometryType.FIXED_BOUNDARY, GeometryType.OPENBOUNDARY):
                ptype, flags, fluid_or_obj = ParticleType.BOUNDARY, 0, g.fluid_idx
            elif g.gtype in (GeometryType.MOVING_BODY, GeometryType.FLOATING_BODY):
                ptype = ParticleType.BOUNDARY
                obj_idx += 1
                g.object_idx = obj_idx
                # floating bodies always need the fluid-force feedback
                feedback = g.feedback or g.gtype == GeometryType.FLOATING_BODY
                flags = FG_MOVING_BOUNDARY | (FG_COMPUTE_FORCE if feedback else 0)
                fluid_or_obj = obj_idx
            else:
                continue

            mass = self.fw.pp.fluids[g.fluid_idx].rho0 * dp**3
            if ptype == ParticleType.FLUID or self.fw.dyn_boundary:
                # DYN boundaries are hydrostatically filled too
                # (reference ProblemAPI_1.cc:1772)
                rho_t = self.initial_density(g.points, g.fluid_idx)
            else:
                rho_t = np.zeros(n)
            pos_list.append(g.points)
            vel_list.append(np.zeros((n, 3)))
            rho_list.append(rho_t)
            mass_list.append(np.full(n, mass))
            info_list.append(np.full(n, make_info(ptype, flags, fluid_or_obj), np.int32))

        for p in self.testpoints:
            pos_list.append(np.asarray([p]))
            vel_list.append(np.zeros((1, 3)))
            rho_list.append(np.zeros(1))
            mass_list.append(np.zeros(1))
            info_list.append(np.full(1, make_info(ParticleType.TESTPOINT), np.int32))
        n_total = sum(len(p) for p in pos_list)

        if capacity is None:
            capacity = n_total
        pos = np.concatenate(pos_list).astype(np.float32)
        # size the block plan (block count + kept-groups capacity + flat
        # tiles) from the initial layout; runtime overflow still aborts
        # like CHECK_NEIBSNUM (Simulator._check)
        if self.fw.sp.max_blocks == 0 and kernel_supported(self.fw, grid) and len(pos):
            probed = probe_plan_numpy(self.fw, grid, pos)
            if self.fw.sp.max_block_groups:
                probed["max_block_groups"] = self.fw.sp.max_block_groups
            probed["max_run_extent"] = max(probed["max_run_extent"],
                                           self.fw.sp.max_run_extent)
            self._update_sp(**probed)
            self.fw = self.fw.finalize()

        state = empty_state(capacity)  # a fresh state, filled in place
        f32 = torch.float32
        state.pos[:n_total] = torch.as_tensor(pos)
        state.vel[:n_total] = torch.as_tensor(np.concatenate(vel_list), dtype=f32)
        state.rho[:n_total] = torch.as_tensor(np.concatenate(rho_list), dtype=f32)
        state.mass[:n_total] = torch.as_tensor(np.concatenate(mass_list), dtype=f32)
        state.info[:n_total] = torch.as_tensor(np.concatenate(info_list))
        return grid, state


def get_problem(name: str) -> type:
    from . import catalog  # noqa: F401  (registers the catalog)

    try:
        return PROBLEM_REGISTRY[name]
    except KeyError:
        raise SystemExit(
            f"unknown problem '{name}'; available: "
            + ", ".join(sorted(PROBLEM_REGISTRY))) from None


__all__ = [
    "Problem",
    "Geometry",
    "GeometryType",
    "FillType",
    "PROBLEM_REGISTRY",
    "get_problem",
]
