"""Problem API: declarative scene construction, on the host in numpy.

Counterpart of the JAX package's ``problems/base.py`` (the reference's
``ProblemCore``, `src/ProblemCore.h:522-682`, and ``ProblemAPI<1>``,
`src/problem_api/ProblemAPI_1.h:49-307`), holding what DamBreak3D uses: a
Problem subclass configures the framework in ``__init__``, declares geometry
with ``add_box`` and ``build()`` produces the (grid, initial ParticleState)
pair — the reference's ``fill_parts`` + ``copy_to_array``
(`src/GPUSPH.cc:252,397`).  The state is built on the CPU; the Simulator
moves it to its device.

``add_writer`` and ``add_gage`` declare the output that the CLI's writer
dispatcher (`io/writers.py`) produces, ``add_postprocess`` a post-process
pass; ``add_plane`` declares a geometric plane boundary (`ops/planes.py`);
``set_body_motion`` gives a moving body its prescribed kinematics
(``bodies.body_velocity``), ``set_gravity_callback`` a time-dependent
gravity; ``mass_by_density`` gives each particle of a geometry the mass of
its initial density (the two-fluid problems), and a Grenier build carries
the reference volume and log-volume extras.  ``sediment`` marks a
geometry's particles as the granular sediment phase (FG_SEDIMENT), and a
granular build carries the ``effpres`` extra the Jacobi solver refreshes.
``add_stl_mesh`` and ``add_xyz_file`` read STL meshes (`geometry/stl.py`)
and XYZ point files.  ``add_sa_box`` and ``add_sa_plate`` declare SA wall
meshes (`geometry/sa_mesh.py`): their vertex and segment rows follow the
geometries and test points, the grid and the cell probe take the SA search
radius, and the build carries the ``belem`` and ``vr0..vr2`` extras of
``ops/sa.py`` (and, with density summation, the ``gamma`` and
``gradgamma`` extras of ``ops/density_sum.py``).  Not ported yet: HDF5
geometry and open boundaries.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..defs import (ParticleType, PostProcessType, RheologyType, SimFlags, SPHFormulation,
                    WriterType)
from ..framework import SimFramework, setup_framework
from ..geometry import primitives as geo
from ..geometry.sa_mesh import box_sa_mesh, plate_sa_mesh
from ..ops import eos
from ..ops.block_plan import SPAN, probe_plan_numpy
from ..ops.forces_kernel import kernel_supported
from ..ops.neighbors import CellGrid, make_grid
from ..params import Fluid, SimParams
from ..state import (
    FG_COMPUTE_FORCE,
    FG_MOVING_BOUNDARY,
    FG_SEDIMENT,
    ParticleState,
    empty_state,
    fluid_num,
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
    # per-particle mass and rest-density overrides (default: the fluid's
    # rho0 * dp^3) and the initial velocity of every particle
    mass: Optional[float] = None
    density: Optional[float] = None
    velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    feedback: bool = False  # enableFeedback: accumulate forces on this body
    # setParticleMassByDensity analogue: m = dp^3 * physical_density(rho_init)
    # per particle (reference ProblemAPI_1.cc setParticleMassByDensity +
    # RTInstability.cu:207)
    mass_by_density: bool = False
    # granular sediment phase: sets FG_SEDIMENT on the particles
    # (reference DamBreakMobileBed.cu:178)
    sediment: bool = False
    # rigid-body overrides (reference Object::SetMass/SetInertia): total
    # body mass and body-frame diagonal inertia; default = estimated from
    # the particle cloud
    body_mass: Optional[float] = None
    inertia: Optional[Tuple[float, float, float]] = None
    # the triangles [n,3,3] of an STL geometry, for erase predicates
    mesh_tris: Optional[np.ndarray] = None


@dataclasses.dataclass
class Plane:
    """Geometric plane boundary (reference `src/planes.h`)."""

    point: Tuple[float, float, float]
    normal: Tuple[float, float, float]


PROBLEM_REGISTRY: Dict[str, type] = {}


class Problem:
    """Base class for user problems (reference `ProblemCore`/`XProblem`)."""

    name = "Problem"

    def __init__(self, options: Optional[dict] = None):
        self.options = dict(options or {})
        self.geometries: List[Geometry] = []
        self.planes: List[Plane] = []
        self.testpoints: List[Tuple[float, float, float]] = []
        self.gages: List[Tuple[float, ...]] = []  # (x, y, w) wave gage positions
        self.origin = (0.0, 0.0, 0.0)
        self.size = (1.0, 1.0, 1.0)
        self.deltap = 0.0
        self.fw: SimFramework = SimFramework()
        self.water_level: Optional[float] = None  # hydrostatic init level
        self.max_fall: Optional[float] = None
        self.dyn_layers = 3
        self.vtk_write_every = 0.0
        self.writer_freqs: Dict[str, float] = {}  # extra writers (legacy/text)
        self.body_motion: Dict[int, Callable] = {}  # geometry id -> motion(t)
        self.sa_meshes: List[dict] = []  # SA boundary meshes (sa_mesh dicts)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if not cls.__name__.startswith("_"):  # a shared base is not a problem
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

    def set_smoothing(self, sfactor: float):
        self._update_sp(sfactor=sfactor)

    def set_timestep(self, dt: float):
        self._update_sp(dt=dt)

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
        self._update_fluid(fluid_idx, gamma=gamma, c0=c0)

    def set_kinematic_visc(self, fluid_idx: int, nu: float):
        self._update_fluid(fluid_idx, kinematic_visc=nu)

    def set_dynamic_visc(self, fluid_idx: int, mu: float):
        self.set_kinematic_visc(fluid_idx, mu / self.fw.pp.fluids[fluid_idx].rho0)

    def set_artificial_visc(self, alpha: float):
        self._update_pp(artvisccoeff=alpha)

    def set_gravity_callback(self, fn):
        """Variable gravity ``t -> (gx, gy, gz)``, three 0-d f32 tensors on
        the device of the 0-d f32 time ``t`` (reference
        ``ProblemCore::g_callback``, used by Seiche), evaluated for every
        forces pass and body step.  The forces kernel takes gravity as a
        constant: such a problem runs on the general pair path."""
        self.fw = dataclasses.replace(self.fw, gcallback=fn)

    def _update_fluid(self, fluid_idx: int, **kw):
        fluids = list(self.fw.pp.fluids)
        fluids[fluid_idx] = dataclasses.replace(fluids[fluid_idx], **kw)
        self._update_pp(fluids=tuple(fluids))

    def set_dynamic_boundaries_layers(self, n: int):
        self.dyn_layers = n

    def get_dynamic_boundaries_layers(self) -> int:
        return self.dyn_layers

    def add_writer(self, writer_type=None, freq: float = 0.0):
        """Register a particle-dump writer (reference ``add_writer``,
        `src/ProblemCore.cc`).  Default/unknown types map to the VTK writer;
        ``WriterType.VTKLEGACYWRITER``/``TEXTWRITER`` select those formats."""
        if writer_type == WriterType.VTKLEGACYWRITER:
            self.writer_freqs["vtklegacy"] = freq
        elif writer_type == WriterType.TEXTWRITER:
            self.writer_freqs["text"] = freq
        else:
            self.vtk_write_every = freq

    def add_gage(self, x: float, y: float, w: float = 0.0):
        """Wave gage at (x, y) (reference ``add_gage``, `ProblemCore.h:477`).
        ``w`` is the gage smoothing length: surface-particle elevations are
        Wendland-2D averaged within 2w of the gage (GPUSPH.cc:1650-1667);
        w=0 takes the nearest surface particle's z."""
        self.gages.append((x, y, w))

    def add_postprocess(self, pp: PostProcessType):
        """Enable a write-time post-process pass (reference ``addPostProcess``;
        the passes are ``ops/postprocess.py``)."""
        if pp not in self.fw.postprocess:
            self.fw = dataclasses.replace(self.fw, postprocess=self.fw.postprocess + (pp,))

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

    def add_sphere(self, gtype, fill, center, radius, **kw):
        solid = fill == FillType.SOLID
        layers = self.dyn_layers if (self.fw.dyn_boundary and not solid) else 1
        pts = geo.fill_sphere(center, radius, self.deltap, solid=solid, layers=layers)
        return self._add(Geometry(gtype, pts, **kw))

    def add_cylinder(self, gtype, fill, center_base, radius, height, **kw):
        solid = fill == FillType.SOLID
        layers = self.dyn_layers if (self.fw.dyn_boundary and not solid) else 1
        pts = geo.fill_cylinder(center_base, radius, height, self.deltap,
                                solid=solid, layers=layers)
        return self._add(Geometry(gtype, pts, **kw))

    def add_points(self, gtype, pts: np.ndarray, **kw):
        """Raw particle positions (the XYZFile/HDF5File reader analogue)."""
        return self._add(Geometry(gtype, np.asarray(pts, np.float64), **kw))

    def add_stl_mesh(self, gtype, path: str, **kw):
        """Fill the surface of an STL mesh at dp (reference ``addSTLMesh``,
        `src/problem_api/ProblemAPI_1.h:288`); the geometry keeps the
        triangles for erase predicates (``geometry/stl.py``)."""
        from ..geometry.stl import fill_stl_surface, load_stl

        tris = load_stl(path)
        return self._add(Geometry(gtype, fill_stl_surface(tris, self.deltap),
                                  mesh_tris=tris, **kw))

    def add_xyz_file(self, gtype, path: str, **kw):
        """Particle positions from the first three columns of a
        whitespace-separated text file (reference ``XYZReader``)."""
        return self.add_points(gtype, np.loadtxt(path, usecols=(0, 1, 2), ndmin=2), **kw)

    def add_plane(self, point, normal):
        self.planes.append(Plane(tuple(point), tuple(normal)))

    def add_sa_box(self, origin, size, *, faces="all", outward=False):
        """SA boundary box: vertex particles + triangular boundary elements
        (the procedural equivalent of the reference's Crixus HDF5 input,
        `ProblemAPI_1.cc:1998-2014`).  Requires BoundaryType.SA_BOUNDARY.
        ``faces`` is "all", "open_top" or "channel"; ``outward=True`` makes
        an obstacle box (normals toward the fluid outside)."""
        self.sa_meshes.append(box_sa_mesh(origin, size, self.deltap, faces=faces,
                                          outward=outward))
        return len(self.sa_meshes) - 1

    def add_sa_plate(self, origin, u_vec, v_vec, normal, *, io=None,
                     periodic_u=False, periodic_v=False):
        """Single SA wall plate spanned by ``u_vec`` x ``v_vec`` with inward
        unit ``normal``; periodic edges share the seam vertices.  An open
        boundary plate (``io``) waits for its slice."""
        if io is not None:
            raise NotImplementedError("not ported yet: open boundaries (ROADMAP item 9b)")
        self.sa_meshes.append(plate_sa_mesh(origin, u_vec, v_vec, normal, self.deltap,
                                            periodic_u=periodic_u, periodic_v=periodic_v))
        return len(self.sa_meshes) - 1

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
    def set_body_motion(self, geom_id: int, motion: Callable):
        """Prescribed kinematics of a moving body (reference
        ``moving_bodies_callback``): ``motion(t) -> (linvel f32[3], angvel
        f32[3])`` on the device of the 0-d f32 tensor ``t``, built with
        ``bodies.body_velocity``."""
        self.body_motion[geom_id] = motion

    def body_specs(self):
        """BodySpec list for MOVING/FLOATING geometries (object indices are
        assigned by ``build()``)."""
        from ..bodies import BodySpec

        specs = []
        for gid, g in enumerate(self.geometries):
            if g.gtype not in (GeometryType.MOVING_BODY, GeometryType.FLOATING_BODY):
                continue
            n = max(1, len(g.points))
            mass = (g.mass if g.mass is not None else
                    (g.density or self.fw.pp.fluids[0].rho0) * self.deltap**3)
            total_mass = g.body_mass if g.body_mass is not None else mass * n
            if g.inertia is not None:
                # analytic body-frame inertia (reference Object::SetInertia)
                inertia = tuple(max(float(i), 1e-9) for i in g.inertia)
            else:
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
                motion=self.body_motion.get(gid),
            ))
        return tuple(specs)

    # --- build -------------------------------------------------------------
    def _probe_cells(self):
        """Size the cell capacity and the candidate-run extent from the
        initial occupancy, plus headroom for transient compression (the
        runtime CHECK_NEIBSNUM-style abort still guards the margin)."""
        # probe with the (SA-expanded) radius of the real grid
        probe = make_grid(self.origin, self.size, self._search_radius(),
                          periodic=self.fw.periodicbound)
        occ = 1.0
        for cs_ in probe.cell_size:
            occ *= cs_ / self.deltap
        occ0 = 0
        pts = [g.points for g in self.geometries if len(g.points)]
        # SA meshes contribute vertex + segment particles to the cells
        for mesh in self.sa_meshes:
            pts += [mesh["verts"], mesh["seg_pos"]]
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
        # SA walls pack segments + vertices between the fluid layers and the
        # fluid settles toward them: a wider transient margin
        m0 = 1.4 if self.sa_meshes else 1.15
        k_auto = max(int(occ * 1.7 + 8), int(occ0 * m0 + 8))
        k_auto = -(-k_auto // 8) * 8
        if k_auto > self.fw.sp.max_parts_per_cell:
            self._update_sp(max_parts_per_cell=k_auto)
        self.fw = self.fw.finalize()

    def _search_radius(self) -> float:
        """The neighbor-search radius: SA boundary elements interact through
        their whole triangle, not just the barycenter, so SA expands it by
        dp/2 (the reference's boundNlSqInflRad, GPUWorker.cc:1890)."""
        return self.fw.influenceradius + (0.5 * self.deltap if self.sa_meshes else 0.0)

    def build(self, capacity: Optional[int] = None) -> Tuple[CellGrid, ParticleState]:
        """Assemble grid + initial particle state on the CPU (fill_parts +
        copy_to_array)."""
        if any(g.gtype in (GeometryType.MOVING_BODY, GeometryType.FLOATING_BODY)
               for g in self.geometries):
            self.fw = dataclasses.replace(
                self.fw, flags=self.fw.flags | SimFlags.ENABLE_MOVING_BODIES)
        if self.planes:
            self.fw = dataclasses.replace(
                self.fw, flags=self.fw.flags | SimFlags.ENABLE_PLANES,
                planes=tuple((p.point, p.normal) for p in self.planes))
        if self.testpoints and PostProcessType.TESTPOINTS not in self.fw.postprocess:
            # declaring test points implies the TESTPOINTS post-process pass
            # (reference addPostProcess(TESTPOINTS), e.g. DamBreak3D.cu:63)
            self.fw = dataclasses.replace(
                self.fw, postprocess=self.fw.postprocess + (PostProcessType.TESTPOINTS,))
        if self.gages and PostProcessType.SURFACE_DETECTION not in self.fw.postprocess:
            # wave gages average SURFACE-flagged particle elevations
            # (GPUSPH.cc:1650-1667), so gages imply surface detection
            self.fw = dataclasses.replace(
                self.fw,
                postprocess=self.fw.postprocess + (PostProcessType.SURFACE_DETECTION,))
        # generic override of the cell capacity, e.g. --max_ppc 64
        max_ppc = self.get_option("max_ppc", 0)
        if max_ppc:
            self._update_sp(max_parts_per_cell=int(max_ppc))
        # generic override of the repacking depth, e.g. --repack_maxiter 20
        repack_maxiter = self.get_option("repack_maxiter", 0)
        if repack_maxiter:
            self._update_sp(repack_maxiter=int(repack_maxiter))
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

        grid = make_grid(self.origin, self.size, self._search_radius(),
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

            rho0 = (g.density if g.density is not None
                    else self.fw.pp.fluids[g.fluid_idx].rho0)
            mass = g.mass if g.mass is not None else rho0 * dp**3
            if ptype == ParticleType.FLUID or self.fw.dyn_boundary:
                # DYN boundaries are hydrostatically filled too
                # (reference ProblemAPI_1.cc:1772)
                rho_t = self.initial_density(g.points, g.fluid_idx)
            else:
                rho_t = np.zeros(n)
            if g.sediment:
                flags |= FG_SEDIMENT
            pos_list.append(g.points)
            vel_list.append(np.broadcast_to(np.asarray(g.velocity, np.float64), (n, 3)))
            rho_list.append(rho_t)
            if g.mass_by_density:
                # m = dp^3 * physical_density(rho_init) per particle
                mass_list.append(dp**3 * (np.asarray(rho_t) + 1.0) * rho0)
            else:
                mass_list.append(np.full(n, mass))
            info_list.append(np.full(n, make_info(ptype, flags, fluid_or_obj), np.int32))

        for p in self.testpoints:
            pos_list.append(np.asarray([p]))
            vel_list.append(np.zeros((1, 3)))
            rho_list.append(np.zeros(1))
            mass_list.append(np.zeros(1))
            info_list.append(np.full(1, make_info(ParticleType.TESTPOINT), np.int32))
        n_total = sum(len(p) for p in pos_list)

        # SA boundary meshes: vertex particles, then segment (boundary
        # element) particles, with their normals and vertex offsets
        sa_rows = []  # (start, normals, vertex offsets or None)
        rho0_0 = self.fw.pp.fluids[0].rho0
        for mesh in self.sa_meshes:
            for pts, normals, vr, mass, ptype in (
                    # Crixus-style vertex mass: rho0 x the fluid-side Voronoi volume
                    (mesh["verts"], mesh["vert_normal"], None, rho0_0 * mesh["vert_volume"],
                     ParticleType.VERTEX),
                    (mesh["seg_pos"], mesh["seg_normal"], mesh["seg_verts"],
                     np.zeros(len(mesh["seg_pos"])), ParticleType.BOUNDARY)):
                n = len(pts)
                pos_list.append(pts)
                vel_list.append(np.zeros((n, 3)))
                rho_list.append(np.zeros(n))
                mass_list.append(mass)
                info_list.append(np.full(n, make_info(ptype), np.int32))
                sa_rows.append((n_total, normals, vr))
                n_total += n

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

        extras = {}
        if self.fw.flags & SimFlags.ENABLE_INTERNAL_ENERGY:
            extras["energy"] = torch.zeros((capacity,), dtype=torch.float32)
        if self.fw.visc.rheologytype == RheologyType.GRANULAR:
            # the effective pressure of the Jacobi solver (BUFFER_EFFPRES)
            extras["effpres"] = torch.zeros((capacity,), dtype=torch.float32)
        if self.sa_meshes:
            # inward normals of segments and vertices, and each segment's
            # vertex offsets from its barycenter
            belem = np.zeros((capacity, 3), np.float32)
            vrs = [np.zeros((capacity, 3), np.float32) for _ in range(3)]
            for start, normals, vr in sa_rows:
                belem[start:start + len(normals)] = normals
                if vr is not None:
                    for i in range(3):
                        vrs[i][start:start + len(normals)] = vr[:, i]
            extras["belem"] = torch.as_tensor(belem)
            for i in range(3):
                extras[f"vr{i}"] = torch.as_tensor(vrs[i])
            if self.fw.dynamic_gamma:
                # the carried gamma and grad gamma of density summation
                # (BUFFER_GRADGAMMA), seeded by Simulator.run (saInitGamma)
                extras["gamma"] = torch.ones((capacity,), dtype=torch.float32)
                extras["gradgamma"] = torch.zeros((capacity, 3), dtype=torch.float32)
        state = empty_state(capacity, extras)  # a fresh state, filled in place
        f32 = torch.float32
        state.pos[:n_total] = torch.as_tensor(pos)
        state.vel[:n_total] = torch.as_tensor(np.concatenate(vel_list), dtype=f32)
        state.rho[:n_total] = torch.as_tensor(np.concatenate(rho_list), dtype=f32)
        state.mass[:n_total] = torch.as_tensor(np.concatenate(mass_list), dtype=f32)
        state.info[:n_total] = torch.as_tensor(np.concatenate(info_list))
        if self.fw.sph_formulation == SPHFormulation.SPH_GRENIER:
            # Grenier volume buffer (BUFFER_VOLUME, euler_kernel.def
            # write_volume): reference volume V0 = m/rho0(fluid), log-volume
            # J = 0 at t=0; actual volume = exp(J)*V0
            rho0 = eos._per_fluid(self.fw.pp, fluid_num(state.info),
                                  [f.rho0 for f in self.fw.pp.fluids])
            state.extras["grenier_vol0"] = state.mass / rho0
            state.extras["grenier_J"] = torch.zeros((capacity,), dtype=torch.float32)
        # problem-specific particle initialization hook (the reference's
        # ProblemCore::initializeParticles, ProblemCore.h:597-609)
        return grid, self.initialize_particles(grid, state)

    def initialize_particles(self, grid: CellGrid, state: ParticleState) -> ParticleState:
        """Override to set initial per-particle fields (velocity profiles,
        densities, ...) after the fill (reference initializeParticles)."""
        return state


def get_problem(name: str) -> type:
    from . import catalog, generic  # noqa: F401  (registers the catalog and Generic)

    if name in PROBLEM_REGISTRY:
        return PROBLEM_REGISTRY[name]
    if name in catalog.NOT_PORTED:
        raise NotImplementedError(
            f"not ported yet: {name} needs {catalog.NOT_PORTED[name]}")
    raise SystemExit(
        f"unknown problem '{name}'; available: " + ", ".join(sorted(PROBLEM_REGISTRY)))


__all__ = [
    "Problem",
    "Geometry",
    "GeometryType",
    "FillType",
    "Plane",
    "PROBLEM_REGISTRY",
    "get_problem",
]
