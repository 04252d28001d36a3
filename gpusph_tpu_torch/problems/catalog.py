"""Problem catalog of the port: the problems that run on the forces kernel.

Counterpart of the JAX package's ``problems/catalog.py``: DamBreak3D (with
its ``use_planes`` option), Poiseuille, StillWater, LockExchange,
OpenChannel, BuoyancyTest, Spheric2, AccuracyTest, Objects,
DynBoundsExample and ProblemExample, each with the JAX package's options
and geometry.  ``NOT_PORTED`` names every other problem of the JAX catalog
with the modules it waits for; ``get_problem`` raises with that text.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..defs import (
    AverageOperator,
    BoundaryType,
    ComputationalViscosityType,
    DensityDiffusionType,
    FilterType,
    KernelType,
    Periodicity,
    RheologyType,
    SimFlags,
    SPHFormulation,
    TurbulenceModel,
    ViscousModel,
)
from ..geometry import primitives as geo
from ..ops import eos
from ..params import SimParams
from ..state import is_fluid
from .base import FillType, GeometryType, Problem


class DamBreak3D(Problem):
    """3D dam break with obstacle (reference `src/problems/DamBreak3D.cu:38-200`).

    DYN boundaries (3 layers), artificial viscosity, Molteni & Colagrossi
    density diffusion; domain 1.6 x 0.67 x 0.6 m, water column 0.4 x H=0.4 m,
    rotated square obstacle with force feedback.
    """

    name = "DamBreak3D"

    def __init__(self, options=None):
        super().__init__(options)
        wet = self.get_option("wet", False)
        num_obstacles = self.get_option("num_obstacles", 1)
        rotate_obstacle = self.get_option("rotate_obstacle", True)
        rhodiff = DensityDiffusionType(
            self.get_option("density-diffusion", int(DensityDiffusionType.COLAGROSSI)))
        # MLS filtering is on only without density diffusion (a later slice)
        mls = self.get_option("mls", 0 if rhodiff != DensityDiffusionType.NONE else 10)

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            density_diffusion=rhodiff,
            filters=((FilterType.MLS, mls),) if mls > 0 else (),
            simparams=SimParams(densityDiffCoeff=0.1),
        )
        self.set_dynamic_boundaries_layers(3)
        self.set_deltap(self.get_option("deltap", 0.015))
        self.set_gravity(-9.81)
        H = 0.4
        self.set_max_fall(H)
        self.add_fluid(1000.0)
        self.set_equation_of_state(0, 7.0, 20.0)
        self.set_tend(self.get_option("tend", 1.5))
        self.add_writer(freq=0.005)

        use_planes = self.get_option("use_planes", False)
        dim = (1.6, 0.67, 0.6)
        self.make_universe_box((0.0, 0.0, 0.0), dim)
        dp = self.deltap

        if use_planes:
            # limit the domain with 6 geometric planes (makeUniverseBox path,
            # DamBreak3D.cu:127-129)
            for axis in range(3):
                n_lo = [0.0, 0.0, 0.0]
                n_lo[axis] = 1.0
                self.add_plane((0.0, 0.0, 0.0), tuple(n_lo))
                hi = [0.0, 0.0, 0.0]
                hi[axis] = dim[axis]
                n_hi = [0.0, 0.0, 0.0]
                n_hi[axis] = -1.0
                self.add_plane(tuple(hi), tuple(n_hi))
            bd = dp
        else:
            # container walls: 3 dyn-boundary layers growing inward
            self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER, (0, 0, 0), *dim,
                         open_top=True)
            bd = dp * self.dyn_layers
        # water column, offset from the walls
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (bd, bd, bd), 0.4 - bd, dim[1] - 2 * bd, H - bd)
        if wet:
            self.add_box(GeometryType.FLUID, FillType.SOLID,
                         (0.4 + dp, bd, bd), dim[0] - 0.4 - bd - dp,
                         dim[1] - 2 * bd, 0.1 - bd)
        self.set_water_level(H)

        obstacle_side = 0.12
        y_dist = dim[1] / (num_obstacles + 1)
        for i in range(num_obstacles):
            base = (
                0.9 - obstacle_side / 2,
                y_dist * (i + 1)
                + (obstacle_side / 2 if rotate_obstacle else 0)
                - obstacle_side / 2,
                0,
            )
            gid = self.add_box(GeometryType.MOVING_BODY, FillType.BORDER,
                               base, obstacle_side, obstacle_side, dim[2])
            if rotate_obstacle:
                self.rotate(gid, 0, 0, math.pi / 4)
            self.enable_feedback(gid)
            # erase fluid overlapping the obstacle
            self.erase_fluid_inside(geo.box_predicate(
                base, (obstacle_side, obstacle_side, dim[2]), margin=dp / 2))

        for i in range(self.get_option("num_testpoints", 3)):
            self.add_testpoint((0.9, dim[1] / 2, 0.05 + 0.1 * i))




class Poiseuille(Problem):
    """Laminar Poiseuille channel flow (reference `src/problems/Poiseuille.inc:63-170`).

    Periodic in x,y; DYN boundary plates top/bottom; body force along x.
    Analytical steady profile v_x(z) = F/(2 nu) ((lz/2)^2 - z^2); the
    ``steady-init`` option starts the fluid on it.
    """

    name = "Poiseuille"

    def __init__(self, options=None):
        super().__init__(options)
        lz = ly = lx = 1.0
        self.lz = lz
        rho = self.get_option("density", 1.0)
        kinvisc = self.get_option("kinvisc", 0.1)
        driving_force = self.get_option("driving-force", 0.05)
        ppH = self.get_option("ppH", 32)
        compvisc = ComputationalViscosityType(
            self.get_option("compvisc", int(ComputationalViscosityType.KINEMATIC)))
        viscavg = AverageOperator(
            self.get_option("viscavg", int(AverageOperator.HARMONIC)))
        viscmodel = ViscousModel(
            self.get_option("viscmodel", int(ViscousModel.MORRIS)))

        self.kinvisc = kinvisc
        self.driving_force = driving_force

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            computational_visc=compvisc,
            visc_model=viscmodel,
            visc_average=viscavg,
            periodicity=Periodicity.XY,
            boundary=BoundaryType.DYN_BOUNDARY,
            simparams=SimParams(max_parts_per_cell=56),
        )
        self.set_deltap(lz / ppH)
        dp = self.deltap
        self.set_tend(self.get_option("tend", 100.0))
        self.set_gravity((driving_force, 0.0, 0.0))
        fl = self.add_fluid(rho)
        self.set_kinematic_visc(fl, kinvisc)

        max_vel = self.compute_poiseuille_vel(0.0)
        hydrostatic_vel = math.sqrt(2 * driving_force * lz)
        c0 = 20 * max(hydrostatic_vel, max_vel)
        self.set_equation_of_state(fl, 7.0, c0)

        layers = self.dyn_layers
        # world: channel + boundary plates; periodic wrap needs the world x/y
        # extent to be an exact multiple of the particle lattice
        wall = layers * dp
        self.make_universe_box(
            (-lx / 2, -ly / 2, -lz / 2 - wall), (lx, ly, lz + 2 * wall))
        # plates: 'layers' thick slabs whose inner surface is at z = +-lz/2
        for z0 in (-lz / 2 - (layers - 1) * dp, lz / 2):
            self.add_points(
                GeometryType.FIXED_BOUNDARY,
                geo.fill_box((-lx / 2 + dp / 2, -ly / 2 + dp / 2, z0),
                             (lx - dp, ly - dp, (layers - 1) * dp), dp))
        # fluid fills the channel
        self.add_points(
            GeometryType.FLUID,
            geo.fill_box((-lx / 2 + dp / 2, -ly / 2 + dp / 2, -lz / 2 + dp),
                         (lx - dp, ly - dp, lz - 2 * dp), dp))
        self._steady_init = self.get_option("steady-init", False)
        self.add_writer(freq=1.0)

    def compute_poiseuille_vel(self, z: float) -> float:
        """Analytical steady profile (reference Poiseuille.inc:185-210)."""
        h2 = self.lz / 2
        return self.driving_force / (2 * self.kinvisc) * (h2 * h2 - z * z)

    def initialize_particles(self, grid, state):
        if not self._steady_init:
            return state
        # the profile in f32 from the f32 positions, as the JAX build does
        z = state.pos[:, 2].numpy()
        vx = torch.as_tensor(self.driving_force / (2 * self.kinvisc)
                             * ((self.lz / 2) ** 2 - z**2))
        vel = state.vel.clone()
        vel[:, 0] = torch.where(is_fluid(state.info), vx, 0.0)
        return state.replace(vel=vel)


class StillWater(Problem):
    """Hydrostatic water column (reference `src/problems/StillWater.cu` /
    `LithostaticDYN.cu` + `Lithostatic.inc`): box of still water; the
    steady-state density profile must match the analytic hydrostatic solution
    (validated by `scripts/validate_lithostatic_torch.py`)."""

    name = "StillWater"

    def __init__(self, options=None):
        super().__init__(options)
        H = self.get_option("water_height", 0.5)
        side = self.get_option("side", 0.5)
        ppH = self.get_option("ppH", 32)
        rhodiff = DensityDiffusionType(
            self.get_option("density-diffusion", int(DensityDiffusionType.COLAGROSSI)))

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            visc_average=AverageOperator.HARMONIC,
            density_diffusion=rhodiff,
            simparams=SimParams(densityDiffCoeff=0.1),
        )
        self.set_deltap(H / ppH)
        dp = self.deltap
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        fl = self.add_fluid(1000.0)
        self.set_kinematic_visc(fl, 1.0e-6)
        self.set_equation_of_state(fl, 7.0, 10 * math.sqrt(9.81 * H))
        self.set_tend(self.get_option("tend", 5.0))

        layers = self.dyn_layers
        wall = layers * dp
        box = (side + 2 * wall, side + 2 * wall, H + wall + 4 * dp)
        self.make_universe_box((-wall, -wall, -wall), box)
        # tank: walls + floor (open top)
        self.add_points(GeometryType.FIXED_BOUNDARY,
                        _tank_points((0, 0, 0), (side, side, box[2]), dp, layers))
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (dp, dp, dp), side - 2 * dp, side - 2 * dp, H - dp)
        self.set_water_level(H)
        self.add_writer(freq=0.1)


class LockExchange(Problem):
    """Two-fluid gravity current (reference `src/problems/LockExchange.cu`):
    heavy fluid behind a virtual gate at dimX/2, light fluid ahead.  The
    reference defaults to Grenier's sigma/volume formulation with F2 as the
    documented alternative; select with ``formulation=grenier|f2`` (default
    f2; Grenier and Hu & Adams are not ported yet).  DYN boundaries,
    artificial viscosity."""

    name = "LockExchange"

    def __init__(self, options=None):
        super().__init__(options)
        dimX, dimY, dimZ = 0.6, 0.23, 0.2
        rho_light = self.get_option("rho0", 1000.0)
        rho_heavy = self.get_option("rho1", 1100.0)
        ppH = self.get_option("ppH", 32)
        form = str(self.get_option("formulation", "f2")).lower()
        formulation = {
            "grenier": SPHFormulation.SPH_GRENIER,
            "ha": SPHFormulation.SPH_HA,
        }.get(form, SPHFormulation.SPH_F2)

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            formulation=formulation,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_MULTIFLUID,
            simparams=SimParams(max_parts_per_cell=56),
        )
        self.set_deltap(dimZ / ppH)
        dp = self.deltap
        self.set_gravity(-9.81)
        self.set_max_fall(dimZ)
        light = self.add_fluid(rho_light)
        heavy = self.add_fluid(rho_heavy)
        self.set_equation_of_state(light, 7.0, 20.0)
        self.set_equation_of_state(heavy, 7.0, 20.0)
        self.set_tend(self.get_option("tend", 2.0))
        self.add_writer(freq=0.02)

        self.make_universe_box((0, 0, 0), (dimX, dimY, dimZ))
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                     (0, 0, 0), dimX, dimY, dimZ)
        bd = dp * self.dyn_layers
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (bd, bd, bd), dimX / 2 - bd, dimY - 2 * bd, dimZ - 2 * bd,
                     fluid_idx=light)
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (dimX / 2 + dp, bd, bd),
                     dimX / 2 - bd - dp, dimY - 2 * bd, dimZ - 2 * bd,
                     fluid_idx=heavy)

    def initial_density(self, pts, fluid_idx):
        # multifluid: hydrostatic filling is done per fluid by hand in the
        # reference; rest density is the safe default here
        return np.zeros(len(pts))


class OpenChannel(Problem):
    """Uniform open-channel flow driven by a tilted-gravity body force
    (reference `src/problems/OpenChannel.cu`): periodic along the flow,
    DYN walls, free surface."""

    name = "OpenChannel"

    def __init__(self, options=None):
        super().__init__(options)
        length, w, h = 1.0, 0.5, 0.25  # channel length/width/water depth
        ppH = self.get_option("ppH", 16)
        angle = self.get_option("angle_deg", 4.5) * math.pi / 180.0

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            periodicity=Periodicity.X,
        )
        self.set_deltap(h / ppH)
        dp = self.deltap
        g = 9.81
        # tilt gravity: downslope component drives the flow
        self.set_gravity((g * math.sin(angle), 0.0, -g * math.cos(angle)))
        self.set_max_fall(h)
        fl = self.add_fluid(1000.0)
        self.set_kinematic_visc(fl, 1.0e-4)
        self.set_equation_of_state(fl, 7.0, 10 * math.sqrt(g * h))
        self.set_tend(self.get_option("tend", 10.0))
        self.add_writer(freq=0.1)

        layers = self.dyn_layers
        wall = layers * dp
        lz = h + 0.15
        self.make_universe_box((0, -wall, -wall), (length, w + 2 * wall, lz + wall))
        # floor + side walls (x-periodic: no end walls)
        self.add_points(
            GeometryType.FIXED_BOUNDARY,
            geo.fill_box((dp / 2, 0, -(layers - 1) * dp),
                         (length - dp, w, (layers - 1) * dp), dp))
        for y in (0.0, w):
            self.add_points(
                GeometryType.FIXED_BOUNDARY,
                geo.fill_box((dp / 2, y, dp), (length - dp, 0.0, lz - dp), dp))
        self.add_points(
            GeometryType.FLUID,
            geo.fill_box((dp / 2, dp, dp), (length - dp, w - 2 * dp, h - dp), dp))
        self.set_water_level(h)


class BuoyancyTest(Problem):
    """Floating-body buoyancy test (reference `src/problems/BuoyancyTest.cu`):
    a half-density cube released inside a water tank must rise and bob."""

    name = "BuoyancyTest"

    def __init__(self, options=None):
        super().__init__(options)
        side = 1.0
        H = self.get_option("water_height", 0.7)
        cube = self.get_option("object_side", 0.12)
        ppH = self.get_option("ppH", 24)

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            density_diffusion=DensityDiffusionType.COLAGROSSI,
            simparams=SimParams(densityDiffCoeff=0.1),
        )
        self.set_deltap(H / ppH)
        dp = self.deltap
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 10 * math.sqrt(2 * 9.81 * H))
        self.set_tend(self.get_option("tend", 3.0))
        self.add_writer(freq=0.02)

        layers = self.dyn_layers
        wall = layers * dp
        box = (side + 2 * wall, side + 2 * wall, H + 0.4)
        self.make_universe_box((-wall, -wall, -wall), box)
        self.add_points(GeometryType.FIXED_BOUNDARY,
                        _tank_points((0, 0, 0), (side, side, box[2] - wall), dp, layers))
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (dp, dp, dp), side - 2 * dp, side - 2 * dp, H - dp)
        # floating cube just below the surface, half water density
        c0 = (side / 2 - cube / 2, side / 2 - cube / 2, H - cube)
        body = self.add_box(GeometryType.FLOATING_BODY, FillType.BORDER,
                            c0, cube, cube, cube)
        rho_body = 1000.0 / 2
        self.geometries[body].density = rho_body
        n_parts = max(1, len(self.geometries[body].points))
        self.geometries[body].mass = rho_body * cube**3 / n_parts
        self.erase_fluid_inside(geo.box_predicate(c0, (cube, cube, cube), margin=dp / 2))
        self.set_water_level(H)


class Spheric2(Problem):
    """SPHERIC benchmark test case 2 (Kleefsman dam break with obstacle,
    reference `src/problems/Spheric2LJ.cu:50-150`): 3.22 x 1 x 1 tank,
    H=0.55 water column, 0.161 x 0.403 x 0.161 obstacle, 8 pressure probes
    on the obstacle faces."""

    name = "Spheric2"

    def __init__(self, options=None):
        super().__init__(options)
        lx, ly, lz = 3.22, 1.0, 1.0
        H = 0.55

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            density_diffusion=DensityDiffusionType.COLAGROSSI,
            simparams=SimParams(densityDiffCoeff=0.1),
        )
        self.set_deltap(self.get_option("deltap", 0.02))
        dp = self.deltap
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        fl = self.add_fluid(1000.0)
        self.set_kinematic_visc(fl, 1.0e-6)
        self.set_equation_of_state(fl, 7.0, 0.0)  # auto from max fall
        self.set_tend(self.get_option("tend", 5.0))
        self.add_writer(freq=0.02)

        self.make_universe_box((0.0, 0.0, 0.0), (lx, ly, lz))
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                     (0, 0, 0), lx, ly, lz, open_top=True)
        bd = dp * self.dyn_layers
        # obstacle (hollow box) on the tank floor
        ob = (2.3955, 0.295, bd)
        os_ = (0.161, 0.403, 0.161 - bd)
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER, ob, *os_)
        # water column at the far end (the dam)
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (lx - 1.228, bd, bd), 1.228 - bd, ly - 2 * bd, H - bd)
        self.erase_fluid_inside(geo.box_predicate(ob, os_, margin=dp / 2))
        self.set_water_level(H)

        # Kleefsman pressure probes (reference :140-147)
        for z in (0.021, 0.061, 0.101, 0.141):
            self.add_testpoint((2.3955, 0.529, z))
        for x in (2.4165, 2.4565, 2.4965, 2.5365):
            self.add_testpoint((x, 0.471, 0.161))


def _tank_points(origin, inner_size, dp, layers):
    """Open-top tank: floor + 4 walls, ``layers`` thick, inner surface at the
    given box; layers grow outward (away from the fluid)."""
    o = np.asarray(origin, np.float64)
    s = np.asarray(inner_size, np.float64)
    pts = []
    for layer in range(layers):
        off = layer * dp
        lo = o - off
        sz = s + 2 * off
        # floor
        pts.append(geo.fill_box((lo[0], lo[1], o[2] - off), (sz[0], sz[1], 0.0), dp))
        # walls (x faces)
        for x in (lo[0], lo[0] + sz[0]):
            pts.append(geo.fill_box((x, lo[1], o[2] - off + dp),
                                    (0.0, sz[1], s[2] + off - dp), dp))
        for y in (lo[1], lo[1] + sz[1]):
            pts.append(geo.fill_box((lo[0] + dp, y, o[2] - off + dp),
                                    (sz[0] - 2 * dp, 0.0, s[2] + off - dp), dp))
    return geo._dedup(np.concatenate(pts), dp)


class AccuracyTest(Problem):
    """Dam break in a long box, DYN boundaries + internal energy tracking
    (reference `src/problems/AccuracyTest.cu`): 4.0 x 0.7 x 1.0 domain,
    water column 0.4 x H=0.6 against the left wall."""

    name = "AccuracyTest"

    def __init__(self, options=None):
        super().__init__(options)
        lx, ly, lz = 4.0, 0.7, 1.0
        H = 0.6
        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_INTERNAL_ENERGY,
            simparams=SimParams(dtadaptfactor=0.3),
        )
        self.set_deltap(self.get_option("deltap", 0.02))
        dp = self.deltap
        self.set_timestep(1e-5)
        self.set_tend(self.get_option("tend", 1.5))
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 50.0)
        self.set_kinematic_visc(fl, 1.0e-6)
        self.set_artificial_visc(0.3 * 0.005 / dp)
        self.add_writer(freq=0.1)

        self.make_universe_box((0, 0, 0), (lx, ly, lz))
        # floor + 4 side walls (3-layer slabs, AccuracyTest.cu:76-100)
        slabs = (((0, 0, 0), lx, ly, 3 * dp),
                 ((0, 0, 4 * dp), 3 * dp, ly, lz - 4 * dp),
                 ((lx - 3 * dp, 0, 4 * dp), 3 * dp, ly, lz - 4 * dp),
                 ((4 * dp, 0, 4 * dp), lx - 8 * dp, 3 * dp, lz - 4 * dp),
                 ((4 * dp, ly - 3 * dp, 4 * dp), lx - 8 * dp, 3 * dp, lz - 4 * dp))
        for origin, sx, sy, sz in slabs:
            self.add_box(GeometryType.FIXED_BOUNDARY, FillType.SOLID, origin, sx, sy, sz)
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (4 * dp, 4 * dp, 4 * dp), 0.4, ly - 8 * dp, H)
        self.set_water_level(4 * dp + H)


class Objects(Problem):
    """Dam break with fixed obstacles and two floating bodies — a rotated
    cube and a sphere at quarter water density (reference
    `src/problems/Objects.cu:44-188`).  The reference's optional Chrono
    distance joint between the two bodies (`initializeObjectJoints`,
    `Objects.cu:199-211`) is not supported (free 6-DOF bodies only).

    Both bodies start half in the water column.  The fluid inside them and
    within dp of their surface (the LJ range r0) is erased, as the
    reference's default erase operation for a non-fluid geometry does
    (ET_ERASE_FLUID); the JAX package keeps it, and the overlapping pairs'
    LJ repulsion (max |a| about 1e13 m/s^2 at dp 0.02) makes that run
    non-finite within 10 iterations."""

    name = "Objects"

    def __init__(self, options=None):
        super().__init__(options)
        dim = (1.6, 0.8, 0.8)
        water_length, water_height = 0.5, 0.5
        obstacle_side = 0.1
        objects_side = 0.08
        obstacle_xpos = 1.0
        n_obstacles = self.get_option("num_obstacles", 1)
        rotate_obstacle = self.get_option("rotate_obstacle", 1)

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.LJ_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            visc_model=ViscousModel.MORRIS,
            density_diffusion=DensityDiffusionType(
                self.get_option("density-diffusion", int(DensityDiffusionType.FERRARI))),
            simparams=SimParams(densityDiffCoeff=0.1),
        )
        self.set_deltap(self.get_option("deltap", 0.02))
        dp = self.deltap
        self.set_gravity(-9.81)
        self.set_max_fall(water_height)
        self.add_fluid(1000.0)
        self.set_equation_of_state(0, 7.0, 20.0)
        self.set_dynamic_visc(0, 1.0e-4)
        self.set_tend(self.get_option("tend", 2.0))
        self.add_writer(freq=0.01)

        self.make_universe_box((0.0, 0.0, 0.0), dim)
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                     (0, 0, 0), *dim, open_top=True)
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (dp, dp, dp), water_length - dp, dim[1] - 2 * dp, water_height - dp)
        self.set_water_level(water_height)

        # fixed obstacles (PP_BOTTOM_CENTER placement, optional 45-degree
        # z-rotation about the corner like the reference)
        y_dist = dim[1] / (n_obstacles + 1)
        for i in range(n_obstacles):
            cy = y_dist * (i + 1) + (obstacle_side / 2 if rotate_obstacle else 0)
            obst = self.add_box(
                GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                (obstacle_xpos - obstacle_side / 2, cy - obstacle_side / 2, dp),
                obstacle_side, obstacle_side, dim[2] / 2)
            if rotate_obstacle:
                self.rotate(obst, 0, 0, math.pi / 4)
            self.erase_fluid_inside(geo.box_predicate(
                (obstacle_xpos - obstacle_side, cy - obstacle_side, 0.0),
                (2 * obstacle_side, 2 * obstacle_side, dim[2] / 2),
                margin=dp / 2))

        rho0 = 1000.0
        rho_body = rho0 / 4  # quarter density so the bodies float

        # floating cube (PP_CENTER), rotated about Y then Z by 45 degrees
        cc = (water_length, dim[1] / 5 * 1.5, water_height)
        c0 = tuple(c - objects_side / 2 for c in cc)
        cube = self.add_box(GeometryType.FLOATING_BODY, FillType.BORDER,
                            c0, objects_side, objects_side, objects_side)
        g = self.geometries[cube]
        g.mass = rho0 * dp**3  # setParticleMassByDensity(rho0)
        g.body_mass = rho_body * objects_side**3
        ic = g.body_mass * objects_side**2 / 6.0
        g.inertia = (ic, ic, ic)
        self.rotate(cube, 0, math.pi / 4, math.pi / 4, center=np.asarray(cc))
        in_cube = geo.box_predicate(c0, (objects_side,) * 3, margin=dp)
        self.erase_fluid_inside(lambda p: in_cube(geo.rotate_axis(
            geo.rotate_axis(p, cc, 2, -math.pi / 4), cc, 1, -math.pi / 4)))

        # floating sphere
        sc = (water_length, dim[1] / 5 * 2.5, water_height)
        sph = self.add_sphere(GeometryType.FLOATING_BODY, FillType.BORDER,
                              sc, objects_side / 2)
        g = self.geometries[sph]
        g.mass = rho0 * dp**3
        g.body_mass = rho_body * 4.0 / 3.0 * math.pi * (objects_side / 2) ** 3
        isph = 0.4 * g.body_mass * (objects_side / 2) ** 2
        g.inertia = (isph, isph, isph)
        self.erase_fluid_inside(geo.sphere_predicate(sc, objects_side / 2 + dp))


class DynBoundsExample(Problem):
    """Inclined 2D Poiseuille sheet flow between dynamic-boundary plates,
    double-periodic in x/y, driven by tilted gravity (reference
    `src/problems/DynBoundsExample.cu:28-122`; hydrostatic density init
    `:105-122`)."""

    name = "DynBoundsExample"

    def __init__(self, options=None):
        super().__init__(options)
        W = 1.0
        H = 2 * W
        degs = 60.0
        alpha = math.pi * degs / 180.0
        g = 9.81

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            visc_model=ViscousModel.MORRIS,
            periodicity=Periodicity.XY,
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_REPACKING,
        )
        self.set_deltap(self.get_option("deltap", W / 64))
        dp = self.deltap
        w = 4 * dp
        self.alpha, self.H, self.w = alpha, H, w
        self.set_gravity((g * math.sin(alpha), 0.0, -g * math.cos(alpha)))
        maxvel = math.sqrt(g * H)
        self.set_max_fall(H)
        self.add_fluid(1.0)
        self.set_equation_of_state(0, 7.0, 10 * maxvel)
        self.set_kinematic_visc(0, 120.0)
        self.set_tend(self.get_option("tend", 2.0))
        self.repack_maxiter = 1000
        self.add_writer(freq=0.01)

        o = (-W / 2, -W / 2, -(H + 2 * w) / 2)
        self.make_universe_box(o, (W, W, H + 2 * w))
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (o[0] + dp / 2, o[1] + dp / 2, o[2] + w + dp),
                     W - dp, W - dp, H - 2 * dp)
        for z0 in (o[2], o[2] + H + w):
            self.add_box(GeometryType.FIXED_BOUNDARY, FillType.SOLID,
                         (o[0], o[1], z0), W - dp / 2, W - dp / 2, w)

    def initialize_particles(self, grid, state):
        # hydrostatic density against the tilted gravity (reference
        # initializeParticles, DynBoundsExample.cu:105-122); the port's
        # hydrostatic_density uses |g_z| = 9.81 cos(alpha) from PhysParams
        ht = (self.origin[2] + self.H + 2 * self.w - state.pos[:, 2]) * math.cos(self.alpha)
        rho = eos.hydrostatic_density(self.fw.pp, torch.clamp(ht, min=0.0), 0)
        return state.replace(rho=torch.where(state.active, rho, state.rho))


class ProblemExample(Problem):
    """API showcase problem (reference `src/problems/ProblemExample.cu`):
    an infinite floor plane with a rotated grid of fixed cubes and a grid
    of fluid spheres raining on them; LJ boundary + planes, artificial
    viscosity."""

    name = "ProblemExample"

    def __init__(self, options=None):
        super().__init__(options)
        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.LJ_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_PLANES,
        )
        self.set_deltap(self.get_option("deltap", 0.02))
        self.set_gravity(-9.81)
        self.set_max_fall(3.0)
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 20.0)
        self.set_tend(self.get_option("tend", 1.0))
        self.add_writer(freq=0.1)

        dimX, dimY, dimZ = 10.0, 10.0, 3.0
        self.make_universe_box((0.0, 0.0, 0.0), (dimX, dimY, dimZ))
        self.add_plane((0, 0, 0), (0, 0, 1))  # infinite floor

        cube_size, cube_z = 0.4, 1.0
        sphere_radius, sphere_z = 0.5, 2.0
        grid_size = dimX / 5
        corner = dimX / 2 - grid_size / 2
        ncubes, nspheres = 4, 3
        for i in range(ncubes):
            for j in range(ncubes):
                cx = corner + i * grid_size / (ncubes - 1)
                cy = corner + j * grid_size / (ncubes - 1)
                gid = self.add_box(
                    GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                    (cx - cube_size / 2, cy - cube_size / 2, cube_z - cube_size / 2),
                    cube_size, cube_size, cube_size)
                self.rotate(gid, i * (math.pi / 2) / ncubes,
                            j * (math.pi / 2) / ncubes, 0.0, center=(cx, cy, cube_z))
        for i in range(nspheres):
            for j in range(nspheres):
                self.add_sphere(
                    GeometryType.FLUID, FillType.SOLID,
                    (corner + i * grid_size / (nspheres - 1),
                     corner + j * grid_size / (nspheres - 1), sphere_z),
                    sphere_radius)


# the other problems of the JAX package's catalog, and what each waits for
_CALLBACKS = "prescribed body motion (the traced-callback slice)"
_HA_GRANULAR = ("Hu & Adams' formulation, granular rheology (the Jacobi effective "
                "pressure) and the effective viscosity")
NOT_PORTED = {
    **{name: _CALLBACKS
       for name in ("DamBreakGate", "WaveTank", "SolitaryWave", "SlidingWedge")},
    "DEMExample": "DEM terrain (ops/dem.py)",
    "OffshorePile": "density filters and " + _CALLBACKS,
    "OilJet": "Grenier's formulation and " + _CALLBACKS,
    "Seiche": "density filters, SPS and variable gravity (the traced-callback slice)",
    "Bubble": "Grenier's formulation",
    "RTInstability": "Grenier's formulation and multi-fluid density diffusion",
    "BiFluidPoiseuille": "Hu & Adams' formulation and multi-fluid density diffusion",
    "DamBreakMobileBed": _HA_GRANULAR + ", with multi-fluid density diffusion",
    "LithostaticLJ": _HA_GRANULAR,
    "LithostaticDYN": _HA_GRANULAR,
    "PoiseuillePapanastasiou": "the effective viscosity (ops/visc.py)",
    "StillWaterSA": "SA boundaries",
    "StillWaterRepackSA": "SA boundaries",
    "ChannelIO": "SA boundaries and open boundaries",
    "CompleteSaExample": "SA boundaries, open boundaries and Brezzi diffusion",
    "Spheric2SA": "SA boundaries and the k-epsilon model",
    "TurbulentPoiseuilleFlowSA": "SA boundaries and the k-epsilon model",
    "LithostaticSA": "SA boundaries and " + _HA_GRANULAR,
    "BiFluidPoiseuilleSA": ("SA boundaries, Hu & Adams' formulation and multi-fluid "
                            "density diffusion"),
    "Generic": "problems/generic.py (problems read from an .ini file)",
}


__all__ = ["NOT_PORTED", "DamBreak3D", "Poiseuille", "StillWater", "LockExchange", "OpenChannel",
           "BuoyancyTest", "Spheric2", "AccuracyTest", "Objects", "DynBoundsExample",
           "ProblemExample"]
