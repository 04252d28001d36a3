"""Problem catalog of the port.

Counterpart of the JAX package's ``problems/catalog.py``: DamBreak3D (with
its ``use_planes`` option, and MLS under ``density-diffusion 0``),
Poiseuille, PoiseuillePapanastasiou, StillWater, LockExchange, OpenChannel,
BuoyancyTest, Spheric2, AccuracyTest, Objects, DynBoundsExample,
ProblemExample, and the problems with prescribed body motion: DamBreakGate,
WaveTank, SolitaryWave, SlidingWedge and OffshorePile, which run on the
forces kernel; Seiche (SPS, a gravity callback), RTInstability and Bubble
(Grenier, two fluids) and BiFluidPoiseuille (Hu & Adams, two fluids), which
run on the general pair path; LithostaticLJ, LithostaticDYN and
DamBreakMobileBed (granular rheology with the Jacobi effective pressure)
and OilJet (Grenier, a piston) on the general path; the SA-wall problems
StillWaterSA (density summation and a dynamic gamma by default, gamma by
quadrature with ``--density_sum 0``), StillWaterRepackSA,
BiFluidPoiseuilleSA and LithostaticSA on the general path; and DEMExample
(a DEM terrain) on the forces kernel; each with the JAX package's options
and geometry.  A gravity callback returns tensors on its time's device.  A
motion callback returns ``bodies.body_velocity`` of the chunk's time
tensor.  ``problems/generic.py`` adds Generic (a scene read from an INI
file).  ``NOT_PORTED`` names every other problem of the JAX catalog (the
SA problems with k-epsilon or open boundaries) with the modules it waits
for; ``get_problem`` raises with that text.
"""
from __future__ import annotations

import dataclasses
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
from ..bodies import body_velocity
from ..defs import PostProcessType
from ..geometry import primitives as geo
from ..ops import eos
from ..ops.dem import dem_height_normal, load_dem_ascii, pack_dem, unpack_dem
from ..params import SimParams
from ..state import FG_SEDIMENT, has_flag, is_fluid
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
        # MLS filtering is on only without density diffusion
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


class StillWaterSA(Problem):
    """Hydrostatic box with semi-analytical boundaries (reference
    `src/problems/StillWater.cu` with `boundary<SA_BOUNDARY>`, geometry from
    the Crixus HDF5 input, generated procedurally here by ``add_sa_box``).

    The default integrates with density summation and a dynamic gamma
    (ENABLE_DENSITY_SUM, the reference's preferred SA integration,
    ``ops/density_sum.py``); ``--density_sum 0`` runs the continuity
    equation with gamma by quadrature before every forces pass
    (``ops/sa.py``).  Both run on the general pair path.
    """

    name = "StillWaterSA"

    def __init__(self, options=None):
        super().__init__(options)
        H = self.get_option("water_height", 0.5)
        l = self.get_option("side", 0.5)  # noqa: E741  (the JAX package's name)
        ppH = self.get_option("ppH", 24)

        flags = SimFlags.ENABLE_DTADAPT
        if self.get_option("density_sum", 1):
            flags |= SimFlags.ENABLE_DENSITY_SUM
        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.SA_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            density_diffusion=DensityDiffusionType(
                self.get_option("density-diffusion", int(DensityDiffusionType.COLAGROSSI))),
            flags=flags,
            simparams=SimParams(densityDiffCoeff=0.1),
        )
        self.set_deltap(H / ppH)
        dp = self.deltap
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 10 * math.sqrt(9.81 * H))
        self.set_tend(self.get_option("tend", 5.0))
        self.add_writer(freq=0.5)

        h_box = H + 6 * dp
        self.make_universe_box((-2 * dp, -2 * dp, -2 * dp),
                               (l + 4 * dp, l + 4 * dp, h_box + 4 * dp))
        self.add_sa_box((0.0, 0.0, 0.0), (l, l, h_box), faces="all")
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (dp, dp, dp), l - 2 * dp, l - 2 * dp, H - dp)
        self.set_water_level(H)


class StillWaterRepackSA(StillWaterSA):
    """StillWaterSA preceded by particle repacking (reference
    `src/problems/StillWaterRepackSA.cu`: ENABLE_REPACKING,
    repack_maxiter=10, repack_a=0.1, repack_alpha=0.1); the CLI's
    ``--repack`` runs it before the dynamic gamma is seeded."""

    name = "StillWaterRepackSA"

    def __init__(self, options=None):
        super().__init__(options)
        self.fw = dataclasses.replace(self.fw, flags=self.fw.flags | SimFlags.ENABLE_REPACKING)
        self._update_sp(repack_maxiter=10, repack_a=0.1, repack_alpha=0.1)


class LockExchange(Problem):
    """Two-fluid gravity current (reference `src/problems/LockExchange.cu`):
    heavy fluid behind a virtual gate at dimX/2, light fluid ahead.  The
    reference defaults to Grenier's sigma/volume formulation with F2 as the
    documented alternative; select with ``formulation=grenier|ha|f2``
    (default f2, on the forces kernel; grenier and ha run on the general
    pair path).  DYN boundaries, artificial viscosity."""

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


class PoiseuillePapanastasiou(Poiseuille):
    """Poiseuille channel with the Papanastasiou-regularized Bingham
    rheology (reference `src/problems/PoiseuillePapanastasiou.cu` +
    `Poiseuille.inc:73,135-139`: yield strength F rho lz / 4).  The forces
    kernel takes the effective viscosity (``ops/visc.py``) in its viscosity
    column."""

    name = "PoiseuillePapanastasiou"

    def __init__(self, options=None):
        options = dict(options or {})
        options.setdefault("viscmodel", int(ViscousModel.MORRIS))
        super().__init__(options)
        self.fw = dataclasses.replace(
            self.fw, visc=dataclasses.replace(
                self.fw.visc, rheologytype=RheologyType.PAPANASTASIOU))
        ys = self.driving_force * self.fw.pp.fluids[0].rho0 * self.lz / 4
        self._update_pp(fluids=(dataclasses.replace(self.fw.pp.fluids[0],
                                                    yield_strength=ys),))
        self.fw = self.fw.finalize()


class DamBreakGate(Problem):
    """Dam break released by a lifting gate (reference
    `src/problems/DamBreakGate.cu`): like DamBreak3D, but the water is held
    by a moving-body gate that slides upward at 1.5 m/s from t = 0.1 s."""

    name = "DamBreakGate"

    def __init__(self, options=None):
        super().__init__(options)
        dim = (1.6, 0.67, 0.6)
        H = 0.4
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
        self.add_fluid(1000.0)
        self.set_equation_of_state(0, 7.0, 20.0)
        self.set_tend(self.get_option("tend", 1.5))
        self.add_writer(freq=0.01)

        self.make_universe_box((0.0, 0.0, 0.0), dim)
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                     (0, 0, 0), *dim, open_top=True)
        bd = dp * self.dyn_layers
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (bd, bd, bd), 0.4 - bd, dim[1] - 2 * bd, H - bd)
        self.set_water_level(H)

        # gate: a thin wall at x = 0.4
        gate = self.add_box(GeometryType.MOVING_BODY, FillType.SOLID,
                            (0.4, bd, bd), dp / 2, dim[1] - 2 * bd, H + 0.1)

        def gate_motion(t):
            return body_velocity(t, (0.0, 0.0, torch.where(t >= 0.1, 1.5, 0.0)))

        self.set_body_motion(gate, gate_motion)


class WaveTank(Problem):
    """Wave tank with a rotating paddle wavemaker and a beach slope
    (reference `src/problems/WaveTank.cu:100-220`): a flap hinged at the
    bottom turns at A*Omega*sin(Omega (t - t0)) inside (tstart, tend); wave
    gages along the centerline."""

    name = "WaveTank"

    def __init__(self, options=None):
        super().__init__(options)
        H = self.get_option("water_height", 0.45)
        h_length = self.get_option("flat_length", 2.25)
        beta = math.atan(self.get_option("slope", 0.25))
        ly = self.get_option("width", 0.6)
        stroke = self.get_option("stroke", 0.2)
        period = self.get_option("period", 0.8)
        paddle_x = 0.25
        tstart = self.get_option("paddle_tstart", 0.2)
        tstop = self.get_option("paddle_tend", 30.0)

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
        self.set_equation_of_state(fl, 7.0, 10 * math.sqrt(2 * 9.81 * H))
        self.set_tend(self.get_option("tend", 10.0))
        self.add_writer(freq=0.05)

        # domain: flat section + beach rising to above the still water level
        slope_run = (H + 10 * dp) / math.tan(beta)
        lx = h_length + slope_run + 0.1
        lz = H + 0.3
        layers = self.dyn_layers
        wall = layers * dp
        self.make_universe_box((-wall, -wall, -wall),
                               (lx + 2 * wall, ly + 2 * wall, lz + wall))

        # tank floor (flat part) + side walls
        self.add_points(
            GeometryType.FIXED_BOUNDARY,
            geo.fill_box((0, 0, -(layers - 1) * dp), (h_length, ly, (layers - 1) * dp), dp))
        for y in (0.0, ly):
            self.add_points(GeometryType.FIXED_BOUNDARY,
                            geo.fill_box((0, y, dp), (lx, 0.0, lz - dp), dp))
        # beach: a sloped slab from (h_length, 0) rising at angle beta
        slab = geo.fill_box((0, 0, -(layers - 1) * dp),
                            (slope_run / math.cos(beta), ly, (layers - 1) * dp), dp)
        slab = geo.rotate_y(slab, (0, 0, 0), -beta)
        slab[:, 0] += h_length
        self.add_points(GeometryType.FIXED_BOUNDARY, slab)

        # paddle: a thin vertical flap hinged at the bottom
        paddle = self.add_box(GeometryType.MOVING_BODY, FillType.SOLID,
                              (paddle_x - dp / 2, dp, 0.0), dp / 2, ly - 2 * dp, H + 0.15)
        amplitude = math.atan(stroke / (2.0 * H))
        omega = 2.0 * math.pi / period

        def paddle_motion(t):
            on = (t > tstart) & (t < tstop)
            av_y = torch.where(on, amplitude * omega * torch.sin(omega * (t - tstart)), 0.0)
            return body_velocity(t, angvel=(0.0, av_y, 0.0))

        self.set_body_motion(paddle, paddle_motion)
        self._paddle_hinge = (paddle_x, ly / 2, 0.0)

        # water: from the paddle to where the beach reaches the surface
        x_water_end = h_length + H / math.tan(beta)
        self.add_points(
            GeometryType.FLUID,
            geo.fill_box((paddle_x + dp, dp, dp),
                         (x_water_end - paddle_x - dp, ly - 2 * dp, H - dp), dp))
        # carve the beach out of the water
        tanb = math.tan(beta)
        self.erase_fluid_inside(lambda p: p[:, 2] < (p[:, 0] - h_length) * tanb + 0.5 * dp)
        self.set_water_level(H)

        for xg in (1.0, 1.5, 2.0):
            self.add_gage(xg, ly / 2)

    def body_specs(self):
        # the paddle turns about its hinge at the tank floor, not its mass center
        return tuple(dataclasses.replace(s, rotation_center=self._paddle_hinge)
                     for s in super().body_specs())


class SolitaryWave(Problem):
    """Solitary wave generated by a piston over a sloping beach with rising
    cylinders (reference `src/problems/SolitaryWave.cu`): LJ boundary and
    planes (the sloped bottom among them), piston velocity c/cosh^2(a t + b)
    during the stroke window, 10 cylinders rising at 0.5 m/s for the first
    second."""

    name = "SolitaryWave"

    def __init__(self, options=None):
        super().__init__(options)
        lx, ly, lz = 9.0, 0.4, 3.0
        slope_length, h_length = 8.5, 0.5
        height = 0.63
        beta = 4.2364 * math.pi / 180.0
        H = 0.45

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.LJ_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            flags=SimFlags.ENABLE_DTADAPT,
            simparams=SimParams(dtadaptfactor=0.3),
        )
        self.set_deltap(self.get_option("deltap", 0.02))
        dp = self.deltap
        r0 = dp
        self.set_timestep(0.00013)
        self.set_tend(self.get_option("tend", 10.0))
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        g = 9.81
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 20.0)
        self.set_kinematic_visc(fl, 1.0e-6)
        self.add_writer(freq=0.1)
        self.add_postprocess(PostProcessType.VORTICITY)

        # piston kinematics (SolitaryWave.cu:70-83)
        amplitude = 0.2
        Hoh = amplitude / H
        kappa = math.sqrt(3 * Hoh) / (2.0 * H)
        cel = math.sqrt(g * (H + amplitude))
        S = math.sqrt(16.0 * amplitude * H / 3.0)
        tau = 2.0 * (3.8 + Hoh) / (kappa * cel)
        tstart, tend_p = 0.2, tau
        x0 = r0
        a = 2.0 * (3.8 + Hoh) / tau
        b = 2.0 * ((3.8 + Hoh) * (-tstart / tau - 0.5) - 2.0 * Hoh * (x0 / S - 0.5))
        c = (3.8 + Hoh) * S / tau

        self.make_universe_box((0.0, 0.0, -1.2 * height), (lx, ly, lz + 1.2 * height))
        # fluid: a layered fill following the beach (SolitaryWave.cu:92-100)
        pts = []
        n = 0
        z = 0.0
        while z < H:
            z = n * dp + 1.5 * r0
            x = x0 + r0
            length = h_length + z / math.tan(beta) - 1.5 * r0 / math.sin(beta) - x
            if length > 0:
                pts.append(geo.fill_box((x, r0, z), (length, ly - 2 * r0, 0.0), dp))
            n += 1
        self.add_points(GeometryType.FLUID, np.concatenate(pts))

        # piston: a single-layer moving plate
        piston = self.add_points(GeometryType.MOVING_BODY,
                                 geo.fill_box((x0, 0, 0), (0.0, ly, height), dp))

        def piston_motion(t):
            on = (t >= tstart) & (t <= tend_p)
            ch = torch.cosh(a * t + b)
            return body_velocity(t, (torch.where(on, c / (ch * ch), 0.0), 0.0, 0.0))

        self.set_body_motion(piston, piston_motion)

        # rising cylinders (SolitaryWave.cu:103-133)
        run = slope_length / math.cos(beta)
        cylp = [
            (h_length + run / 10, ly / 2), (h_length + run / 10, ly / 6),
            (h_length + run / 10, 5 * ly / 6),
            (h_length + run / 5, 0), (h_length + run / 5, ly / 3),
            (h_length + run / 5, 2 * ly / 3), (h_length + run / 5, ly),
            (h_length + 3 * run / 10, ly / 6), (h_length + 3 * run / 10, ly / 2),
            (h_length + 3 * run / 10, 5 * ly / 6),
        ]

        def cyl_motion(t):
            return body_velocity(t, (0.0, 0.0, torch.where((t >= 0.0) & (t <= 1.0), 0.5, 0.0)))

        for i, (cx, cy) in enumerate(cylp):
            radius = 0.05 if i == 0 else 0.025
            gid = self.add_cylinder(GeometryType.MOVING_BODY, FillType.BORDER,
                                    (cx, cy, -height), radius, height)
            self.set_body_motion(gid, cyl_motion)

        # planes (copy_planes, SolitaryWave.cu:178-190)
        l_end = h_length + slope_length
        self.add_plane((0, 0, 0), (0, 0, 1))
        self.add_plane((0, 0, 0), (0, 1, 0))
        self.add_plane((0, ly, 0), (0, -1, 0))
        self.add_plane((0, 0, 0), (1, 0, 0))
        self.add_plane((l_end, 0, 0), (-1, 0, 0))
        self.add_plane((h_length, 0, 0), (-math.sin(beta), 0.0, math.cos(beta)))
        self.set_water_level(H)


class OffshorePile(Problem):
    """Wave loading on a cylindrical pile over a sloped beach (reference
    `src/problems/OffshorePile.cu`): a periodic-y wave flume with a
    sinusoidal piston wavemaker (stroke 0.399 m, T = 2.4 s), a 1:40 slope
    after a 4.5 m flat bottom, a feedback cylinder (d = 0.2 m) at the 0.4 m
    depth mark with wave gages around it; Shepard filter every 20
    iterations.  The domain length is ``--lx`` (the JAX package's 24 m; the
    reference's is 60 m).  The grid's fast axis is x, not the periodic y,
    so it runs on the forces kernel."""

    name = "OffshorePile"

    def __init__(self, options=None):
        super().__init__(options)
        lx = self.get_option("lx", 24.0)
        ly = 1.5
        H = 1.0
        tan_beta = 0.025
        h_length = 4.5
        layers = 3

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            visc_model=ViscousModel.MORRIS,
            periodicity=Periodicity.Y,
            filters={FilterType.SHEPARD: 20},
            simparams=SimParams(dtadaptfactor=0.2),
        )
        self.add_postprocess(PostProcessType.SURFACE_DETECTION)
        self.set_deltap(self.get_option("deltap", 0.05))
        dp = self.deltap
        self.set_timestep(0.00013)
        self.set_tend(self.get_option("tend", 120.0))
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 40.0)
        self.set_kinematic_visc(fl, 1.0e-6)
        self.set_water_level(H)
        self.add_writer(freq=1.0)

        x0 = -1.0
        off_y = dp / 2
        wall = layers * dp
        self.make_universe_box((x0, 0.0, -1.5 * wall), (lx - x0, ly + dp, 3.0 + 1.5 * wall))

        # fluid: columns following the bathymetry (flat + 1:40 slope)
        cols = []
        x = dp / 2
        while x < lx - dp:
            bottom = 0.0 if x <= h_length else (x - h_length) * tan_beta
            if bottom + dp / 2 < H:
                cols.extend((x, z) for z in np.arange(bottom + dp / 2, H, dp))
            x += dp
        ys = np.arange(off_y, ly + off_y - dp / 4, dp)
        self.add_points(GeometryType.FLUID,
                        np.asarray([(cx, y, z) for (cx, z) in cols for y in ys]))

        # bottom boundary: flat + slope, 'layers' deep
        bpts = []
        x = x0 + dp / 2
        while x < lx:
            bottom = 0.0 if x <= h_length else (x - h_length) * tan_beta
            for k in range(1, layers + 1):
                bpts.extend((x, y, bottom - k * dp) for y in ys)
            x += dp
        self.add_points(GeometryType.FIXED_BOUNDARY, np.asarray(bpts))
        # far wall
        zfw0 = (lx - h_length) * tan_beta if lx > h_length else 0.0
        self.add_points(
            GeometryType.FIXED_BOUNDARY,
            geo.fill_box((lx - (layers - 1) * dp, off_y, zfw0 - layers * dp),
                         ((layers - 1) * dp, ly - dp, H + layers * dp), dp))

        # piston wavemaker: a (layers-1)*dp thick plate
        piston = self.add_points(
            GeometryType.MOVING_BODY,
            geo.fill_box((-(layers + 0.5) * dp, off_y, -dp),
                         ((layers - 1) * dp, ly - dp, 2 * H), dp))
        amp = 0.399 / 2.0
        omega = 2.0 * math.pi / 2.4
        tstart = 0.2

        def piston_motion(t):
            vx = torch.where(t >= tstart, -amp * omega * torch.sin(omega * (t - tstart)), 0.0)
            return body_velocity(t, (vx, 0.0, 0.0))

        self.set_body_motion(piston, piston_motion)

        # feedback cylinder at the 0.4 m depth mark
        cyl_x = h_length + 0.4 / tan_beta
        if cyl_x < lx - 1.0:
            self.add_cylinder(GeometryType.MOVING_BODY, FillType.BORDER,
                              (cyl_x, ly / 2, 0.0), (0.2 - dp) / 2, 2 * H, feedback=True)
        # wave gages (OffshorePile.cu:88-99)
        sl = self.fw.sp.slength
        for w in (0.0, sl, 0.5 * sl, 0.25 * sl, 2 * sl):
            self.add_gage(min(cyl_x, lx - 1.0), ly / 2 + off_y + 0.5, w)
        for xg in (1.0, h_length, h_length * 3 / 4, h_length / 2, h_length / 4):
            self.add_gage(xg, ly / 2 + off_y, dp)


class SlidingWedge(Problem):
    """Submarine landslide: a wedge slides down a 2:1 slope with the
    prescribed cubic displacement law of the Watts experiment (reference
    `src/problems/SlidingWedge.cu:39-258`, `moving_bodies_callback`
    `:125-147`).

    The JAX package's scene does not run: its water lies below the slope
    plane and on the planes of its walls (the first forces pass gives
    infinite accelerations, and dt is NaN within 10 iterations).  The port
    builds the scene its wedge and gages assume (recorded decision): the
    water lies above the slope z = -x tan(beta) that the wedge slides down,
    one r0 = dp from each plane, over a flat bottom plane at z = -H; the
    wedge lies along the slope, and the water within dp of it is erased.
    """

    name = "SlidingWedge"

    def __init__(self, options=None):
        super().__init__(options)
        lx, ly, lz = 10.0, 3.7, 3.1
        H = 2.44
        tan_beta = 0.5
        beta = math.atan(tan_beta)
        x0 = 0.5

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.LJ_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            visc_model=ViscousModel.MORRIS,
            computational_visc=ComputationalViscosityType.KINEMATIC,
            density_diffusion=DensityDiffusionType.FERRARI,
            simparams=SimParams(densityDiffCoeff=1.0, dtadaptfactor=0.2),
        )
        self.set_deltap(self.get_option("deltap", 0.1))
        dp = self.deltap
        self.set_timestep(0.00013)
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        self.add_fluid(1000.0)
        self.set_equation_of_state(0, 7.0, 30.0)
        self.set_kinematic_visc(0, 1.0e-6)
        t0 = 0.4
        self.t0 = t0
        self.set_tend(self.get_option("tend", 4.0 + t0))
        self.add_writer(freq=0.1)

        self.make_universe_box((-x0 - dp, -ly / 2 - dp, -H - 2 * dp),
                               (lx + 2 * dp, ly + 2 * dp, lz + 3 * dp))

        # the slope, the flat bottom, the side and end walls as LJ planes
        cosb, sinb = math.cos(beta), math.sin(beta)
        self.add_plane((0.0, 0.0, 0.0), (sinb, 0.0, cosb))
        self.add_plane((0.0, 0.0, -H), (0.0, 0.0, 1.0))
        self.add_plane((-x0, 0.0, 0.0), (1.0, 0.0, 0.0))
        self.add_plane((lx - x0, 0.0, 0.0), (-1.0, 0.0, 0.0))
        self.add_plane((0.0, -ly / 2, 0.0), (0.0, 1.0, 0.0))
        self.add_plane((0.0, ly / 2, 0.0), (0.0, -1.0, 0.0))

        # water: the tank one dp inside its walls and bottom, above the slope
        wat = self.add_box(GeometryType.FLUID, FillType.SOLID, (-x0 + dp, -ly / 2 + dp, -H + dp),
                           lx - 2 * dp, ly - 2 * dp, H - dp)
        pts = self.geometries[wat].points
        self.geometries[wat].points = pts[pts[:, 0] * sinb + pts[:, 2] * cosb >= dp]

        # the wedge: the 0.91 x 0.61 x 0.455 triangular prism approximated by
        # its bounding box surface, along the slope from the waterline
        # (Watts 2005 experiment constants)
        ws = (0.91, 0.61, 0.455)
        wedge_c = (0.3, -ws[1] / 2, 0.05 - ws[2])
        hinge = (wedge_c[0], 0.0, wedge_c[2] + ws[2])
        wedge = self.add_box(GeometryType.MOVING_BODY, FillType.BORDER, wedge_c, *ws)
        self.rotate(wedge, 0, beta, 0, center=np.asarray(hinge))
        in_wedge = geo.box_predicate(wedge_c, ws, margin=dp)
        self.erase_fluid_inside(lambda p: in_wedge(geo.rotate_axis(p, hinge, 1, -beta)))

        a, b, c = -0.097588, 0.759361, 0.078776
        t_slide = 2.6714

        def wedge_motion(t):
            # velocity of f(t) = a t^3 + b t^2 + c t along the slope
            # (moving_bodies_callback, SlidingWedge.cu:125-147, with the
            # published law's `+ c` as the JAX package has it)
            tt = torch.clamp(t - t0, 0.0, t_slide)
            v = 3 * a * tt * tt + 2 * b * tt + c
            v = v * ((t >= t0) & (t <= t0 + t_slide)).to(torch.float32)
            return body_velocity(t, (v * cosb, 0.0, -v * sinb))

        self.set_body_motion(wedge, wedge_motion)

        for _ in range(4):
            self.add_gage(1.83, 0.0)
            self.add_gage(1.2446, 0.635)


class Seiche(Problem):
    """Sloshing tank under oscillating lateral gravity (reference
    `src/problems/Seiche.cu`): water column H=0.5 in a sqrt(2)H x H/sqrt(2)
    x 1.5H tank, SPS turbulence, MLS filter every 20 iterations, and a
    variable-gravity callback g_x(t) = 2 sin(9.8 (t - t0)) active for
    t in (gtstart, gtend) (Seiche.cu:93-100).  Runs on the general pair
    path (SPS, the gravity callback)."""

    name = "Seiche"

    def __init__(self, options=None):
        super().__init__(options)
        H = self.H = 0.5
        l = math.sqrt(2.0) * H
        w = l / 2
        h = 1.5 * H
        gtstart = float(self.get_option("gtstart", 0.3))
        gtend = float(self.get_option("gtend", 3.0))
        mls = int(self.get_option("mls", 20))

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.LJ_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.SPS,
            flags=SimFlags.ENABLE_DTADAPT,
            filters=((FilterType.MLS, mls),) if mls > 0 else (),
            simparams=SimParams(dtadaptfactor=0.2),
        )
        self.set_deltap(self.get_option("deltap", 0.015))
        dp = self.deltap
        self.set_timestep(4e-5)
        self.set_gravity(-9.81)
        self.set_max_fall(H)
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 20.0)
        self.set_kinematic_visc(fl, 5.0e-6)
        self.set_tend(self.get_option("tend", 10.0))
        self.add_writer(freq=0.1)

        def g_callback(t):
            # Seiche.cu:93-100, on t's device with no host round trip
            on = (t > gtstart) & (t < gtend)
            gx = torch.where(on, 2.0 * torch.sin(9.8 * (t - gtstart)), 0.0)
            return (gx, torch.zeros_like(gx), torch.full_like(gx, -9.81))

        self.set_gravity_callback(g_callback)

        self.make_universe_box((0, 0, 0), (l, w, h))
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER, (0, 0, 0), l, w, h)
        wd = dp
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (wd, wd, wd), l - 2 * wd, w - 2 * wd, H - 2 * wd)
        self.set_water_level(H)


def _formulation(name: str) -> SPHFormulation:
    """The ``formulation`` option of the two-fluid problems: grenier, ha,
    anything else F2."""
    return {"grenier": SPHFormulation.SPH_GRENIER,
            "ha": SPHFormulation.SPH_HA}.get(name.lower(), SPHFormulation.SPH_F2)


class RTInstability(Problem):
    """Rayleigh-Taylor instability (reference `src/problems/RTInstability.cu`):
    0.4 x 0.4 x 0.8 box, light fluid (1000) below a sinusoidally perturbed
    interface z = dimZ/2 + 0.05 sin(2 pi x / dimX), heavy fluid (2350) above;
    Grenier's multi-fluid formulation with pseudo surface tension
    (epsinterface=0.08), DYN boundaries, laminar viscosity 1e-2,
    Molteni & Colagrossi diffusion (0.1).  Hydrostatic two-layer density
    init and per-particle masses by density (RTInstability.cu:163-209).
    Runs on the general pair path (``formulation`` grenier, ha or f2)."""

    name = "RTInstability"

    def __init__(self, options=None):
        super().__init__(options)
        self.dimX, self.dimY, self.dimZ = 0.4, 0.4, 0.8
        dimX, dimY, dimZ = self.dimX, self.dimY, self.dimZ
        formulation = _formulation(str(self.get_option("formulation", "grenier")))
        ddiff = {
            "none": DensityDiffusionType.NONE,
            "colagrossi": DensityDiffusionType.COLAGROSSI,
        }[str(self.get_option("density_diffusion", "colagrossi")).lower()]
        # MLS only when density diffusion is off (RTInstability.cu:60-66)
        mls = int(self.get_option(
            "mls", 0 if ddiff != DensityDiffusionType.NONE else 10))

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            formulation=formulation,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            density_diffusion=ddiff,
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_MULTIFLUID,
            filters=((FilterType.MLS, mls),) if mls > 0 else (),
            simparams=SimParams(densityDiffCoeff=0.1),
        )
        self.set_deltap(self.get_option("deltap", 0.01))
        dp = self.deltap
        self.set_gravity(-9.81)
        self.set_max_fall(dimZ)
        self.light = self.add_fluid(1000.0)
        self.heavy = self.add_fluid(2350.0)
        self.set_equation_of_state(self.light, 7.0, 20.0)
        self.set_equation_of_state(self.heavy, 7.0, 20.0)
        self.set_kinematic_visc(self.light, 1.0e-2)
        self.set_kinematic_visc(self.heavy, 1.0e-2)
        # pseudo surface tension between the phases (set_interface_epsilon)
        self._update_pp(epsinterface=0.08)
        self.set_tend(self.get_option("tend", 1.5))
        self.add_writer(freq=0.005)

        self.make_universe_box((0, 0, 0), (dimX, dimY, dimZ))
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                     (0, 0, 0), dimX, dimY, dimZ,
                     fluid_idx=self.heavy, mass_by_density=True)
        bd = dp * self.dyn_layers
        pts = geo.fill_box((bd, bd, bd), (dimX - 2 * bd, dimY - 2 * bd, dimZ - 2 * bd), dp)
        light_sel = pts[:, 2] < self._interface_z(pts[:, 0])
        self.add_points(GeometryType.FLUID, pts[light_sel],
                        fluid_idx=self.light, mass_by_density=True)
        self.add_points(GeometryType.FLUID, pts[~light_sel],
                        fluid_idx=self.heavy, mass_by_density=True)

    def _interface_z(self, x):
        return self.dimZ / 2 + 0.05 * np.sin(2 * np.pi / self.dimX * x)

    def initial_density(self, pts, fluid_idx):
        """Two-layer hydrostatic profile (RTInstability.cu:163-200): heavy
        fluid (and walls) from the top surface; light fluid from the heavy
        column above the local interface plus its own column below it."""
        g = self.get_gravity_magnitude()
        H = self.dimZ
        z = pts[:, 2]
        if fluid_idx == self.heavy:
            depth = np.maximum(0.0, H - z)
            rt = eos.hydrostatic_density(
                self.fw.pp, torch.as_tensor(depth, dtype=torch.float32), fluid_idx)
            return rt.numpy().astype(np.float64)
        z_intf = self._interface_z(pts[:, 0])
        rho0_h = self.fw.pp.fluids[self.heavy].rho0
        rho0_l = self.fw.pp.fluids[self.light].rho0
        P = rho0_h * g * np.maximum(0.0, H - z_intf) \
            + rho0_l * g * np.maximum(0.0, z_intf - z)
        rt = eos.density_from_pressure(
            self.fw.pp, torch.as_tensor(P, dtype=torch.float32), torch.tensor(fluid_idx))
        return rt.numpy().astype(np.float64)


class Bubble(Problem):
    """Rising air bubble in water (reference `src/problems/Bubble.cu`):
    R=0.025 bubble centered 2R above the floor of a 6R x 6R x 10R water
    column; Grenier's formulation (h/R = 0.128) with pseudo surface tension
    (epsinterface=0.08), DYN boundaries, air (rho0=1, gamma=1.4,
    c0=198 sqrt(gH)) / water (rho0=1000, gamma=7, c0=14 sqrt(gH)),
    hydrostatic two-phase init with per-particle masses by density and
    repacking parameters (Bubble.cu:49-226).  Runs on the general pair path
    (``formulation`` grenier, ha or f2)."""

    name = "Bubble"

    def __init__(self, options=None):
        super().__init__(options)
        R = self.R = self.get_option("R", 0.025)
        H = self.H = 10 * R
        lx = ly = 6 * R
        lz = H
        formulation = _formulation(str(self.get_option("formulation", "grenier")))

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            formulation=formulation,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_MULTIFLUID
            | SimFlags.ENABLE_REPACKING,
        )
        # Grenier sets h/R = 0.128 (Bubble.cu:65-67)
        self.set_deltap(self.get_option("deltap", 0.128 * R / 1.3))
        dp = self.deltap
        self.set_gravity(-9.81)
        g = self.get_gravity_magnitude()
        self.set_max_fall(H)
        maxvel = math.sqrt(g * H)

        self.air = self.add_fluid(1.0)
        self.water = self.add_fluid(1000.0)
        self.set_equation_of_state(self.air, 1.4, 198 * maxvel)
        self.set_equation_of_state(self.water, 7.0, 14 * maxvel)
        self.set_kinematic_visc(self.air, 4.5e-3)
        self.set_kinematic_visc(self.water, 3.5e-5)
        self._update_pp(epsinterface=0.08)
        c0_air = 198 * maxvel
        self._update_sp(
            repack_maxiter=1000,
            repack_a=100 / (2.0 * c0_air * c0_air),
            repack_alpha=2 * dp / c0_air,
        )
        self.set_tend(self.get_option("tend", 1.0))
        self.add_writer(freq=0.01)

        off = self.dyn_layers * dp
        size = (lx + 2 * off, ly + 2 * off, lz + 2 * off)
        origin = (-size[0] / 2, -size[1] / 2, -size[2] / 2)
        self.origin_z = origin[2]
        self.make_universe_box(origin, size)
        self.add_box(GeometryType.FIXED_BOUNDARY, FillType.BORDER,
                     origin, *size, fluid_idx=self.water, mass_by_density=True)
        pts = geo.fill_box((origin[0] + off, origin[1] + off, origin[2] + off),
                           (lx, ly, lz), dp)
        inside = self._in_bubble(pts)
        self.add_points(GeometryType.FLUID, pts[inside],
                        fluid_idx=self.air, mass_by_density=True)
        self.add_points(GeometryType.FLUID, pts[~inside],
                        fluid_idx=self.water, mass_by_density=True)

    def _in_bubble(self, pts):
        """Bubble of radius R centered on the axis, 2R above the floor
        (Bubble.cu:156-163)."""
        cz = self.origin_z + 2 * self.R
        return pts[:, 0] ** 2 + pts[:, 1] ** 2 + (pts[:, 2] - cz) ** 2 < self.R * self.R

    def initial_density(self, pts, fluid_idx):
        """Hydrostatic init (Bubble.cu:166-226): water (and walls) from the
        column top; air from the water pressure at the local upper bubble
        surface plus its own small column."""
        g = self.get_gravity_magnitude()
        H = self.H
        depth = H - pts[:, 2] + self.origin_z
        if fluid_idx == self.water:
            rt = eos.hydrostatic_density(
                self.fw.pp, torch.as_tensor(depth, dtype=torch.float32), fluid_idx)
            return rt.numpy().astype(np.float64)
        # upper bubble surface above this (x,y), clamped for safety
        r2 = np.maximum(0.0, self.R**2 - pts[:, 0] ** 2 - pts[:, 1] ** 2)
        z_intf = 2 * self.R + np.sqrt(r2)
        rho0_w = self.fw.pp.fluids[self.water].rho0
        rho0_a = self.fw.pp.fluids[self.air].rho0
        P = rho0_w * g * (H - z_intf) \
            + rho0_a * g * (z_intf - pts[:, 2] + self.origin_z)
        rt = eos.density_from_pressure(
            self.fw.pp, torch.as_tensor(P, dtype=torch.float32), torch.tensor(fluid_idx))
        return rt.numpy().astype(np.float64)


class BiFluidPoiseuille(Problem):
    """Two-layer Poiseuille flow (reference
    `src/problems/BiFluidPoiseuille.inc`, DYN variant): SPH_HA, periodic
    x/y, channel height H=2 along z, body force g=0.1 along x, interface at
    z = H (alpha - 1/2); the analytic two-fluid profile gives umax.  Runs on
    the general pair path (Hu & Adams, multi-fluid diffusion)."""

    name = "BiFluidPoiseuille"

    def __init__(self, options=None):
        super().__init__(options)
        H = 2.0
        self.H = H
        config = self.get_option("config", 1)
        lam, omega = {0: (1.0, 1.0), 1: (4.0, 4.0), 2: (0.01, 1.0)}[config]
        self.alpha = 0.5
        g = 0.1
        rho0, nu0 = 4000.0, 0.4
        rho1, nu1 = rho0 / lam, nu0 / omega
        self.setup_framework(
            formulation=SPHFormulation.SPH_HA,
            kernel=KernelType.WENDLAND,
            rheology=RheologyType.NEWTONIAN,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            computational_visc=ComputationalViscosityType.DYNAMIC,
            visc_model=ViscousModel.MORRIS,
            visc_average=AverageOperator.HARMONIC,
            boundary=BoundaryType.DYN_BOUNDARY,
            periodicity=Periodicity.XY,
            density_diffusion=DensityDiffusionType(
                self.get_option("density-diffusion", int(DensityDiffusionType.COLAGROSSI))),
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_MULTIFLUID,
            simparams=SimParams(dtadaptfactor=0.3, densityDiffCoeff=0.05),
        )
        self.set_deltap(self.get_option("deltap", 0.05))
        dp = self.deltap
        self.set_gravity((g, 0.0, 0.0))
        # umax of the analytic two-fluid profile (BiFluidPoiseuille.inc:103-120)
        uref = g * H * H / (2 * nu0)
        denom = 4 * (self.alpha + lam * omega - self.alpha * lam * omega) ** 2
        a = self.alpha
        umax0 = uref * (omega + 2*a*(lam-1)*omega + a*a*(1+omega-2*lam*omega))**2 / denom
        umax1 = uref * omega * (a*(2+a*(lam-2)) + (a-1)**2*lam*omega)**2 / denom
        self.umax = umax = max(umax0, umax1)
        bottom = self.add_fluid(rho0)
        top = self.add_fluid(rho1)
        self.set_equation_of_state(top, 7.0, 10 * umax)
        self.set_equation_of_state(bottom, 7.0, 10 * umax)
        self.set_kinematic_visc(bottom, nu0)
        self.set_kinematic_visc(top, nu1)
        tvisc = max(H * H / nu0, H * H / nu1)
        self.set_tend(self.get_option("tend", 250 * tvisc))
        self.add_writer(freq=tvisc)

        l = a_w = H / 4
        wall = self.dyn_layers * dp
        self.make_universe_box((-l/2, -a_w/2, -H/2 - wall), (l, a_w, H + 2 * wall))
        gap = dp / 2
        for z0 in (-H/2 - wall, H/2):
            self.add_points(
                GeometryType.FIXED_BOUNDARY,
                geo.fill_box((-l/2 + gap, -a_w/2 + gap, z0 + dp/2),
                             (l - dp, a_w - dp, wall - dp), dp))
        # bottom fluid (fluid 0) under the interface, top fluid above
        zi = H * (self.alpha - 0.5)
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (-l/2 + gap, -a_w/2 + gap, -H/2 + dp/2),
                     l - dp, a_w - dp, zi - dp/2 - (-H/2), fluid_idx=bottom)
        self.add_box(GeometryType.FLUID, FillType.SOLID,
                     (-l/2 + gap, -a_w/2 + gap, zi + dp/2),
                     l - dp, a_w - dp, H/2 - zi - dp, fluid_idx=top)
        self.set_water_level(H)  # no vertical gravity: uniform density

    def initialize_particles(self, grid, state):
        return state.replace(rho=torch.zeros_like(state.rho))


class BiFluidPoiseuilleSA(BiFluidPoiseuille):
    """Two-layer Poiseuille flow between SA wall plates (reference
    `src/problems/BiFluidPoiseuilleSA.cu`: SA_BOUNDARY, ENABLE_DTADAPT |
    ENABLE_MULTIFLUID | ENABLE_DENSITY_SUM; the reference's Crixus meshes
    built here as plates at z = +-H/2, periodic in x and y)."""

    name = "BiFluidPoiseuilleSA"

    def __init__(self, options=None):
        super().__init__(options)
        self.fw = dataclasses.replace(self.fw, boundarytype=BoundaryType.SA_BOUNDARY,
                                      flags=self.fw.flags | SimFlags.ENABLE_DENSITY_SUM)
        dp = self.deltap
        H = self.H
        l = a_w = H / 4  # noqa: E741  (the JAX package's names)
        # the SA plates take the place of the DYN wall fills
        self.geometries = [g for g in self.geometries
                           if g.gtype != GeometryType.FIXED_BOUNDARY]
        self.make_universe_box((-l / 2, -a_w / 2, -H / 2 - 2 * dp), (l, a_w, H + 4 * dp))
        for z0, nrm in ((-H / 2, (0, 0, 1.0)), (H / 2, (0, 0, -1.0))):
            self.add_sa_plate((-l / 2, -a_w / 2, z0), (l, 0, 0), (0, a_w, 0), nrm,
                              periodic_u=True, periodic_v=True)


class _LithostaticBase(Problem):
    """Lithostatic equilibrium: a water layer over a saturated sediment bed in
    a 1 x 1 x 2.5 m box (reference `src/problems/Lithostatic.inc`): Hu &
    Adams, granular rheology with the Jacobi effective-pressure solver, whose
    converged p_eff(z) follows the lithostatic slope (rho_sed - rho_w) g
    (`scripts/validate_lithostatic_torch.py`).  Runs on the general pair
    path."""

    boundary = BoundaryType.LJ_BOUNDARY

    def __init__(self, options=None):
        super().__init__(options)
        dp = self.get_option("deltap", 0.05)
        # Lithostatic.inc:44-48
        self.hs = (math.floor(1.0 / dp) - 0.5) * dp
        self.hw = math.floor(1.0 / dp) * dp
        H = 2.5
        l = 1.0
        self.setup_framework(
            formulation=SPHFormulation.SPH_HA,
            kernel=KernelType.WENDLAND,
            boundary=self.boundary,
            rheology=RheologyType.GRANULAR,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            visc_model=ViscousModel.MORRIS,
            visc_average=AverageOperator.HARMONIC,
            density_diffusion=DensityDiffusionType(self.get_option("density-diffusion", 0)),
            simparams=SimParams(
                sfactor=2.0, dtadaptfactor=0.3, densityDiffCoeff=0.5,
                jacobi_maxiter=self.get_option("jacobi_maxiter", 1000),
                jacobi_backerr=3e-5, jacobi_residual=3e-5,
            ),
        )
        self.set_deltap(dp)
        g = 9.81
        self.set_gravity(-g)
        c0 = 10.0 * math.sqrt(g * H)
        w = self.add_fluid(1000.0)
        self.set_dynamic_visc(w, 1.0e-3)
        s = self.add_fluid(1892.0)
        self._update_fluid(s, sinpsi=0.5, cohesion=0.0, kinematic_visc=1.0e-6)
        self._update_pp(limiting_kinvisc=1e-6)
        self.set_equation_of_state(w, 7.0, c0)
        self.set_equation_of_state(s, 7.0, c0)
        tref = math.sqrt(H / g)
        self.set_tend(self.get_option("tend", 10 * tref))
        self.add_writer(freq=tref / 10)
        self.set_max_fall(self.hw + self.hs)

        layers = self.dyn_layers
        wall = layers * dp
        self.make_universe_box((-wall, -wall, -wall), (l + 2 * wall, l + 2 * wall, H + 2 * wall))
        self.add_points(
            GeometryType.FIXED_BOUNDARY,
            _tank_points((0, 0, 0), (l, l, H), dp,
                         layers if self.boundary == BoundaryType.DYN_BOUNDARY else 1))
        # the sediment bed (fluid 1, FG_SEDIMENT), then the water above it
        self.add_box(GeometryType.FLUID, FillType.SOLID, (dp, dp, dp),
                     l - 2 * dp, l - 2 * dp, self.hs - dp, fluid_idx=s, sediment=True)
        self.add_box(GeometryType.FLUID, FillType.SOLID, (dp, dp, self.hs + dp / 2),
                     l - 2 * dp, l - 2 * dp, self.hw - dp / 2)
        self.set_water_level(self.hs + self.hw)


class LithostaticLJ(_LithostaticBase):
    """Lithostatic equilibrium with Lennard-Jones walls (reference
    `src/problems/LithostaticLJ.cu`)."""

    name = "LithostaticLJ"
    boundary = BoundaryType.LJ_BOUNDARY


class LithostaticDYN(_LithostaticBase):
    """Lithostatic equilibrium with dynamic-boundary walls (reference
    `src/problems/LithostaticDYN.cu`)."""

    name = "LithostaticDYN"
    boundary = BoundaryType.DYN_BOUNDARY


class LithostaticSA(_LithostaticBase):
    """Lithostatic equilibrium in an SA container (reference
    `src/problems/LithostaticSA.cu`: SA_BOUNDARY, ENABLE_MULTIFLUID |
    ENABLE_DTADAPT | ENABLE_DENSITY_SUM; the reference's Crixus tank built
    here by ``add_sa_box``), the water and sediment columns started at
    their hydrostatic densities.  The JAX package's initialization calls
    ``eos.density_for_pressure``, which it lacks; the port calls
    ``eos.density_from_pressure`` (ROADMAP section 3)."""

    name = "LithostaticSA"
    boundary = BoundaryType.SA_BOUNDARY

    def __init__(self, options=None):
        super().__init__(options)
        # LithostaticSA.cu:27-28: SA adds ENABLE_DENSITY_SUM (dynamic gamma)
        self.fw = dataclasses.replace(self.fw,
                                      flags=self.fw.flags | SimFlags.ENABLE_DENSITY_SUM)
        dp = self.deltap
        H, l = 2.5, 1.0  # noqa: E741  (the JAX package's names)
        # an SA container in place of the base's point-filled tank
        self.geometries = [g for g in self.geometries
                           if g.gtype != GeometryType.FIXED_BOUNDARY]
        self.sa_meshes = []
        self.make_universe_box((-2 * dp, -2 * dp, -2 * dp), (l + 4 * dp, l + 4 * dp, H + 4 * dp))
        self.add_sa_box((0.0, 0.0, 0.0), (l, l, H), faces="all")

    def initialize_particles(self, grid, state):
        # the two-layer hydrostatic density (Lithostatic.inc
        # initializeParticles): water of depth hw over the sediment bed
        # below z = hs, each layer under its own column
        pp = self.fw.pp
        g = self.get_gravity_magnitude()
        z = state.pos[:, 2]
        sed = has_flag(state.info, FG_SEDIMENT)
        p_w = pp.fluids[0].rho0 * g * torch.clamp(self.hs + self.hw - z, min=0.0)
        p_s = (pp.fluids[0].rho0 * g * self.hw
               + pp.fluids[1].rho0 * g * torch.clamp(self.hs - z, min=0.0))
        rho = eos.density_from_pressure(pp, torch.where(sed, p_s, p_w),
                                        torch.where(sed, 1, 0))
        rho = torch.where(is_fluid(state.info) & state.active, rho, 0.0)
        return state.replace(rho=rho.to(torch.float32))


class DamBreakMobileBed(Problem):
    """Dam break over an erodible sediment bed (reference
    `src/problems/DamBreakMobileBed.cu`): Hu & Adams, granular rheology with
    the Jacobi effective-pressure solver, periodic y, DYN boundaries.  Water
    (rho0 1000) over a saturated sand bed (rho1 = phi rho0 + (1 - phi)
    rho_grain = 1892, sinpsi 0.5, limiting kinematic viscosity 0.0961).  The
    reference loads its geometry from HDF5 dumps (DamBreakMobileBed.cu:
    134-139); this build makes the same scene procedurally, as the JAX
    package does: a flume with a sediment layer of height hs topped at z = 0
    and a water column of height hw behind a virtual dam at x = 0, scaled by
    the ``lx/hw/hs/deltap`` options.  The effective pressure starts from the
    lithostatic profile.  Runs on the general pair path."""

    name = "DamBreakMobileBed"

    def __init__(self, options=None):
        super().__init__(options)
        ddiff = {
            "ferrari": DensityDiffusionType.FERRARI,
            "brezzi": DensityDiffusionType.BREZZI,
            "colagrossi": DensityDiffusionType.COLAGROSSI,
        }[str(self.get_option("density_diffusion", "ferrari")).lower()]

        self.setup_framework(
            kernel=KernelType.WENDLAND,
            formulation=SPHFormulation.SPH_HA,
            boundary=BoundaryType.DYN_BOUNDARY,
            periodicity=Periodicity.Y,
            rheology=RheologyType.GRANULAR,
            turbulence_model=TurbulenceModel.LAMINAR_FLOW,
            density_diffusion=ddiff,
            flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_MULTIFLUID,
            simparams=SimParams(
                densityDiffCoeff=0.05,
                jacobi_maxiter=int(self.get_option("jacobi_maxiter", 10000)),
                jacobi_backerr=1e-3,
                jacobi_residual=1e-3,
            ),
        )
        self.set_deltap(self.get_option("deltap", 0.01))
        dp = self.deltap
        self.set_gravity(-9.81)
        g = self.get_gravity_magnitude()

        hs = self.hs = self.get_option("hs", 0.1)  # sediment height
        hw = self.hw = self.get_option("hw", 0.35)  # water height
        lx = self.get_option("lx", 8.2)
        lx_dam = self.get_option("lx_dam", 3.1)  # reservoir length (x < 0)
        ly = 31 * dp
        lz = self.get_option("lz", 2.2)
        self.zi = 0.0  # sediment/water interface height

        rho0 = 1000.0
        phi = 0.47
        rhog = 2683.0
        rho1 = phi * rho0 + (1.0 - phi) * rhog
        c0 = 10.0 * math.sqrt(g * hw)
        self.set_max_fall(hw)

        water = self.water = self.add_fluid(rho0)
        sed = self.sed = self.add_fluid(rho1)
        self.set_dynamic_visc(water, rho0 * 1.0e-6)
        self.set_kinematic_visc(sed, 1.0e-6)
        self._update_fluid(sed, sinpsi=0.5, cohesion=0.0)
        self._update_pp(limiting_kinvisc=self.get_option("effvisc_max", 0.0960952))
        self.set_equation_of_state(water, 7.0, c0)
        self.set_equation_of_state(sed, 7.0, c0)
        self.set_tend(self.get_option("tend", 20.0))
        self.add_writer(freq=0.0625)

        layers = self.dyn_layers
        wall = layers * dp
        origin = (-lx_dam, 0.0, -hs - wall)
        self.make_universe_box(origin, (lx, ly, lz))
        # flume floor (periodic in y: no side walls) and the end walls
        self.add_points(
            GeometryType.FIXED_BOUNDARY,
            geo.fill_box((origin[0] + dp / 2, dp / 2, -hs - (layers - 1) * dp),
                         (lx - dp, ly - dp, (layers - 1) * dp), dp),
            fluid_idx=water)
        for x0 in (origin[0] + dp / 2, origin[0] + lx - dp / 2 - (layers - 1) * dp):
            self.add_points(
                GeometryType.FIXED_BOUNDARY,
                geo.fill_box((x0, dp / 2, -hs), ((layers - 1) * dp, ly - dp, lz - wall), dp),
                fluid_idx=water)
        bd = wall  # the fluid keeps clear of the end walls
        # the sediment bed over the whole flume: z in [-hs, 0)
        self.add_points(
            GeometryType.FLUID,
            geo.fill_box((origin[0] + bd, dp / 2, -hs + dp / 2),
                         (lx - 2 * bd, ly - dp, hs - dp / 2), dp),
            fluid_idx=sed, sediment=True, mass_by_density=True)
        # the water column behind the dam (x < 0), over the bed
        self.add_points(
            GeometryType.FLUID,
            geo.fill_box((origin[0] + bd, dp / 2, dp / 2),
                         (lx_dam - bd - dp / 2, ly - dp, hw - dp / 2), dp),
            fluid_idx=water, mass_by_density=True)

    def initial_density(self, pts, fluid_idx):
        """Hydrostatic start (DamBreakMobileBed.cu:170-186): the water from
        its column's top, the sediment under the whole water load plus its
        own column."""
        g = self.get_gravity_magnitude()
        rho0_w = self.fw.pp.fluids[self.water].rho0
        rho0_s = self.fw.pp.fluids[self.sed].rho0
        z = pts[:, 2]
        if fluid_idx == self.sed:
            P = self.hw * g * rho0_w + (self.zi - z) * g * rho0_s
        else:
            P = np.maximum(0.0, (self.hw - z) * g * rho0_w)
        rt = eos.density_from_pressure(
            self.fw.pp, torch.as_tensor(P, dtype=torch.float32), torch.tensor(fluid_idx))
        return rt.numpy().astype(np.float64)

    def build(self, capacity=None):
        grid, state = super().build(capacity)
        # the effective pressure starts from the lithostatic profile
        # (DamBreakMobileBed.cu:190-196)
        g = self.get_gravity_magnitude()
        drho = abs(self.fw.pp.fluids[1].rho0 - self.fw.pp.fluids[0].rho0)
        ep = torch.clamp(drho * g * (self.deltap + self.zi - state.pos[:, 2]), min=0.0)
        ep = torch.where(has_flag(state.info, FG_SEDIMENT), ep, 0.0)
        return grid, state.replace(extras=dict(state.extras, effpres=ep.to(torch.float32)))


class DEMExample(Problem):
    """Fluid released over a DEM terrain (reference
    `src/problems/DEMExample.cu`): LJ boundary, the DEM geometry force
    (ENABLE_DEM, `ops/dem.py`) and four side planes; a water box of given
    height above the terrain.  Reads a GRASS ASCII DEM with ``--dem PATH``;
    without one it makes the JAX package's procedural half-wave hill (the
    reference ships `half_wave0.1m.txt`, a 43.3 x 13.4 m swath rising from
    about 0.05 m to 1 m over a half sine).  Runs on the forces kernel."""

    name = "DEMExample"

    def __init__(self, options=None):
        super().__init__(options)
        self.setup_framework(
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.LJ_BOUNDARY,
            rheology=RheologyType.INVISCID,
            turbulence_model=TurbulenceModel.ARTIFICIAL,
            flags=SimFlags.ENABLE_DTADAPT,
            simparams=SimParams(dtadaptfactor=0.3),
        )
        self.set_deltap(self.get_option("deltap", 0.05))
        dp = self.deltap

        dem_file = self.options.get("dem")
        if dem_file:
            dem = load_dem_ascii(dem_file)
        else:
            # the procedural half-wave hill (like the stock DEM, coarser)
            west, south = 0.05, -0.2
            east, north = 6.0, 2.0
            cols, rows = 120, 44
            ew = (east - west) / cols
            ns = (north - south) / rows
            x = west + ew * (np.arange(cols) + 0.5)
            y = south + ns * (np.arange(rows) + 0.5)
            X, _ = np.meshgrid(x, y)
            h = 0.05 + 0.95 * np.clip(np.sin(
                np.clip((X - 1.0) / 4.0, 0.0, 1.0) * math.pi / 2), 0, 1)
            dem = pack_dem(h, x[0], y[0], ew, ns)
        hgrid, west, south, ew, ns = unpack_dem(dem)
        east = west + ew * (hgrid.shape[1] - 1)
        north = south + ns * (hgrid.shape[0] - 1)
        zmax = float(hgrid.max())
        water_height = self.get_option("water_height", 0.8)

        self.fw = dataclasses.replace(self.fw, dem=dem, flags=self.fw.flags | SimFlags.ENABLE_DEM)
        self.set_gravity(-9.81)
        self.set_max_fall(2.0)
        fl = self.add_fluid(1000.0)
        self.set_equation_of_state(fl, 7.0, 10 * math.sqrt(9.81 * 2.0))
        self.add_writer(freq=0.1)
        self.set_tend(self.get_option("tend", 5.0))

        self.make_universe_box((west, south, 0.0), (east - west, north - south, zmax + 2.0))
        # the water box above the terrain: filled, then erased below the
        # terrain and within dp of it
        pts = geo.fill_box((west + dp, south + dp, dp / 2),
                           (east - west - 2 * dp, north - south - 2 * dp, water_height), dp)
        z0, _ = dem_height_normal(dem, torch.as_tensor(pts, dtype=torch.float32))
        self.add_points(GeometryType.FLUID, pts[pts[:, 2] > z0.numpy() + dp])
        # the side walls as planes (addDEMPlanes)
        self.add_plane((west, south, 0), (1, 0, 0))
        self.add_plane((east, north, 0), (-1, 0, 0))
        self.add_plane((west, south, 0), (0, 1, 0))
        self.add_plane((east, north, 0), (0, -1, 0))
        self.set_water_level(water_height)


class OilJet(Problem):
    """Oil jet: a piston pushes fluid up a submerged pipe into a water basin,
    Grenier's formulation (reference `src/problems/OilJet.cu:43-152`, the
    piston's law in ``moving_bodies_callback`` :139-152).  Runs on the
    general pair path.

    The JAX package's scene does not open its pipe: its erase of the basin
    floor over the pipe acts on fluid only, so the floor caps the pipe; the
    pipe's wall is capped at both ends, its caps on the very positions of
    the pipe's fluid, and the piston lies dp/4 from both.  Its basin has no
    side walls, its floor and water filled dp/2 in from the domain's x and
    y faces as for a periodic axis, but it is not periodic: the water pours
    off the floor's edges.  The port builds the scene the reference
    intends (recorded decision): periodic in x and y, the floor's particles
    over the pipe erased, the pipe's wall rising through the floor to the
    basin with a bottom cap and no top cap, the piston filling the bore
    above the bottom cap and the bore's fluid the rest up to the basin, all
    on the basin's lattice.
    """

    name = "OilJet"

    def __init__(self, options=None):
        super().__init__(options)
        layers = 5
        water_level = 2.0
        pipe_length = 2.0
        inner_diam = 0.4
        lx = ly = 2.0

        self.setup_framework(
            formulation=SPHFormulation.SPH_GRENIER,
            kernel=KernelType.WENDLAND,
            boundary=BoundaryType.DYN_BOUNDARY,
            rheology=RheologyType.NEWTONIAN,
            visc_model=ViscousModel.MORRIS,
            periodicity=Periodicity.XY,
            simparams=SimParams(dtadaptfactor=0.2),
        )
        self.set_dynamic_boundaries_layers(layers)
        self.set_deltap(self.get_option("deltap", 0.05))
        dp = self.deltap
        self.set_timestep(0.00013)
        self.set_gravity(-9.81)
        self.set_max_fall(water_level)
        self.add_fluid(1000.0)
        self.set_equation_of_state(0, 7.0, 10.0)
        self.set_kinematic_visc(0, 1.0e-6)
        self.set_tend(self.get_option("tend", 2.0))
        self.add_writer(freq=0.01)

        lz = water_level + pipe_length + layers * dp
        lm1 = layers - 1
        self.make_universe_box((0.0, 0.0, -pipe_length - layers * dp), (lx, ly, 1.1 * lz))

        self.add_box(GeometryType.FLUID, FillType.SOLID, (dp / 2, dp / 2, dp / 2),
                     lx - dp, ly - dp, water_level - dp)
        floor = self.add_box(GeometryType.FIXED_BOUNDARY, FillType.SOLID,
                             (dp / 2, dp / 2, -(lm1 + 0.5) * dp), lx - dp, ly - dp, lm1 * dp)
        # the pipe on the basin's lattice: its fluid and piston fill the
        # columns within the bore's radius, its wall the columns from there
        # out to lm1 * dp beyond it
        bore = inner_diam / 2
        outer = bore + lm1 * dp

        def columns(z0, z1, r0, r1):
            pts = geo.fill_box((dp / 2, dp / 2, z0), (lx - dp, ly - dp, z1 - z0), dp)
            r = np.hypot(pts[:, 0] - lx / 2, pts[:, 1] - ly / 2)
            return pts[(r >= r0) & (r < r1)]

        # erase the basin floor where the pipe passes through
        self.geometries[floor].points = geo.erase_inside(
            self.geometries[floor].points,
            lambda p: np.hypot(p[:, 0] - lx / 2, p[:, 1] - ly / 2) < outer)
        # the wall from the pipe's bottom up to the floor's top layer, with a
        # bottom cap of `layers` layers under the piston and no top cap
        bottom = -pipe_length - lm1 * dp - dp / 2
        piston_base = bottom + layers * dp
        fluid_base = piston_base + layers * dp
        self.add_points(GeometryType.FIXED_BOUNDARY, np.concatenate([
            columns(bottom, -dp / 2, bore, outer),
            columns(bottom, piston_base - dp, 0.0, bore)]))
        self.add_points(GeometryType.FLUID, columns(fluid_base, -dp / 2, 0.0, bore))
        piston = self.add_points(GeometryType.MOVING_BODY,
                                 columns(piston_base, piston_base + lm1 * dp, 0.0, bore))
        piston_vel = 1.0

        def piston_motion(t):
            return body_velocity(t, (0.0, 0.0, piston_vel))

        self.set_body_motion(piston, piston_motion)
        self.set_water_level(water_level)


# the other problems of the JAX package's catalog, and what each waits for
NOT_PORTED = {
    "ChannelIO": "SA boundaries with open boundaries (ROADMAP item 9b)",
    "CompleteSaExample": "SA boundaries with open boundaries (ROADMAP item 9b)",
    "Spheric2SA": "SA boundaries with the k-epsilon model (ROADMAP item 9a)",
    "TurbulentPoiseuilleFlowSA": "SA boundaries with the k-epsilon model (ROADMAP item 9a)",
}


__all__ = ["NOT_PORTED", "DamBreak3D", "Poiseuille", "StillWater", "StillWaterSA",
           "StillWaterRepackSA", "BiFluidPoiseuilleSA", "LithostaticSA",
           "LockExchange", "OpenChannel",
           "BuoyancyTest", "Spheric2", "AccuracyTest", "Objects", "DynBoundsExample",
           "ProblemExample", "PoiseuillePapanastasiou", "DamBreakGate", "WaveTank",
           "SolitaryWave", "OffshorePile", "SlidingWedge", "Seiche", "RTInstability",
           "Bubble", "BiFluidPoiseuille", "LithostaticLJ", "LithostaticDYN",
           "DamBreakMobileBed", "DEMExample", "OilJet"]
