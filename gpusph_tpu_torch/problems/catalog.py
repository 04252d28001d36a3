"""Problem catalog of the port: DamBreak3D.

Counterpart of ``gpusph_tpu/problems/catalog.py:31-133``; the rest of the
catalog is a later slice.
"""
from __future__ import annotations

import math

from ..defs import (
    BoundaryType,
    DensityDiffusionType,
    FilterType,
    KernelType,
    RheologyType,
    TurbulenceModel,
)
from ..geometry import primitives as geo
from ..params import SimParams
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

        if self.get_option("use_planes", False):
            self.use_planes()  # raises: planes are a later slice
        dim = (1.6, 0.67, 0.6)
        self.make_universe_box((0.0, 0.0, 0.0), dim)
        dp = self.deltap

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


__all__ = ["DamBreak3D"]
