"""Generic: a problem read from an INI file.

Counterpart of the JAX package's ``problems/generic.py`` (the reference's
`src/problems/GenericProblem.*` and the code generator that writes it from
an INI file): the generator's INI schema configures a Problem at run time
instead of generating C++ sources.

Schema (the JAX package's subset of the generator's options)::

    [problem]
    name = MyDam
    deltap = 0.02
    tend = 1.5
    kernel = WENDLAND                ; KernelType name
    boundary = DYN_BOUNDARY          ; LJ_BOUNDARY | MK_BOUNDARY | DYN_BOUNDARY
    turbulence = ARTIFICIAL          ; LAMINAR_FLOW | ARTIFICIAL | SPS
    rheology = INVISCID              ; NEWTONIAN | ...
    density_diffusion = NONE         ; FERRARI | COLAGROSSI | BREZZI
    diffusion_coeff = 0.1            ; with a density diffusion
    periodicity = NONE               ; X | Y | Z | XY | ...
    gravity = 0 0 -9.81
    water_level = 0.4                ; also the maximum fall height
    write_every = 0.05

    [domain]
    origin = 0 0 0
    size = 1.6 0.67 0.6

    [fluid0]                         ; fluid1, ... in order
    rho0 = 1000
    gamma = 7
    c0 = 20                          ; 0: from the water level
    kinematic_visc = 1e-6

    [geometry0]                      ; geometry1, ... in order
    type = fixed_boundary            ; fluid | fixed_boundary | moving_body |
                                     ; floating_body | testpoint
    shape = box                      ; box | box_border | sphere | cylinder | stl
    origin = 0 0 0                   ; box, box_border, testpoint
    size = 1.6 0.67 0.6              ; box, box_border
    open_top = false                 ; box_border
    center = 0.5 0.3 0.1             ; sphere, cylinder (its base)
    radius = 0.1                     ; sphere, cylinder
    height = 0.2                     ; cylinder
    fill = solid                     ; sphere: solid | border
    path = obstacle.stl              ; stl (binary or ASCII)
    fluid = 0                        ; box, sphere, cylinder

Run with ``python -m gpusph_tpu_torch Generic --config problem.ini``.
"""
from __future__ import annotations

import configparser

from ..defs import (
    BoundaryType,
    DensityDiffusionType,
    KernelType,
    Periodicity,
    RheologyType,
    TurbulenceModel,
)
from .base import FillType, GeometryType, Problem

_GTYPES = {
    "fluid": GeometryType.FLUID,
    "fixed_boundary": GeometryType.FIXED_BOUNDARY,
    "moving_body": GeometryType.MOVING_BODY,
    "floating_body": GeometryType.FLOATING_BODY,
    "testpoint": GeometryType.TESTPOINT,
}


def _vec(s):
    return tuple(float(x) for x in s.split())


class Generic(Problem):
    """A problem configured by the INI file of the ``config`` option."""

    name = "Generic"

    def __init__(self, options=None):
        super().__init__(options)
        path = self.get_option("config", "")
        if not path:
            raise ValueError("Generic requires --config <file.ini>")
        cfg = configparser.ConfigParser()
        with open(path) as f:
            cfg.read_file(f)

        p = cfg["problem"]
        self.name = p.get("name", "Generic")
        self.setup_framework(
            kernel=KernelType[p.get("kernel", "WENDLAND")],
            boundary=BoundaryType[p.get("boundary", "DYN_BOUNDARY")],
            turbulence_model=TurbulenceModel[p.get("turbulence", "ARTIFICIAL")],
            rheology=RheologyType[p.get("rheology", "INVISCID")],
            density_diffusion=DensityDiffusionType[p.get("density_diffusion", "NONE")],
            periodicity=Periodicity[p.get("periodicity", "NONE")],
        )
        self.set_deltap(p.getfloat("deltap"))
        self.set_tend(p.getfloat("tend", 1.0))
        self.set_gravity(_vec(p.get("gravity", "0 0 -9.81")))
        if "water_level" in p:
            self.set_water_level(p.getfloat("water_level"))
            self.set_max_fall(p.getfloat("water_level"))
        self.add_writer(freq=p.getfloat("write_every", 0.05))
        if p.get("density_diffusion", "NONE") != "NONE":
            self._update_sp(densityDiffCoeff=p.getfloat("diffusion_coeff", 0.1))

        i = 0
        while f"fluid{i}" in cfg:
            fs = cfg[f"fluid{i}"]
            fl = self.add_fluid(fs.getfloat("rho0", 1000.0))
            self.set_equation_of_state(fl, fs.getfloat("gamma", 7.0), fs.getfloat("c0", 0.0))
            if "kinematic_visc" in fs:
                self.set_kinematic_visc(fl, fs.getfloat("kinematic_visc"))
            i += 1
        if i == 0:
            self.add_fluid(1000.0)
            self.set_equation_of_state(0, 7.0, 0.0)

        d = cfg["domain"]
        self.make_universe_box(_vec(d["origin"]), _vec(d["size"]))

        i = 0
        while f"geometry{i}" in cfg:
            gs = cfg[f"geometry{i}"]
            gtype = _GTYPES[gs.get("type", "fluid")]
            shape = gs.get("shape", "box")
            fluid_idx = gs.getint("fluid", 0)
            if gtype == GeometryType.TESTPOINT:
                self.add_testpoint(_vec(gs["origin"]))
            elif shape == "box":
                self.add_box(gtype, FillType.SOLID, _vec(gs["origin"]), *_vec(gs["size"]),
                             fluid_idx=fluid_idx)
            elif shape == "box_border":
                self.add_box(gtype, FillType.BORDER, _vec(gs["origin"]), *_vec(gs["size"]),
                             open_top=gs.getboolean("open_top", False))
            elif shape == "sphere":
                fill = FillType.SOLID if gs.get("fill", "solid") == "solid" else FillType.BORDER
                self.add_sphere(gtype, fill, _vec(gs["center"]), gs.getfloat("radius"),
                                fluid_idx=fluid_idx)
            elif shape == "cylinder":
                self.add_cylinder(gtype, FillType.SOLID, _vec(gs["center"]),
                                  gs.getfloat("radius"), gs.getfloat("height"),
                                  fluid_idx=fluid_idx)
            elif shape == "stl":
                self.add_stl_mesh(gtype, gs["path"])
            else:
                raise ValueError(f"unknown shape {shape}")
            i += 1


__all__ = ["Generic"]
