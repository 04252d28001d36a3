"""Port vs JAX package on the catalog problems: the problem builds, one
chunk of fourteen configurations (with the prescribed body motion, the MLS
filter and the effective viscosity among them on the forces kernel, and
SPS with a gravity callback, Grenier, Hu & Adams, Espanol-Revenga and a
floating body under a gravity callback on the general pair path), the plane
forces, Poiseuille's steady start, SlidingWedge's and OilJet's scenes and the gravity the
body steps take from a callback.

Every scene is cut to a few thousand particles; inputs reach both packages
as the same numpy arrays (``convert.py``).
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gpusph_tpu import bodies as jbodies
from gpusph_tpu.defs import Periodicity as JPeriodicity
from gpusph_tpu.integrator import make_sim_chunk as jmake_sim_chunk
from gpusph_tpu.ops.planes import apply_plane_forces as japply_plane_forces
from gpusph_tpu.problems.base import Plane as JPlane
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch import bodies as tbodies
from gpusph_tpu_torch.convert import bodies_to_numpy, state_from_numpy, state_to_numpy
from gpusph_tpu_torch.geometry import primitives as geo
from gpusph_tpu_torch.integrator import make_sim_chunk
from gpusph_tpu_torch.ops.forces_kernel import kernel_supported
from gpusph_tpu_torch.ops.planes import apply_plane_forces
from gpusph_tpu_torch.defs import Periodicity
from gpusph_tpu_torch.problems.base import GeometryType, get_problem
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

# the build sizes: a few thousand particles each
CASES = {
    "StillWater": dict(ppH=8),
    "Poiseuille": dict(ppH=8),
    "OpenChannel": dict(ppH=6),
    "LockExchange": dict(ppH=8),
    "AccuracyTest": dict(deltap=0.08),
    "Spheric2": dict(deltap=0.08),
    "BuoyancyTest": dict(ppH=8),
    "Objects": dict(deltap=0.05),
    "DynBoundsExample": dict(deltap=1 / 12),
    "ProblemExample": dict(deltap=0.15),
    "DamBreak3D": dict(deltap=0.06, use_planes=True),
    # prescribed body motion, the filters and the effective viscosity
    "DamBreakGate": dict(deltap=0.06),
    "WaveTank": dict(deltap=0.06),
    "SolitaryWave": dict(deltap=0.06),
    "SlidingWedge": dict(deltap=0.2),
    "OffshorePile": dict(deltap=0.15),
    "PoiseuillePapanastasiou": dict(ppH=8),
    "DamBreak3D-mls": dict(deltap=0.06, **{"density-diffusion": 0}),
    # the general pair path: SPS and a gravity callback, Grenier, Hu & Adams,
    # two fluids, Espanol-Revenga (at the widths of scripts/check_problem.py)
    "Seiche": dict(deltap=0.05),
    "RTInstability": dict(deltap=0.04),
    "RTInstability-ha": dict(deltap=0.04, formulation="ha"),
    "Bubble": dict(deltap=0.05),
    "Bubble-f2": dict(deltap=0.05, formulation="f2"),  # on the forces kernel
    "BiFluidPoiseuille": dict(deltap=0.1),
    "Poiseuille-er": dict(ppH=8, viscmodel=2),
    # granular rheology with the Jacobi effective pressure (general path),
    # the DEM terrain (forces kernel) and OilJet (Grenier and a piston)
    "LithostaticLJ": dict(deltap=0.1),
    "LithostaticDYN": dict(deltap=0.1),
    "DamBreakMobileBed": dict(deltap=0.1),
    "DEMExample": dict(deltap=0.15),
    "OilJet": dict(deltap=0.1),
    # SA walls with density summation and the dynamic gamma (general path);
    # LithostaticSA's JAX build needs the stand-in of _jax_eos_stand_in
    "StillWaterSA": dict(ppH=6),
    "StillWaterRepackSA": dict(ppH=6),
    "BiFluidPoiseuilleSA": {},
    "LithostaticSA": dict(deltap=0.1),
}
# the cases that run on the general pair path
GENERAL_PATH = {"Seiche", "RTInstability", "RTInstability-ha", "Bubble",
                "BiFluidPoiseuille", "Poiseuille-er", "BuoyancyTest-gcallback",
                "LithostaticLJ", "LithostaticDYN", "DamBreakMobileBed", "OilJet",
                "StillWaterSA", "StillWaterRepackSA", "BiFluidPoiseuilleSA", "LithostaticSA"}
RTOL = 1e-6  # same f32 formulas; libm may move an ulp
# OilJet's pipe holds water 3.45 m deep at c0 = 10 m/s, so its hydrostatic
# rho/rho0 - 1 reaches 0.19: there one ulp of the f32 pow of the density
# ratio near 1.1-1.3 (2**-23, where XLA's and PyTorch's pow differ on 0.7%
# of the inputs) is more than 1e-6 of the relative density
RHO_ATOL = {"OilJet": 2.0 ** -23}


def _fields(obj):
    """A dataclass's fields as a comparable dict (NaN as a string)."""
    return {k: "nan" if v != v else v for k, v in dataclasses.asdict(obj).items()}


def _erase_objects_overlap(jp):
    """The port's Objects erases the fluid inside its two floating bodies
    (and within dp of them), which the JAX package keeps; apply the same
    erase to a JAX Objects problem so that the rest can be compared."""
    dp, side, cc = jp.deltap, 0.08, (0.5, 0.8 / 5 * 1.5, 0.5)
    in_cube = geo.box_predicate(tuple(c - side / 2 for c in cc), (side,) * 3, margin=dp)
    jp.erase_fluid_inside(lambda p: in_cube(geo.rotate_axis(
        geo.rotate_axis(p, cc, 2, -math.pi / 4), cc, 1, -math.pi / 4)))
    jp.erase_fluid_inside(geo.sphere_predicate((0.5, 0.8 / 5 * 2.5, 0.5), side / 2 + dp))


def _scene_as_port(jp, tp):
    """The port's SlidingWedge and OilJet build other scenes than the JAX
    package's, which do not run or do not open the pipe
    (test_sliding_wedge_scene, test_oiljet_scene): give the JAX problem the
    port's particles, planes and periodicity, so that the rest can be
    compared."""
    for jg, tg in zip(jp.geometries, tp.geometries):
        jg.points = tg.points.copy()
    jp.planes = [JPlane(p.point, p.normal) for p in tp.planes]
    jp.fw = dataclasses.replace(jp.fw, periodicbound=JPeriodicity(int(tp.fw.periodicbound)))


def _seiche_gravity(t, xp):
    """Seiche's gravity callback with the array module ``xp`` (jnp or torch)."""
    on = (t > 0.3) & (t < 3.0)
    gx = xp.where(on, 2.0 * xp.sin(9.8 * (t - 0.3)), 0.0)
    return gx, xp.zeros_like(gx), xp.full_like(gx, -9.81)


def _build(case, opts):
    name = case.split("-")[0]  # "DamBreak3D-mls": a configuration of DamBreak3D
    jp = jget_problem(name)(dict(opts))
    tp = get_problem(name)(dict(opts))
    if case.endswith("-gcallback"):
        # a floating body under Seiche's lateral gravity
        jp.set_gravity_callback(lambda t: _seiche_gravity(t, jnp))
        tp.set_gravity_callback(lambda t: _seiche_gravity(t, torch))
    if name == "Objects":
        _erase_objects_overlap(jp)
    if name in ("SlidingWedge", "OilJet"):
        _scene_as_port(jp, tp)
    jgrid, jst = jp.build()
    tgrid, tst = tp.build()
    return jp, jgrid, jst, tp, tgrid, tst


def _jax_eos_stand_in(monkeypatch):
    """The JAX LithostaticSA calls ``eos.density_for_pressure``, which its
    package lacks; its ``density_from_pressure`` stands in for the test."""
    from gpusph_tpu.ops import eos as jeos

    monkeypatch.setattr(jeos, "density_for_pressure", jeos.density_from_pressure,
                        raising=False)


@pytest.mark.parametrize("name", list(CASES))
def test_problem_build_matches(name, monkeypatch):
    if name == "LithostaticSA":
        _jax_eos_stand_in(monkeypatch)
    jp, jgrid, jst, tp, tgrid, tst = _build(name, CASES[name])
    for f in ("origin", "ncells", "cell_size", "periodic", "order"):
        assert getattr(tgrid, f) == getattr(jgrid, f), f
    assert kernel_supported(tp.fw.finalize(), tgrid) == (name not in GENERAL_PATH)
    got = state_to_numpy(tst)
    for k in ("pos", "vel", "mass", "info", "id"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)), err_msg=k)
    np.testing.assert_allclose(got["rho"], np.asarray(jst.rho), rtol=RTOL,
                               atol=RHO_ATOL.get(name, 1e-9))
    assert sorted(got["extras"]) == sorted(jst.extras)
    for k, v in got["extras"].items():
        np.testing.assert_array_equal(v, np.asarray(jst.extras[k]), err_msg=k)
    for f in ("max_blocks", "max_block_groups", "max_run_extent", "max_flat_tiles",
              "max_parts_per_cell", "slength", "influenceradius", "dt", "tend",
              "dtadaptfactor", "sfactor"):
        assert getattr(tp.fw.sp, f) == getattr(jp.fw.sp, f), f
    assert tp.fw.flags == int(jp.fw.flags)
    assert tp.fw.planes == jp.fw.planes
    assert tp.fw.dem == jp.fw.dem
    assert _fields(tp.fw.pp) == _fields(jp.fw.pp)
    assert [int(p) for p in tp.fw.postprocess] == [int(p) for p in jp.fw.postprocess]
    assert [(int(f), n) for f, n in tp.fw.filters] == [(int(f), n) for f, n in jp.fw.filters]
    assert _fields(tp.fw.visc) == _fields(jp.fw.visc)
    assert tp.gages == jp.gages
    jspecs, tspecs = jp.body_specs(), tp.body_specs()
    assert len(tspecs) == len(jspecs)
    for a, b in zip(jspecs, tspecs):
        assert (b.object_idx, b.mass, b.inertia, b.floating, b.rotation_center) == \
            (a.object_idx, a.mass, a.inertia, a.floating, a.rotation_center)
        assert (b.motion is None) == (a.motion is None)


# particles of each problem at its default options: the full-width scenes of
# chip_smoke.py phase 7 and PERF.md
DEFAULT_PARTICLES = {
    "StillWater": 50771, "Poiseuille": 37888, "OpenChannel": 41280,
    "LockExchange": 119925, "AccuracyTest": 133276, "Spheric2": 149595,
    "BuoyancyTest": 45387, "Objects": 37725, "DynBoundsExample": 561152,
    "ProblemExample": 625835,
    # periodic in y: its grid's fast axis must stay x for the forces kernel
    "OffshorePile": 281714,
}


@pytest.mark.parametrize("name", list(DEFAULT_PARTICLES))
def test_default_width_build(name):
    """Each problem at its default options (the port alone: the JAX builds
    at this width take minutes) holds the particles the card runs, stays on
    the forces kernel, and its cells hold the initial occupancy."""
    from gpusph_tpu_torch.ops.neighbors import build_cells

    p = get_problem(name)({})
    grid, state = p.build()
    assert int(state.count_active()) == DEFAULT_PARTICLES[name]
    fw = p.fw.finalize()
    assert kernel_supported(fw, grid)
    _, aux = build_cells(grid, state)
    assert int(aux.max_occupancy) <= fw.sp.max_parts_per_cell
    assert bool(torch.isfinite(state.rho).all())


def test_objects_erases_the_fluid_inside_its_bodies():
    """The JAX Objects leaves fluid inside its floating bodies (a fluid
    particle closer than dp/5 to a body particle); the port's nearest fluid
    particle is at least dp/2 away."""
    def nearest(p):
        body = np.concatenate([g.points for g in p.geometries
                               if g.gtype == GeometryType.FLOATING_BODY])
        fluid = np.concatenate([g.points for g in p.geometries
                                if g.gtype == GeometryType.FLUID])
        return np.sqrt(((fluid[:, None] - body[None]) ** 2).sum(-1)).min()

    jp = jget_problem("Objects")({"deltap": 0.05})
    tp = get_problem("Objects")({"deltap": 0.05})
    assert nearest(jp) < 0.2 * jp.deltap
    assert nearest(tp) >= 0.5 * tp.deltap


def test_sliding_wedge_scene():
    """The JAX SlidingWedge puts its water below its slope plane and on its
    side walls; the port's water lies at least r0 = dp inside every plane,
    at least dp from the wedge, and the wedge slides along the slope."""
    opts = {"deltap": 0.2}
    jp = jget_problem("SlidingWedge")(dict(opts))
    tp = get_problem("SlidingWedge")(dict(opts))

    def fluid(p):
        return np.concatenate([g.points for g in p.geometries
                               if int(g.gtype) == int(GeometryType.FLUID)])

    def plane_dist(p, plane):
        n = np.asarray(plane.normal) / np.linalg.norm(plane.normal)
        return (fluid(p) - np.asarray(plane.point)) @ n

    dp = tp.deltap
    assert (plane_dist(jp, jp.planes[0]) < 0).mean() > 0.9  # under its slope
    assert min(plane_dist(jp, q).min() for q in jp.planes[1:]) < 0.5 * dp
    assert min(plane_dist(tp, q).min() for q in tp.planes) >= dp * (1 - 1e-9)
    wedge = next(g.points for g in tp.geometries if g.gtype == GeometryType.MOVING_BODY)
    gap = np.sqrt(((fluid(tp)[:, None] - wedge[None]) ** 2).sum(-1)).min()
    assert gap >= dp * (1 - 1e-9)
    (spec,) = tp.body_specs()
    lin, _ = spec.motion(torch.tensor(1.0))
    slope = np.asarray(tp.planes[0].normal)
    assert float(lin.norm()) > 0.5 and abs(float(lin.numpy() @ slope)) < 1e-6


def test_oiljet_scene():
    """The JAX OilJet's floor caps its pipe, its wall's caps sit on the
    pipe's fluid, and its wall-less basin is not periodic; the port's pipe
    is open from the piston to the basin (no fixed particle in the bore
    above the piston, no two particles closer than dp, the bore's fluid and
    the piston on the same columns, the bore's fluid up to the floor's top
    layer under the basin's fluid), and its basin is periodic in x and y,
    the lattice dp apart across the domain's faces."""
    opts = {"deltap": 0.1}
    jp = jget_problem("OilJet")(dict(opts))
    tp = get_problem("OilJet")(dict(opts))
    dp, bore = tp.deltap, 0.2

    def parts(p, gtype):
        return np.concatenate([g.points for g in p.geometries if g.gtype == gtype])

    def in_bore_above_piston(p):
        fixed = parts(p, GeometryType.FIXED_BOUNDARY)
        top = parts(p, GeometryType.MOVING_BODY)[:, 2].max()
        r = np.hypot(fixed[:, 0] - 1.0, fixed[:, 1] - 1.0)
        return int(((r < bore) & (fixed[:, 2] > top)).sum())

    def nearest(p):
        pts = np.concatenate([g.points for g in p.geometries])
        return cKDTree(pts).query(pts, k=2)[0][:, 1].min()

    assert in_bore_above_piston(jp) > 0 and nearest(jp) < 1e-9
    assert in_bore_above_piston(tp) == 0
    assert nearest(tp) >= dp * (1 - 1e-9)
    basin, pipe = tp.geometries[0].points, tp.geometries[3].points
    piston = parts(tp, GeometryType.MOVING_BODY)
    assert len(pipe) and np.array_equal(np.unique(np.round(pipe[:, :2] / dp), axis=0),
                                        np.unique(np.round(piston[:, :2] / dp), axis=0))
    assert np.isclose(pipe[:, 2].max(), -dp / 2) and np.isclose(basin[:, 2].min(), dp / 2)
    assert np.isclose(pipe[:, 2].min() - piston[:, 2].max(), dp)
    assert int(jp.fw.periodicbound) == 0 and int(tp.fw.periodicbound) == int(Periodicity.XY)
    for axis in (0, 1):
        assert np.isclose(basin[:, axis].min() + tp.size[axis] - basin[:, axis].max(), dp)


# one chunk per new branch of the kernel path, with the steps in the chunk
# and the time and global iteration it starts from: the plain version
# evaluates 64 x 128 pair slots per tile on the CPU, and Objects needs dp
# 0.04 for its sphere to hold particles (6,088 particles, 598 tiles), so its
# chunk is cut to 2 steps (4 forces passes)
CHUNK_CASES = {
    "Poiseuille": (dict(ppH=8), 10, 0.0, 0),  # periodic X/Y, Morris, harmonic mean
    "LockExchange": (dict(ppH=8), 10, 0.0, 0),  # two fluids, SPH_F2
    "Objects": (dict(deltap=0.04), 2, 0.0, 0),  # LJ, Ferrari, two floating bodies
    "AccuracyTest": (dict(deltap=0.12), 10, 0.0, 0),  # internal energy
    "DamBreak3D": (dict(deltap=0.06, use_planes=True), 10, 0.0, 0),  # six planes
    # the gate lifts from t = 0.1 s: started at 0.12 s, its body moves
    "DamBreakGate": (dict(deltap=0.06), 10, 0.12, 0),
    # MLS every 10 iterations: from iteration 5 it runs at the chunk's 5th step
    "DamBreak3D-mls": (dict(deltap=0.06, **{"density-diffusion": 0}), 10, 0.0, 5),
    # the effective viscosity before each forces pass, on a sheared start
    "PoiseuillePapanastasiou": (dict(ppH=8, **{"steady-init": True}), 10, 0.0, 0),
    # the general pair path: each pass evaluates K x 27K slots per occupied
    # cell, so these chunks are cut to a few steps.  Seiche from t = 0.35,
    # inside its callback's window, and from iteration 18, so that its MLS
    # filter (every 20) runs at the second step
    "Seiche": (dict(deltap=0.05), 2, 0.35, 18),
    "RTInstability": (dict(deltap=0.04), 2, 0.0, 0),  # Grenier, two fluids
    "Bubble": (dict(deltap=0.05), 4, 0.0, 0),  # Grenier, air and water
    "BiFluidPoiseuille": (dict(deltap=0.1), 10, 0.0, 0),  # Hu & Adams, periodic X/Y
    "Poiseuille-er": (dict(ppH=8, viscmodel=2, **{"steady-init": True}), 2, 0.0, 0),
    # a floating body under a gravity callback: the body steps take gravity_at(t)
    "BuoyancyTest-gcallback": (dict(ppH=8), 2, 0.35, 0),
    # the EFFPRES Jacobi solve before each forces pass (two iterations a
    # solve, of two dense passes each; cells capped at 88 particles, the
    # build's occupancy is 80), the DEM terrain's force after the forces
    # kernel, and OilJet's piston with Grenier
    "LithostaticDYN": (dict(deltap=0.1, jacobi_maxiter=2, max_ppc=88), 1, 0.0, 0),
    "DEMExample": (dict(deltap=0.15), 10, 0.0, 0),
    "OilJet": (dict(deltap=0.2), 2, 0.0, 0),
}


@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_one_chunk_matches(name):
    """One chunk (rebuild + predictor/corrector steps) of the port on the
    CPU against the JAX chunk on its XLA pair path.  Both start from the
    JAX build, at the case's time and global iteration.  The states are compared by particle id: jit compiles the
    JAX cell hash's division differently from the port (and from its own
    eager code), so particles that sit exactly on a cell face may sort into
    the neighbouring cell.  Tolerances of tests/test_torch_chunk.py: pos
    1e-6 m, vel 1e-5 m/s, rho 1e-6, dt rtol 1e-5 (summation order).  The
    body force and torque are f32 sums of particle forces that cancel across
    a body's faces: they are held at 1e-4 of their largest component."""
    opts, steps, t0, it0 = CHUNK_CASES[name]
    jp, jgrid, jst, tp, tgrid, _ = _build(name, opts)
    jfw, tfw = (dataclasses.replace(p.fw, simparams=dataclasses.replace(
        p.fw.sp, buildneibsfreq=steps)).finalize() for p in (jp, tp))
    tst = state_from_numpy(jst)
    jspecs, tspecs = jp.body_specs(), tp.body_specs()
    jb = jbodies.init_bodies_state(jspecs, jst)
    tb = tbodies.init_bodies_state(tspecs, tst)
    dt0 = np.float32(tfw.sp.dt or 0.1 * tfw.sp.slength / max(f.c0 for f in tfw.pp.fluids))

    jchunk = jmake_sim_chunk(jfw, jgrid, use_pallas=False, bodies_specs=jspecs)
    jout = jchunk(jst, jnp.float32(dt0), jnp.float32(t0), jnp.int32(it0), jb)
    tchunk = make_sim_chunk(tfw, tgrid, bodies_specs=tspecs)
    tout = tchunk(tst, torch.tensor(dt0), torch.tensor(t0, dtype=torch.float32), it0, tb)

    js, ts = state_to_numpy(state_from_numpy(jout[0])), state_to_numpy(tout[0])
    jo, to = np.argsort(js["id"]), np.argsort(ts["id"])
    np.testing.assert_array_equal(ts["id"][to], js["id"][jo])
    np.testing.assert_array_equal(ts["info"][to], js["info"][jo])
    for k, atol in (("pos", 1e-6), ("vel", 1e-5), ("rho", 1e-6)):
        np.testing.assert_allclose(ts[k][to], js[k][jo], rtol=0, atol=atol, err_msg=k)
    assert np.abs(ts["vel"]).max() > 1e-3  # the flow has started
    if "energy" in js["extras"]:
        e_t, e_j = ts["extras"]["energy"][to], js["extras"]["energy"][jo]
        assert np.abs(e_j).max() > 0
        np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-5 * np.abs(e_j).max())
    if "effpres" in js["extras"]:
        # the effective pressure the Jacobi solves carried
        ep_t, ep_j = ts["extras"]["effpres"][to], js["extras"]["effpres"][jo]
        assert ep_j.max() > 0
        np.testing.assert_allclose(ep_t, ep_j, rtol=0, atol=1e-4 * ep_j.max())
    if "grenier_J" in js["extras"]:
        # Grenier's log-volume, integrated like the density
        J_t, J_j = ts["extras"]["grenier_J"][to], js["extras"]["grenier_J"][jo]
        assert np.abs(J_j).max() > 0
        np.testing.assert_allclose(J_t, J_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tout[1]), float(jout[1]), rtol=1e-5)
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-5)
    assert tout[3] == int(jout[3]) == it0 + steps
    for k, v in bodies_to_numpy(tout[4]).items():
        want = np.asarray(getattr(jout[4], k))
        atol = 1e-4 * np.abs(want).max() if k in ("force", "torque") else 1e-5
        np.testing.assert_allclose(v, want, rtol=1e-5, atol=atol, err_msg=k)
    jstats, tstats = jout[5], tout[5]
    for k in ("max_occupancy", "n_active"):
        assert int(getattr(tstats, k)) == int(getattr(jstats, k)), k
    np.testing.assert_allclose(float(tstats.max_accel), float(jstats.max_accel), rtol=1e-4)


def test_plane_forces_match():
    """apply_plane_forces on a seeded random state in front of three planes
    (one tilted), with and without the viscous damping term."""
    rng = np.random.default_rng(7)
    n = 400
    pos = rng.uniform(0.004, 0.046, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    mass = np.full(n, 8e-3, np.float32)
    is_fluid = rng.uniform(size=n) < 0.8
    dvdt = rng.normal(0, 1, (n, 3)).astype(np.float32)
    planes = (((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)), ((0.05, 0.0, 0.0), (-1.0, 0.0, 0.0)),
              ((0.0, 0.0, -0.01), (0.0, 1.0, 1.0)))
    for kinvisc in (0.0, 1e-3):
        fws = []
        for p in (jget_problem("ProblemExample")({"deltap": 0.02}),
                  get_problem("ProblemExample")({"deltap": 0.02})):
            p.set_kinematic_visc(0, kinvisc)
            fws.append(dataclasses.replace(
                p.fw, planes=planes,
                physparams=dataclasses.replace(p.fw.pp, dcoeff=50.0)).finalize())
        jfw, tfw = fws
        assert _fields(tfw.pp) == _fields(jfw.pp)
        want = np.asarray(japply_plane_forces(
            jfw, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
            jnp.asarray(is_fluid), jnp.asarray(dvdt)))
        got = apply_plane_forces(tfw, torch.as_tensor(pos), torch.as_tensor(vel),
                                 torch.as_tensor(mass), torch.as_tensor(is_fluid),
                                 torch.as_tensor(dvdt)).numpy()
        assert np.abs(want - dvdt).max() > 1.0  # the planes act
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_poiseuille_steady_init_matches():
    opts = {"ppH": 8, "steady-init": True}
    _, jst = jget_problem("Poiseuille")(dict(opts)).build()
    tp = get_problem("Poiseuille")(dict(opts))
    _, tst = tp.build()
    np.testing.assert_array_equal(tst.vel.numpy(), np.asarray(jst.vel))
    assert float(tst.vel[:, 0].max()) == pytest.approx(tp.compute_poiseuille_vel(0.0), rel=0.02)


def test_geometry_api_matches():
    """add_sphere, add_cylinder and add_points with their overrides, solid
    and border-filled on a DYN framework (three border layers), against the
    JAX Problem API."""
    from gpusph_tpu.problems.base import FillType as JFill
    from gpusph_tpu.problems.base import GeometryType as JGeom
    from gpusph_tpu_torch.problems.base import FillType

    probs = []
    for p, G, F in ((jget_problem("DamBreak3D")({"deltap": 0.1}), JGeom, JFill),
                    (get_problem("DamBreak3D")({"deltap": 0.1}), GeometryType, FillType)):
        for fill, x in ((F.SOLID, 0.8), (F.BORDER, 1.2)):
            p.add_sphere(G.FLOATING_BODY, fill, (x, 0.3, 0.3), 0.17, density=500.0)
            p.add_cylinder(G.FIXED_BOUNDARY, fill, (x - 0.5, 0.3, 0.0), 0.12, 0.25)
        p.add_points(G.FLUID, [[0.2, 0.2, 0.2], [0.25, 0.2, 0.2]], velocity=(0.5, 0.0, -0.1))
        probs.append(p)
    jp, tp = probs
    for a, b in zip(jp.geometries, tp.geometries):
        np.testing.assert_array_equal(b.points, a.points)
        assert (int(b.gtype), b.density, b.velocity) == (int(a.gtype), a.density, a.velocity)
    _, jst = jp.build()
    _, tst = tp.build()
    got = state_to_numpy(tst)
    for k in ("pos", "vel", "mass", "info"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)), err_msg=k)
    assert [(b.object_idx, b.mass, b.inertia) for b in tp.body_specs()] == \
        [(b.object_idx, b.mass, b.inertia) for b in jp.body_specs()]


def test_bodies_step_with_the_callback_gravity(monkeypatch):
    """Each body step of a chunk takes the gravity callback's value at its
    time, t for the predictor and t + dt/2 for the corrector (the JAX
    integrator's ``gravity_at``), not the constant ``pp.gravity``."""
    from gpusph_tpu_torch import integrator

    tp = get_problem("BuoyancyTest")({"ppH": 8})
    tp.set_gravity_callback(lambda t: _seiche_gravity(t, torch))
    tgrid, tst = tp.build()
    fw = dataclasses.replace(tp.fw, simparams=dataclasses.replace(
        tp.fw.sp, buildneibsfreq=1)).finalize()
    seen = []

    def step_bodies(specs, bodies, gravity, t, dt):
        seen.append((float(t), [float(g) for g in gravity]))
        return tbodies.step_bodies(specs, bodies, gravity, t, dt)

    monkeypatch.setattr(integrator, "step_bodies", step_bodies)
    specs = tp.body_specs()
    t0, dt = 0.35, 1e-4
    make_sim_chunk(fw, tgrid, bodies_specs=specs)(
        tst, torch.tensor(dt), torch.tensor(t0), 0, tbodies.init_bodies_state(specs, tst))
    times = [np.float32(t0), np.float32(t0) + np.float32(dt) * np.float32(0.5)]
    assert [t for t, _ in seen] == pytest.approx([float(t) for t in times], abs=0)
    for (t, g), ti in zip(seen, times):
        want = [float(c) for c in _seiche_gravity(torch.tensor(ti), torch)]
        assert g == want
        assert g[0] != 0.0 and tuple(g) != tuple(fw.pp.gravity)


def test_lithostatic_sa_runs_a_step():
    """LithostaticSA (SA tank, two fluids, the Jacobi effective pressure and
    density summation) through ``Simulator.run`` for one step on the CPU, at
    dp 0.2 (1,016 particles) and two Jacobi iterations a solve; the JAX
    package's dense SA passes at this cell capacity (K = 200) take minutes
    a step, so the port runs alone, held to the JAX density-sum test's bars
    (tests/test_density_sum.py): |rho| < 0.2, gamma in [0.1, 1]."""
    from gpusph_tpu_torch.integrator import Simulator

    p = get_problem("LithostaticSA")({"deltap": 0.2, "jacobi_maxiter": 2})
    grid, st = p.build()
    fw = dataclasses.replace(p.fw, simparams=dataclasses.replace(p.fw.sp, buildneibsfreq=1))
    sim = Simulator(fw, grid, device="cpu")
    out = sim.run(st, maxiter=1)
    assert sim.iterations == 1 and sim.dt > 1e-10
    act = out.active
    assert int(act.sum()) == int(st.count_active()) == 1016
    for t in (out.pos, out.vel, out.rho, out.extras["effpres"]):
        assert bool(torch.isfinite(t).all())
    assert float(out.rho[act].abs().max()) < 0.2
    fluid = act & ((out.info & 7) == 0)
    gamma = out.extras["gamma"][fluid]
    assert float(gamma.min()) >= 0.1 and float(gamma.max()) <= 1.0
    assert float(gamma.min()) < 0.9  # fluid at the tank's walls
    assert float(out.extras["effpres"].max()) > 0
