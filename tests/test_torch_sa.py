"""Port vs JAX package: SA walls on the gamma-quadrature path.

The mesh builders (``geometry/sa_mesh.py``) exactly; the two pair formulas
of ``ops/sa.py`` (``grad_gamma_wendland``, ``gamma_fluid_wendland``) on
seeded (particle, triangle) pairs; StillWaterSA's build at ppH 6; its
``compute_gamma``, ``impose_boundary_conditions`` and one SA general forces
pass on the JAX build's state; and one whole-slice run of StillWaterSA
``--density_sum 0`` through both packages' ``Simulator`` (one step),
compared by particle id.  Inputs reach both packages as the same
numpy arrays (``convert.py``).  Every formula keeps the JAX package's f32
operation order; what differs is libm (atan2, acosh, sqrt) and the order of
the pair sums, and the grad-gamma formula cancels heavily (48 qas^5 (28 +
qas^2) times differences of atan2), so its tolerances are stated from the
measured gaps beside each check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.geometry import sa_mesh as jmesh
from gpusph_tpu.integrator import Simulator as JSimulator
from gpusph_tpu.ops import sa as jsa
from gpusph_tpu.ops.forces import compute_forces as jcompute_forces
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch.convert import state_from_numpy, state_to_numpy
from gpusph_tpu_torch.geometry import sa_mesh
from gpusph_tpu_torch.integrator import Simulator, make_sim_chunk
from gpusph_tpu_torch.ops import sa
from gpusph_tpu_torch.ops.forces import compute_forces
from gpusph_tpu_torch.ops.neighbors import build_cells
from gpusph_tpu_torch.ops.pair import PairGeometry
from gpusph_tpu_torch.problems.base import get_problem
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

SEED = 2024
PPH = 6  # 1,232 particles: 150 fluid, 720 segments, 362 vertices

# --- the mesh builders ----------------------------------------------------------

MESH_ARRAYS = ("verts", "vert_normal", "vert_area", "vert_volume", "seg_pos", "seg_normal",
               "seg_verts", "seg_area", "seg_vidx")


@pytest.mark.parametrize("faces,outward", [("all", False), ("open_top", False),
                                           ("channel", False), ("all", True)])
def test_box_sa_mesh_matches(faces, outward):
    """box_sa_mesh of an uneven box at an origin off zero, bit for bit."""
    args = ((0.1, -0.05, 0.2), (0.3, 0.25, 0.2), 0.05)
    want = jmesh.box_sa_mesh(*args, faces=faces, outward=outward)
    got = sa_mesh.box_sa_mesh(*args, faces=faces, outward=outward)
    assert sorted(got) == sorted(want) == sorted(MESH_ARRAYS)
    for k in MESH_ARRAYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # counter-clockwise about the inward normal, as grad gamma requires
    v = got["seg_verts"]
    cross = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    assert (np.einsum("ij,ij->i", cross, got["seg_normal"]) > 0).all()


@pytest.mark.parametrize("periodic_u,periodic_v", [(False, False), (True, False), (True, True)])
def test_plate_sa_mesh_matches(periodic_u, periodic_v):
    """plate_sa_mesh of a tilted plate, with and without periodic seams."""
    args = ((0.0, 0.0, 0.1), (0.4, 0.0, 0.0), (0.0, 0.3, 0.15), (0.0, -0.4472136, 0.8944272),
            0.05)
    want = jmesh.plate_sa_mesh(*args, periodic_u=periodic_u, periodic_v=periodic_v)
    got = sa_mesh.plate_sa_mesh(*args, periodic_u=periodic_u, periodic_v=periodic_v)
    assert sorted(got) == sorted(want) == sorted(MESH_ARRAYS)
    for k in MESH_ARRAYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the two pair formulas --------------------------------------------------------


PAIR_KINDS = ["on_face", "off_face", "edge_clipped", "past_2h", "on_edge_line"]


def _pairs(kind, n=400):
    """Seeded (q, qvb, ns) pair inputs in h-units, as float32 numpy: random
    triangles of side about 0.8 h (dp/h = 1/1.3) in random orientations,
    particles placed by ``kind``."""
    rng = np.random.default_rng([SEED, PAIR_KINDS.index(kind)])
    ns = rng.normal(size=(n, 3))
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    # two tangents
    t1 = np.cross(ns, rng.normal(size=(n, 3)))
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(ns, t1)
    corners = rng.uniform(-0.6, 0.6, size=(n, 3, 2))
    verts = corners[..., 0:1] * t1[:, None] + corners[..., 1:2] * t2[:, None]
    verts -= verts.mean(axis=1, keepdims=True)  # relative to the barycenter
    # counter-clockwise about ns
    cross = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    flip = np.einsum("ij,ij->i", cross, ns) < 0
    verts[flip] = verts[flip][:, [0, 2, 1]]
    bary = rng.dirichlet((1.0, 1.0, 1.0), size=n)
    on_face = np.einsum("ik,ikj->ij", bary, verts)
    if kind == "on_face":  # over the triangle, 0.02-1.9 h off its plane
        q = on_face + rng.uniform(0.02, 1.9, size=(n, 1)) * ns
    elif kind == "off_face":  # beside the triangle, within 2 h
        q = on_face + rng.uniform(1.0, 1.6, size=(n, 1)) * t1 + rng.uniform(
            -0.5, 0.5, size=(n, 1)) * ns
    elif kind == "edge_clipped":  # near an edge, its far vertex beyond 2 h
        verts *= 3.0
        e = 0.5 * (verts[:, 0] + verts[:, 1])
        q = e + rng.uniform(0.1, 1.2, size=(n, 1)) * ns
    elif kind == "past_2h":  # more than 2 h off the triangle's plane
        q = on_face + rng.uniform(2.01, 3.0, size=(n, 1)) * ns * np.sign(
            rng.uniform(-1, 1, size=(n, 1)))
    else:  # "on_edge_line": in the plane of an edge and the normal, pae = +-0
        ns = np.tile([0.0, 0.0, 1.0], (n, 1))
        a = rng.uniform(0.2, 0.5, size=n)
        verts = np.zeros((n, 3, 3))
        verts[:, 0, :2] = np.stack([-a, -a / 2], axis=1)
        verts[:, 1, :2] = np.stack([a, -a / 2], axis=1)
        verts[:, 2, :2] = np.stack([np.zeros(n), a], axis=1)
        q = np.zeros((n, 3))
        q[:, 0] = rng.uniform(-1.5, 1.5, size=n)
        q[:, 1] = -a / 2
        q[:, 2] = rng.uniform(0.05, 1.9, size=n)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    # qvb: the negated vertex positions
    return f32(q), f32(-verts), f32(ns)


def _triples(q, qvb, ns, xp):
    q3 = tuple(xp.asarray(q[:, k]) for k in range(3))
    qvb3 = tuple(tuple(xp.asarray(qvb[:, i, k]) for k in range(3)) for i in range(3))
    ns3 = tuple(xp.asarray(ns[:, k]) for k in range(3))
    return q3, qvb3, ns3


# gaps measured on an 8-core x86 CPU: gamma 5.7e-8 to 3.8e-7 of its
# largest value.  grad gamma 7.1e-6 to 6.0e-4 of its largest value: where
# the formula's terms cancel to a value 1% of the largest, 1e-3 of them is
# lost, and the JAX package's own eager and jit results differ by as much
# (5.0e-5 to 6.0e-4)
GAMMA_ATOL_FRAC = 1e-6
GRAD_ATOL_FRAC = 2e-3


@pytest.mark.parametrize("kind", PAIR_KINDS)
def test_pair_formulas_match(kind):
    h = 0.026
    q, qvb, ns = _pairs(kind)
    jargs = _triples(q, qvb, ns, jnp)
    targs = _triples(q, qvb, ns, torch)
    want_g = np.asarray(jax.jit(jsa.grad_gamma_wendland, static_argnums=3)(*jargs, h))
    want_a = np.asarray(jax.jit(jsa.gamma_fluid_wendland)(*jargs))
    got_g = sa.grad_gamma_wendland(*targs, h).numpy()
    got_a = sa.gamma_fluid_wendland(*targs).numpy()
    assert np.isfinite(got_g).all() and np.isfinite(got_a).all()
    if kind == "past_2h":
        assert not got_g.any() and not want_g.any()
        assert not got_a.any() and not want_a.any()
        return
    assert np.abs(want_g).max() > 0 and np.abs(want_a).max() > 0
    np.testing.assert_allclose(got_g, want_g, rtol=0,
                               atol=GRAD_ATOL_FRAC * np.abs(want_g).max())
    np.testing.assert_allclose(got_a, want_a, rtol=0,
                               atol=GAMMA_ATOL_FRAC * np.abs(want_a).max())


# --- StillWaterSA at ppH 6 ----------------------------------------------------------


@pytest.fixture(scope="module")
def builds():
    """Both packages' StillWaterSA --density_sum 0 at ppH 6."""
    opts = dict(ppH=PPH, density_sum=0)
    jp, tp = jget_problem("StillWaterSA")(dict(opts)), get_problem("StillWaterSA")(dict(opts))
    jgrid, jst = jp.build()
    tgrid, tst = tp.build()
    return jp, jgrid, jst, tp, tgrid, tst


def test_stillwater_sa_build_matches(builds):
    """Grid, every particle field, the SA extras and the parameters."""
    jp, jgrid, jst, tp, tgrid, tst = builds
    for f in ("origin", "ncells", "cell_size", "periodic", "order"):
        assert getattr(tgrid, f) == getattr(jgrid, f), f
    got = state_to_numpy(tst)
    for k in ("pos", "vel", "mass", "info", "id"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)), err_msg=k)
    np.testing.assert_allclose(got["rho"], np.asarray(jst.rho), rtol=1e-6, atol=1e-9)
    assert sorted(got["extras"]) == sorted(jst.extras) == ["belem", "vr0", "vr1", "vr2"]
    for k, v in got["extras"].items():
        np.testing.assert_array_equal(v, np.asarray(jst.extras[k]), err_msg=k)
    for f in ("max_parts_per_cell", "slength", "influenceradius", "deltap", "tend",
              "densityDiffCoeff"):
        assert getattr(tp.fw.sp, f) == getattr(jp.fw.sp, f), f
    assert tp.fw.flags == int(jp.fw.flags)
    assert int(tp.fw.boundarytype) == int(jp.fw.boundarytype)
    # fluid, segment and vertex rows
    ptype = got["info"] & 7
    assert [int((ptype == t).sum()) for t in (0, 1, 2)] == [150, 720, 362]


@pytest.fixture(scope="module")
def passes(builds):
    """The JAX build, its fluid given seeded velocities, sorted by each
    package (the same order: both hash it eagerly), and the JAX package's
    gamma, wall conditions and SA general pass on it, in one jitted call as
    its integrator runs them (its eager pair loop takes most of a minute)."""
    jp, jgrid, jst, tp, tgrid, _ = builds
    fluid = (np.asarray(jst.info) & 7) == 0
    vel = np.asarray(jst.vel).copy()
    vel[fluid] = np.random.default_rng(SEED).normal(0.0, 0.05, size=(int(fluid.sum()), 3))
    jst = jst.replace(vel=jnp.asarray(vel, jnp.float32))
    js, jaux = jbuild_cells(jgrid, jst)
    ts, taux = build_cells(tgrid, state_from_numpy(jst))
    np.testing.assert_array_equal(ts.id.numpy().view(np.uint32), np.asarray(js.id))
    jfw = jp.fw.finalize()

    def sa_phase(s, a):
        gamma, ggam = jsa.compute_gamma(jfw, jgrid, s, a)
        walled = jsa.impose_boundary_conditions(jfw, jgrid, s, a, gamma)
        f = jcompute_forces(jfw, jgrid, walled, a, gamma=gamma)
        return gamma, ggam, walled.rho, f

    want = jax.device_get(jax.jit(sa_phase)(js, jaux))
    return tp.fw.finalize(), tgrid, ts, taux, want


def test_compute_gamma_matches(passes):
    """gamma and grad gamma of every particle; gamma alone (the integrator's
    call) is the same."""
    fw, tgrid, ts, taux, (want_g, want_gg, _, _) = passes
    gamma, ggam = sa.compute_gamma(fw, tgrid, ts, taux)
    fluid = (ts.info.numpy() & 7) == 0
    # fluid at a wall's corner and fluid beyond the walls' reach
    assert want_g[fluid].min() < 0.85 and want_g[fluid].max() == 1.0
    # measured: gamma 6.0e-8 apart, grad gamma 1.8e-5 of its largest
    np.testing.assert_allclose(gamma.numpy(), want_g, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ggam.numpy(), want_gg, rtol=0,
                               atol=GRAD_ATOL_FRAC * np.abs(want_gg).max())
    alone, none = sa.compute_gamma(fw, tgrid, ts, taux, with_grad=False)
    assert none is None
    assert torch.equal(alone, gamma)


def test_impose_boundary_conditions_matches(passes):
    """The segment and vertex densities from the fluid's pressure, under the
    JAX package's gamma; fluid rows keep theirs."""
    fw, tgrid, ts, taux, (want_g, _, want, _) = passes
    got = sa.impose_boundary_conditions(fw, tgrid, ts, taux,
                                        torch.tensor(want_g)).rho.numpy()
    wall = (ts.info.numpy() & 7) != 0
    assert np.abs(want[wall]).max() > 1e-3  # the imposed hydrostatic density
    np.testing.assert_array_equal(got[~wall], ts.rho.numpy()[~wall])
    # measured: 1.2e-7 apart, one ulp of rho/rho0 near 1 out of the inverse
    # equation of state's pow
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-22)


def test_sa_general_pass_matches(passes):
    """One SA general forces pass (vertices as volumic neighbors, the
    segment continuity and pressure terms, the division by gamma) on the
    JAX package's imposed state, its fluid moving at seeded velocities."""
    fw, tgrid, ts, taux, (want_g, _, walled_rho, want) = passes
    got = compute_forces(fw, tgrid, ts.replace(rho=torch.tensor(walled_rho)), taux,
                         gamma=torch.tensor(want_g))
    act = ts.active.numpy()
    for k in ("DvDt", "DrDt"):
        w, g = getattr(want, k)[act], getattr(got, k).numpy()[act]
        assert np.abs(w).max() > 0
        # measured: 9.7e-5 of the largest for DvDt, 1.7e-5 for DrDt, from
        # the segment terms' grad gamma (test_pair_formulas_match)
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4 * np.abs(w).max(), err_msg=k)
    # measured: max_accel 9.8e-6 apart (relative)
    for k in ("max_accel", "max_sspeed"):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   rtol=5e-5, err_msg=k)


def test_gamma_reaches_segments_past_the_kernel_radius(builds):
    """A segment acts through its whole triangle: fluid particles within 2h
    of a triangle's corner but farther from its barycenter get its share of
    gamma only if the grid's cells and the search reach dp/2 past the
    influence radius.  compute_gamma against a brute-force sum of
    gamma_fluid_wendland over every (fluid, segment) pair of the build."""
    _, _, _, tp, tgrid, tst = builds
    fw = tp.fw.finalize()
    ir, dp = fw.sp.influenceradius, fw.sp.deltap
    assert min(tgrid.cell_size) >= ir + 0.5 * dp
    ts, taux = build_cells(tgrid, tst)
    gamma, _ = sa.compute_gamma(fw, tgrid, ts, taux, with_grad=False)
    ptype = ts.info & 7
    fl, seg = torch.nonzero(ptype == 0).squeeze(1), torch.nonzero(ptype == 1).squeeze(1)
    # every (fluid, segment) pair, as a [fluid, 1, segment] block of the pair passes
    rel = ts.pos[fl][:, None, None, :] - ts.pos[seg][None, None, :, :]
    r2 = (rel * rel).sum(-1)
    geom = PairGeometry(rel[..., 0], rel[..., 1], rel[..., 2], r2, torch.sqrt(r2),
                        torch.ones_like(r2, dtype=torch.bool))
    n = {k: v[seg][None, None, :] for k, v in sa.sa_extra_fields(ts).items()}
    slots = sa.PairSlots(geom.mask)
    terms = slots.put(sa.gamma_fluid_wendland(*sa.sa_pair_inputs(n, geom, fw.sp.slength,
                                                                  slots)))[:, 0]
    rel = rel[:, 0]
    far = (rel * rel).sum(-1) >= ir * ir
    assert int((far & (terms != 0)).sum()) > 0  # triangles reaching in from past 2h
    want = torch.clamp(1.0 - terms.sum(1), 1e-3, 1.0)
    # the pair sums run in another order
    np.testing.assert_allclose(gamma[fl].numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_whole_slice_matches(builds):
    """StillWaterSA --density_sum 0 through both packages' Simulator for
    one predictor-corrector step (a chunk of one step: the rebuild, then
    gamma, the wall conditions and the SA general pass twice, the Euler
    steps and the adaptive dt), compared by id.  The JAX package's dense
    SA passes take 38 s a step on one CPU core, so the run is one step.
    Measured: pos 1.5e-8 m, vel 1.7e-6 m/s, rho 1.2e-7 apart, dt equal;
    held at the tolerances of tests/test_torch_chunk.py."""
    jp, jgrid, jst, tp, tgrid, _ = builds
    one = lambda fw: dataclasses.replace(  # noqa: E731
        fw, simparams=dataclasses.replace(fw.sp, buildneibsfreq=1))
    tst = state_from_numpy(jst)  # before the JAX run, which donates its input
    jsim = JSimulator(one(jp.fw), jgrid)
    want = state_to_numpy(state_from_numpy(jsim.run(jst, maxiter=1, tend=0.0)))
    tsim = Simulator(one(tp.fw), tgrid, device="cpu")
    got = state_to_numpy(tsim.run(tst, maxiter=1, tend=0.0))
    assert tsim.iterations == jsim.iterations == 1
    np.testing.assert_allclose(tsim.dt, jsim.dt, rtol=1e-5)
    np.testing.assert_allclose(tsim.t, jsim.t, rtol=1e-6)
    jo, to = np.argsort(want["id"]), np.argsort(got["id"])
    np.testing.assert_array_equal(got["info"][to], want["info"][jo])
    for k, atol in (("pos", 1e-6), ("vel", 1e-5), ("rho", 1e-6)):
        np.testing.assert_allclose(got[k][to], want[k][jo], rtol=0, atol=atol, err_msg=k)
    assert np.abs(got["vel"]).max() > 1e-4  # the fluid has moved


# --- guards -------------------------------------------------------------------------


def test_stillwater_sa_default_raises_density_summation():
    """StillWaterSA's default (density summation, dynamic gamma) no longer
    raises: it builds with the carried gamma (ones) and grad gamma (zeros)
    and make_sim_chunk takes it, as it takes --density_sum 0, which carries
    no gamma."""
    p = get_problem("StillWaterSA")({"ppH": PPH})
    grid, st = p.build()
    fw = p.fw.finalize()
    assert fw.dynamic_gamma
    assert torch.equal(st.extras["gamma"], torch.ones_like(st.rho))
    assert torch.equal(st.extras["gradgamma"], torch.zeros_like(st.pos))
    make_sim_chunk(fw, grid)
    p0 = get_problem("StillWaterSA")({"ppH": PPH, "density_sum": 0})
    grid0, st0 = p0.build()
    assert not p0.fw.finalize().dynamic_gamma and "gamma" not in st0.extras
    make_sim_chunk(p0.fw.finalize(), grid0)


def test_sa_with_keps_or_open_boundaries_raises(builds):
    """An SA box with k-epsilon raises the k-epsilon error at make_sim_chunk,
    in the general pass and in the wall conditions; open boundaries raise
    theirs (ROADMAP items 9a, 9b)."""
    from gpusph_tpu_torch.defs import TurbulenceModel

    _, _, _, tp, tgrid, tst = builds
    fw = tp.fw.finalize()
    keps = dataclasses.replace(fw, visc=dataclasses.replace(
        fw.visc, turbmodel=TurbulenceModel.KEPSILON))
    ts, taux = build_cells(tgrid, tst)
    gamma = torch.ones_like(ts.rho)
    with pytest.raises(NotImplementedError, match="k-epsilon"):
        make_sim_chunk(keps, tgrid)
    with pytest.raises(NotImplementedError, match="k-epsilon"):
        compute_forces(keps, tgrid, ts, taux, gamma=gamma)
    with pytest.raises(NotImplementedError, match="item 9a"):
        sa.impose_boundary_conditions(keps, tgrid, ts, taux, gamma)
    io = dataclasses.replace(fw, io=((0.0,),))
    with pytest.raises(NotImplementedError, match="open boundaries"):
        make_sim_chunk(io, tgrid)
    with pytest.raises(NotImplementedError, match="item 9b"):
        sa.impose_boundary_conditions(io, tgrid, ts, taux, gamma)
    with pytest.raises(NotImplementedError, match="item 9b"):
        tp.add_sa_plate((0, 0, 0), (0.1, 0, 0), (0, 0.1, 0), (0, 0, 1), io=("inlet", True))


def test_density_sum_with_keps_or_open_boundaries_raises():
    """With density summation, k-epsilon and open boundaries still raise at
    make_sim_chunk, and the density-sum passes' open-boundary branches (the
    inflow displacement, the imposed gamma) raise with ROADMAP item 9b."""
    from gpusph_tpu_torch.defs import TurbulenceModel
    from gpusph_tpu_torch.ops import density_sum as ds

    p = get_problem("StillWaterSA")({"ppH": PPH})
    grid, st = p.build()
    fw = p.fw.finalize()
    keps = dataclasses.replace(fw, visc=dataclasses.replace(
        fw.visc, turbmodel=TurbulenceModel.KEPSILON))
    with pytest.raises(NotImplementedError, match="k-epsilon"):
        make_sim_chunk(keps, grid)
    io = dataclasses.replace(fw, io=((0.0,),))
    with pytest.raises(NotImplementedError, match="open boundaries"):
        make_sim_chunk(io, grid)
    ts, taux = build_cells(grid, st)
    for fn in (lambda: ds.volumic_terms(io, grid, ts, ts.pos, taux),
               lambda: ds.gamma_boundary_terms(io, grid, ts, ts.pos, taux),
               lambda: ds.density_sum_update(io, grid, ts, ts, taux),
               lambda: ds.integrate_gamma(io, grid, ts, ts, taux)):
        with pytest.raises(NotImplementedError, match="item 9b"):
            fn()


# --- the output path ----------------------------------------------------------------


def test_output_and_resume(tmp_path):
    """A StillWaterSA --density_sum 0 run on the CPU with the VTU writer and
    a hotfile each chunk (two chunks of one step): the hotfiles carry the SA
    extras, the last frame holds the segment and vertex rows of the final
    state, and a run resumed from the first hotfile ends bit-identical to
    the straight run."""
    import glob
    import os

    from gpusph_tpu_torch.io import vtk
    from gpusph_tpu_torch.io.hotfile import load_hotfile
    from gpusph_tpu_torch.io.writers import WriterDispatcher

    p = get_problem("StillWaterSA")({"ppH": PPH, "density_sum": 0})
    grid, state0 = p.build()
    fw = dataclasses.replace(p.fw, simparams=dataclasses.replace(p.fw.sp, buildneibsfreq=1))

    def run(outdir, state, maxiter, resume=None):
        sim = Simulator(fw, grid, device="cpu")
        if resume is not None:
            state, header, _ = load_hotfile(resume)
            sim.t, sim.dt, sim.iterations = header["t"], header["dt"], header["iterations"]
        writers = WriterDispatcher(outdir, sim.fw, vtk_every=p.vtk_write_every,
                                   hot_every=1e-9, grid=grid)
        final = sim.run(state, maxiter=maxiter, write_every=1e-9, on_write=lambda s, st: (
            writers.maybe_write(s.t, st, dt=s.dt, iterations=s.iterations,
                                force=s.finished)))
        writers.close()
        return final, sorted(glob.glob(os.path.join(outdir, "hot_*.npz")))

    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    final, hots = run(straight, state0, 2)
    assert [load_hotfile(h)[1]["iterations"] for h in hots] == [1, 2]
    fin = state_to_numpy(final)
    st1, _, _ = load_hotfile(hots[0])
    assert sorted(st1.extras) == ["belem", "vr0", "vr1", "vr2"]
    # the walls do not move: each row's normal and vertex offsets follow it
    b0 = state_to_numpy(state0)
    o0, o1 = np.argsort(b0["id"]), np.argsort(state_to_numpy(st1)["id"])
    for k in st1.extras:
        np.testing.assert_array_equal(st1.extras[k].numpy()[o1], b0["extras"][k][o0], err_msg=k)

    frame = vtk.read_vtu(sorted(glob.glob(os.path.join(straight, "data", "PART_*.vtu")))[-1])
    act = final.active.numpy()
    for k, v in (("pos", fin["pos"]), ("Mass", fin["mass"]), ("Id", fin["id"]),
                 ("Info", fin["info"])):
        np.testing.assert_array_equal(frame[k], v[act], err_msg=k)
    assert [int(((frame["Info"] & 7) == t).sum()) for t in (0, 1, 2)] == [150, 720, 362]

    again, _ = run(resumed, None, 2, resume=hots[0])
    got = state_to_numpy(again)
    for k in ("pos", "vel", "rho", "mass", "info", "id"):
        np.testing.assert_array_equal(got[k], fin[k], err_msg=k)
    for k in fin["extras"]:
        np.testing.assert_array_equal(got["extras"][k], fin["extras"][k], err_msg=k)


def test_density_sum_hotfile_resume(tmp_path, monkeypatch):
    """StillWaterSA with density summation on the CPU, a hotfile each chunk
    (two chunks of one step): the hotfiles carry the integrated gamma and
    grad gamma; a fresh run seeds them by quadrature once, a run resumed
    from the first hotfile does not seed them again and ends bit-identical
    to the straight run."""
    import glob
    import os

    from gpusph_tpu_torch import integrator
    from gpusph_tpu_torch.io.hotfile import load_hotfile
    from gpusph_tpu_torch.io.writers import WriterDispatcher

    seeds = []
    seed = integrator.init_dynamic_gamma

    def counted(*args, **kw):
        seeds.append(1)
        return seed(*args, **kw)

    monkeypatch.setattr(integrator, "init_dynamic_gamma", counted)
    p = get_problem("StillWaterSA")({"ppH": PPH})
    grid, state0 = p.build()
    fw = dataclasses.replace(p.fw, simparams=dataclasses.replace(p.fw.sp, buildneibsfreq=1))

    def run(outdir, state, maxiter, resume=None):
        sim = Simulator(fw, grid, device="cpu")
        if resume is not None:
            state, header, _ = load_hotfile(resume)
            sim.t, sim.dt, sim.iterations = header["t"], header["dt"], header["iterations"]
        writers = WriterDispatcher(outdir, sim.fw, hot_every=1e-9, grid=grid)
        final = sim.run(state, maxiter=maxiter, write_every=1e-9, on_write=lambda s, st: (
            writers.maybe_write(s.t, st, dt=s.dt, iterations=s.iterations,
                                force=s.finished)))
        writers.close()
        return final, sorted(glob.glob(os.path.join(outdir, "hot_*.npz")))

    final, hots = run(str(tmp_path / "straight"), state0, 2)
    assert len(seeds) == 1
    assert [load_hotfile(h)[1]["iterations"] for h in hots] == [1, 2]
    st1, _, _ = load_hotfile(hots[0])
    assert sorted(st1.extras) == ["belem", "gamma", "gradgamma", "vr0", "vr1", "vr2"]
    # the carried gamma after a step, which the quadrature would replace
    ts1, taux1 = build_cells(grid, st1)
    quad, _ = sa.compute_gamma(fw.finalize(), grid, ts1, taux1)
    fluid = (ts1.info & 7) == 0
    assert float((ts1.extras["gamma"] - quad)[fluid].abs().max()) > 0
    assert float(ts1.extras["gamma"][fluid].min()) < 0.9
    fin = state_to_numpy(final)
    np.testing.assert_array_equal(state_to_numpy(load_hotfile(hots[1])[0])["extras"]["gamma"],
                                  fin["extras"]["gamma"])

    again, _ = run(str(tmp_path / "resumed"), None, 2, resume=hots[0])
    assert len(seeds) == 1  # the resume kept the hotfile's gamma
    got = state_to_numpy(again)
    for k in ("pos", "vel", "rho", "mass", "info", "id"):
        np.testing.assert_array_equal(got[k], fin[k], err_msg=k)
    for k in fin["extras"]:
        np.testing.assert_array_equal(got["extras"][k], fin["extras"][k], err_msg=k)


def test_repack_runs_before_the_gamma_seeding(tmp_path, monkeypatch):
    """StillWaterRepackSA through the CLI on the CPU (``--repack``, one
    repack chunk, then a chunk cut to one step): the dynamic gamma is seeded
    once, on the repacked particles (the JAX CLI's order)."""
    from gpusph_tpu_torch import cli, integrator
    from gpusph_tpu_torch.io.hotfile import load_hotfile
    from gpusph_tpu_torch.problems.base import PROBLEM_REGISTRY
    from gpusph_tpu_torch.problems.catalog import StillWaterRepackSA

    class _OneStep(StillWaterRepackSA):  # unregistered: its name starts with _
        def __init__(self, options=None):
            super().__init__(options)
            self.fw = dataclasses.replace(self.fw, simparams=dataclasses.replace(
                self.fw.sp, buildneibsfreq=1))

    monkeypatch.setitem(PROBLEM_REGISTRY, "StillWaterRepackSA", _OneStep)

    seeded = []
    seed = integrator.init_dynamic_gamma

    def recorded(fw, grid, state, aux, **kw):
        seeded.append(state_to_numpy(state))
        return seed(fw, grid, state, aux, **kw)

    monkeypatch.setattr(integrator, "init_dynamic_gamma", recorded)
    out = tmp_path / "run"
    assert cli.main(["StillWaterRepackSA", "--ppH", str(PPH), "--repack", "--repack_maxiter",
                     "10", "--maxiter", "1", "--dir", str(out), "--device", "cpu"]) == 0
    repacked = state_to_numpy(load_hotfile(str(out / "repack.npz"))[0])
    built = state_to_numpy(get_problem("StillWaterRepackSA")({"ppH": PPH}).build()[1])
    assert len(seeded) == 1
    got = seeded[0]
    o, r, b = np.argsort(got["id"]), np.argsort(repacked["id"]), np.argsort(built["id"])
    np.testing.assert_array_equal(got["pos"][o], repacked["pos"][r])
    fluid = (built["info"][b] & 7) == 0
    assert np.abs(repacked["pos"][r] - built["pos"][b])[fluid].max() > 0  # it moved
