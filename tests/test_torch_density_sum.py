"""Port vs JAX package: density summation and the dynamic gamma on SA walls.

Every function of ``ops/density_sum.py`` against its JAX counterpart on the
same inputs: StillWaterSA ppH 6 (density summation, its default; 1,232
particles), sorted by each package, gamma seeded by quadrature, the fluid
moved by a seeded displacement of at most 0.3 dp and its density perturbed
by seeded noise.  The periodic case runs on BiFluidPoiseuilleSA at its
default dp (4,600 particles, periodic in x and y, the coarsest dp at which
the periodic axes keep three cells): with no motion the n+1 grad gamma
must equal ``compute_gamma``'s; the port's does, the JAX package's drops
the segments across the periodic faces (ROADMAP section 3).  Last, one
predictor-corrector step of both packages' ``Simulator`` on StillWaterSA
ppH 6, compared by particle id.  The JAX passes run jitted, in chunks of a
few cells (``chunk_cells``): its dense grad-gamma evaluation over whole
pair blocks is what asks for 72 GB at its default chunk.  Tolerances are
stated from the measured gaps beside each check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.defs import SPHFormulation as JSPHFormulation
from gpusph_tpu.integrator import Simulator as JSimulator
from gpusph_tpu.ops import density_sum as jds
from gpusph_tpu.ops import sa as jsa
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch.convert import state_from_numpy, state_to_numpy
from gpusph_tpu_torch.defs import SPHFormulation
from gpusph_tpu_torch.integrator import Simulator
from gpusph_tpu_torch.ops import density_sum as ds
from gpusph_tpu_torch.ops import sa
from gpusph_tpu_torch.ops.neighbors import build_cells
from gpusph_tpu_torch.problems.base import get_problem
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

SEED = 2025
PPH = 6
CHUNK_CELLS = 4  # the JAX passes' cells per chunk: 0.75 GB for a whole step
DT = 1e-3  # the diffusion pass's dt
# grad gamma after motion, as a fraction of its largest value (measured
# 3.8e-3 on one row: test_gamma_boundary_terms_match)
GRAD_FRAC = 5e-3
# gamma and the relative density after a density-sum update: that row's
# gamma increment moves 2.1e-5 with its grad gamma, and its density with it
# (measured 2.1e-5 and 2.3e-5)
GAMMA_ATOL = 1e-4
RHO_ATOL = 1e-4


def _max(a):
    return float(np.abs(a).max())


def _close(got, want, frac, name):
    """|got - want| <= frac x max|want|, with max|want| > 0."""
    scale = _max(want)
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale, err_msg=name)


@pytest.fixture(scope="module")
def scene():
    """Both packages' StillWaterSA ppH 6 state, sorted, gamma seeded by the
    JAX package's quadrature, the n+1 positions and the JAX results."""
    jp, tp = jget_problem("StillWaterSA")({"ppH": PPH}), get_problem("StillWaterSA")({"ppH": PPH})
    jgrid, jst = jp.build()
    tgrid, _ = tp.build()
    jfw, tfw = jp.fw.finalize(), tp.fw.finalize()
    assert jfw.dynamic_gamma and tfw.dynamic_gamma
    js, jaux = jbuild_cells(jgrid, jst)
    js = jax.jit(lambda s, a: jds.init_dynamic_gamma(jfw, jgrid, s, a,
                                                     chunk_cells=CHUNK_CELLS))(js, jaux)
    rng = np.random.default_rng(SEED)
    fluid = (np.asarray(js.info) & 7) == 0
    nf = int(fluid.sum())
    rho = np.asarray(js.rho).copy()
    rho[fluid] += rng.normal(0.0, 1e-3, size=nf)
    js = js.replace(rho=jnp.asarray(rho, jnp.float32))
    dp = jfw.sp.deltap
    new_pos = np.asarray(js.pos).copy()
    # each axis within 0.17 dp: at most 0.295 dp
    new_pos[fluid] += rng.uniform(-0.17, 0.17, size=(nf, 3)) * dp
    new_pos = new_pos.astype(np.float32)
    ts, taux = build_cells(tgrid, state_from_numpy(js))
    np.testing.assert_array_equal(ts.id.numpy().view(np.uint32), np.asarray(js.id))
    ha = dataclasses.replace(jfw, sph_formulation=JSPHFormulation.SPH_HA)
    kw = dict(chunk_cells=CHUNK_CELLS)

    def passes(s, npos, a):
        new = s.replace(pos=npos)
        summed = jds.density_sum_update(jfw, jgrid, s, new, a, DT, **kw)
        return dict(
            fw=jds.volumic_terms(jfw, jgrid, s, npos, a, DT, **kw),
            fw_ha=jds.volumic_terms(ha, jgrid, s, npos, a, DT, **kw),
            gb=jds.gamma_boundary_terms(jfw, jgrid, s, npos, a, DT, **kw),
            summed=summed,
            integrated=jds.integrate_gamma(jfw, jgrid, s, new, a, DT, **kw),
            diffused=jds.apply_density_diffusion(jfw, jgrid, summed, a, DT, **kw),
        )

    want = jax.device_get(jax.jit(passes)(js, jnp.asarray(new_pos), jaux))
    return tfw, tgrid, ts, taux, torch.as_tensor(new_pos), want


def test_init_dynamic_gamma_matches(scene):
    """The seeded gamma and grad gamma: the port's quadrature on the same
    sorted state against the JAX package's."""
    fw, grid, ts, aux, _, _ = scene
    got = ds.init_dynamic_gamma(fw, grid, ts.replace(extras={
        k: v for k, v in ts.extras.items() if k not in ("gamma", "gradgamma")}), aux)
    gamma, ggam = ts.extras["gamma"].numpy(), ts.extras["gradgamma"].numpy()
    assert gamma.min() < 0.85 and _max(ggam) > 0
    # measured: gamma 6.0e-8 apart, grad gamma 1.8e-5 of its largest (as
    # tests/test_torch_sa.py's compute_gamma)
    np.testing.assert_allclose(got.extras["gamma"].numpy(), gamma, rtol=0, atol=1e-6)
    _close(got.extras["gradgamma"].numpy(), ggam, 2e-3, "gradgamma")


@pytest.mark.parametrize("formulation", ["f1", "ha"])
def test_volumic_terms_match(scene, formulation):
    """The kernel-sum difference over fluid and vertex neighbors, with the
    Hu & Adams masses on the same scene (sph_formulation replaced in both
    frameworks)."""
    fw, grid, ts, aux, new_pos, want = scene
    key = "fw"
    if formulation == "ha":
        fw, key = dataclasses.replace(fw, sph_formulation=SPHFormulation.SPH_HA), "fw_ha"
    got = ds.volumic_terms(fw, grid, ts, new_pos, aux).numpy()
    # measured: 1.18e-4 of 142.8 (8.3e-7 of the largest) in both; the
    # row sums of m w^{n+1} and -m w^n, near 1,000 each, run in another
    # order
    _close(got, want[key], 5e-6, key)


def test_gamma_boundary_terms_match(scene):
    """The trapezoidal gamma increment and the n+1 grad gamma over segment
    neighbors (StillWaterSA is not periodic: the wrap changes nothing)."""
    fw, grid, ts, aux, new_pos, want = scene
    got = ds.gamma_boundary_terms(fw, grid, ts, new_pos, aux)
    # measured: ggdotr 3.7e-4 of its largest; grad gamma 4.2e-4 (x),
    # 3.8e-3 (y), 1.3e-4 (z) of its largest.  The y gap is one fluid row
    # whose n+1 grad gamma is ill-conditioned in f32: -2.71892 here,
    # -2.73120 in the JAX package, -2.71553 in either package's per-pair
    # formula fed (npos_a - npos_s) / h, -2.72726 in f64
    # (tests/test_torch_sa.py holds the per-pair formula at 2e-3)
    _close(got["ggdotr"].numpy(), want["gb"]["ggdotr"], 2e-3, "ggdotr")
    for k in ("ggx", "ggy", "ggz"):
        _close(got[k].numpy(), want["gb"][k], GRAD_FRAC, k)


def test_gamma_boundary_terms_moving_bodies(scene):
    """Under ENABLE_MOVING_BODIES the vertices are centrals too (the JAX
    package's ``central_vertex``): the fluid rows keep their terms, the
    vertex rows get the sums over their segment neighbors, and
    integrate_gamma updates both."""
    from gpusph_tpu_torch.defs import SimFlags

    fw, grid, ts, aux, new_pos, _ = scene
    moving = dataclasses.replace(fw, flags=fw.flags | SimFlags.ENABLE_MOVING_BODIES)
    fixed = ds.gamma_boundary_terms(fw, grid, ts, new_pos, aux)
    got = ds.gamma_boundary_terms(moving, grid, ts, new_pos, aux)
    ptype = ts.info & 7
    for k in ("ggdotr", "ggx", "ggy", "ggz"):
        # the same pair terms, evaluated among more pairs: the vectorized
        # f32 transcendentals may move by ulps with a term's place
        # (measured: 4.8e-7 of the largest, on ggdotr)
        _close(got[k][ptype == 0].numpy(), fixed[k][ptype == 0].numpy(), 1e-5, k)
        assert float(fixed[k][ptype == 2].abs().max()) == 0.0, k
    assert float(got["ggz"][ptype == 2].abs().max()) > 0
    gamma = ds.integrate_gamma(moving, grid, ts, ts.replace(pos=new_pos), aux).extras["gamma"]
    vert = ptype == 2
    assert torch.equal(gamma[vert], ts.extras["gamma"][vert] + got["ggdotr"][vert])


def test_density_sum_update_matches(scene):
    """DENSITY_SUM: the fluid density and the integrated, clipped gamma and
    grad gamma; wall rows keep theirs."""
    fw, grid, ts, aux, new_pos, want = scene
    got = ds.density_sum_update(fw, grid, ts, ts.replace(pos=new_pos), aux)
    w = want["summed"]
    wall = (ts.info.numpy() & 7) != 0
    np.testing.assert_array_equal(got.rho.numpy()[wall], ts.rho.numpy()[wall])
    np.testing.assert_allclose(got.rho.numpy(), w.rho, rtol=0, atol=RHO_ATOL)
    np.testing.assert_allclose(got.extras["gamma"].numpy(), w.extras["gamma"], rtol=0,
                               atol=GAMMA_ATOL)
    _close(got.extras["gradgamma"].numpy(), w.extras["gradgamma"], GRAD_FRAC, "gradgamma")
    assert np.abs(w.rho - ts.rho.numpy()).max() > 1e-3  # the displacement moved it


def test_integrate_gamma_matches(scene):
    """INTEGRATE_GAMMA: gamma alone, the density untouched."""
    fw, grid, ts, aux, new_pos, want = scene
    got = ds.integrate_gamma(fw, grid, ts, ts.replace(pos=new_pos), aux)
    w = want["integrated"]
    assert torch.equal(got.rho, ts.rho)
    np.testing.assert_allclose(got.extras["gamma"].numpy(), w.extras["gamma"], rtol=0,
                               atol=GAMMA_ATOL)
    _close(got.extras["gradgamma"].numpy(), w.extras["gradgamma"], GRAD_FRAC, "gradgamma")


def test_apply_density_diffusion_matches(scene):
    """The diffusion pass (Colagrossi, StillWaterSA's) on the JAX package's
    density-summed state."""
    fw, grid, ts, aux, new_pos, want = scene
    summed = state_from_numpy(want["summed"])
    got = ds.apply_density_diffusion(fw, grid, summed, aux, torch.tensor(DT)).rho.numpy()
    w = want["diffused"].rho
    moved = w - want["summed"].rho
    assert _max(moved) > 0
    # measured: 7.5e-9 apart, 8.3e-7 of the largest change
    np.testing.assert_allclose(got - want["summed"].rho, moved, rtol=0,
                               atol=1e-3 * _max(moved) + 1e-7)


def test_static_identity(scene):
    """No motion: the kernel sums cancel and gamma stays (the JAX package's
    own bars, tests/test_density_sum.py): rho within 2e-5, gamma 1e-6."""
    fw, grid, ts, aux, _, _ = scene
    got = ds.density_sum_update(fw, grid, ts, ts, aux)
    act = ts.active.numpy()
    np.testing.assert_allclose(got.rho.numpy()[act], ts.rho.numpy()[act], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.extras["gamma"].numpy()[act],
                               ts.extras["gamma"].numpy()[act], rtol=0, atol=1e-6)


def test_periodic_grad_gamma():
    """BiFluidPoiseuilleSA, no motion: the n+1 grad gamma of every fluid row
    is compute_gamma's.  The port's is; the JAX package's loses the segments
    across the periodic faces on the rows near them, and meets the port on
    the others."""
    jp, tp = jget_problem("BiFluidPoiseuilleSA")({}), get_problem("BiFluidPoiseuilleSA")({})
    jgrid, jst = jp.build()
    tgrid, _ = tp.build()
    jfw, tfw = jp.fw.finalize(), tp.fw.finalize()
    assert tgrid.periodic == 3 and min(tgrid.ncells[:2]) >= 3
    js, jaux = jbuild_cells(jgrid, jst)
    kw = dict(chunk_cells=CHUNK_CELLS)

    def jax_side(s, a):
        _, gg = jsa.compute_gamma(jfw, jgrid, s, a, **kw)
        return gg, jds.gamma_boundary_terms(jfw, jgrid, s, s.pos, a, 0.0, **kw)

    want_q, jgb = jax.device_get(jax.jit(jax_side)(js, jaux))
    ts, taux = build_cells(tgrid, state_from_numpy(js))
    got = ds.gamma_boundary_terms(tfw, tgrid, ts, ts.pos, taux)
    _, got_q = sa.compute_gamma(tfw, tgrid, ts, taux)
    fluid = (ts.info.numpy() & 7) == 0
    assert int(fluid.sum()) == 4000
    stack = lambda d: np.stack([np.asarray(d[k]) for k in ("ggx", "ggy", "ggz")], -1)[fluid]  # noqa: E731
    mine, theirs = stack({k: v.numpy() for k, v in got.items()}), stack(jgb)
    want_q = want_q[fluid]
    scale = _max(want_q)
    # measured: the port 2.02e-4 of 8.962 from the JAX quadrature, as its
    # own compute_gamma
    np.testing.assert_allclose(mine, want_q, rtol=0, atol=2e-3 * scale)
    np.testing.assert_array_equal(got["ggdotr"].numpy(), 0.0)
    np.testing.assert_allclose(got_q.numpy()[fluid], want_q, rtol=0, atol=2e-3 * scale)
    off = np.abs(theirs - want_q).max(-1) > 2e-3 * scale
    # measured: 200 of 4,000 fluid rows off by more than 2e-3 x 8.962, by
    # up to 3.748
    assert off.sum() > 100 and np.abs(theirs - want_q).max() > 0.2 * scale
    np.testing.assert_allclose(mine[~off], theirs[~off], rtol=0, atol=2e-3 * scale)


def test_whole_step_matches():
    """StillWaterSA (density summation) through both packages' Simulator for
    one predictor-corrector step (the seeding, the rebuild, two forces
    phases on the carried gamma, each Euler step followed by the density
    sum and the diffusion pass, the adaptive dt), compared by id."""
    jp, tp = jget_problem("StillWaterSA")({"ppH": PPH}), get_problem("StillWaterSA")({"ppH": PPH})
    jgrid, jst = jp.build()
    tgrid, _ = tp.build()
    one = lambda fw: dataclasses.replace(  # noqa: E731
        fw, simparams=dataclasses.replace(fw.sp, buildneibsfreq=1))
    tst = state_from_numpy(jst)  # before the JAX run, which donates its input
    jsim = JSimulator(one(jp.fw), jgrid, chunk_cells=CHUNK_CELLS)
    want = state_to_numpy(state_from_numpy(jsim.run(jst, maxiter=1, tend=0.0)))
    tsim = Simulator(one(tp.fw), tgrid, device="cpu")
    got = state_to_numpy(tsim.run(tst, maxiter=1, tend=0.0))
    assert tsim.iterations == jsim.iterations == 1
    np.testing.assert_allclose(tsim.dt, jsim.dt, rtol=1e-5)
    jo, to = np.argsort(want["id"]), np.argsort(got["id"])
    np.testing.assert_array_equal(got["info"][to], want["info"][jo])
    # measured: pos equal, vel 5.3e-7 m/s, rho 7.4e-6, gamma 6.0e-8 apart,
    # grad gamma 1.75e-4 of 6.906, dt equal
    for k, atol in (("pos", 1e-6), ("vel", 1e-5), ("rho", RHO_ATOL)):
        np.testing.assert_allclose(got[k][to], want[k][jo], rtol=0, atol=atol, err_msg=k)
    np.testing.assert_allclose(got["extras"]["gamma"][to], want["extras"]["gamma"][jo],
                               rtol=0, atol=GAMMA_ATOL)
    _close(got["extras"]["gradgamma"][to], want["extras"]["gradgamma"][jo], GRAD_FRAC,
           "gradgamma")
    assert np.abs(got["vel"]).max() > 1e-4  # the fluid has moved
