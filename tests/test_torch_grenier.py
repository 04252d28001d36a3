"""Port vs JAX package: Grenier's density pass, its Euler step, and the
inverse equation of state.

``grenier_density_sigma`` on the seeded two-fluid scene of
``tests/test_grenier.py`` (a perturbed log-volume J) against the JAX pass
(sigma at rtol 1e-5: the same pair sums in another order; the relative
density at 1e-6, the chunk tests' tolerance: rho/rho0 - 1 of an f32 density
near 1000 resolves 6e-8) and against the brute-force float64 sums of
``tests/reference_sph.py`` at that file's tolerances; the Grenier branch of
``euler_step`` (J integrated, the density kept) against the JAX step at
rtol 1e-6; ``eos.density_from_pressure`` against the JAX function (1e-6 on
the relative density: f32 pow of either library) and against ``pressure``,
its inverse.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.ops import eos as jeos
from gpusph_tpu.ops.forces import ForcesOut as JForcesOut
from gpusph_tpu.ops.grenier import grenier_density_sigma as jgrenier_density_sigma
from gpusph_tpu.ops.integrate import euler_step as jeuler_step
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.ops.neighbors import make_grid as jmake_grid

from gpusph_tpu_torch.convert import state_from_numpy, state_to_numpy
from gpusph_tpu_torch.ops import eos
from gpusph_tpu_torch.ops.forces import ForcesOut
from gpusph_tpu_torch.ops.grenier import grenier_density_sigma
from gpusph_tpu_torch.ops.integrate import euler_step
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid

import gpusph_tpu as J
import gpusph_tpu_torch as T
from reference_sph import brute_grenier_density
from test_grenier import RHO0S, make_two_fluid_scene
from test_torch_general_forces import framework
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

CASE = dict(formulation="SPH_GRENIER", diffusion="COLAGROSSI", xi=0.1, turb="LAMINAR_FLOW",
            kinvisc=1e-4, two_fluids=True, epsinterface=0.08)


def _sorted_scene(boundary="DYN_BOUNDARY"):
    case = dict(CASE, boundary=boundary)
    jfw, tfw = framework(J, **case), framework(T, **case)
    st, _, _ = make_two_fluid_scene(np.random.default_rng(4321))
    jgrid = jmake_grid((0, 0, 0), (0.3,) * 3, jfw.influenceradius)
    tgrid = make_grid((0, 0, 0), (0.3,) * 3, tfw.influenceradius)
    js, jaux = jbuild_cells(jgrid, st)
    ts, taux = build_cells(tgrid, state_from_numpy(st))
    np.testing.assert_array_equal(ts.id.numpy().view(np.uint32), np.asarray(js.id))
    return jfw, jgrid, js, jaux, tfw, tgrid, ts, taux


@pytest.mark.parametrize("boundary", ["DYN_BOUNDARY", "LJ_BOUNDARY"])
def test_density_sigma_matches_jax_and_brute_force(boundary):
    jfw, jgrid, js, jaux, tfw, tgrid, ts, taux = _sorted_scene(boundary)
    jsigma, jrho = jgrenier_density_sigma(jfw, jgrid, js, jaux, chunk_cells=16)
    sigma, rho = grenier_density_sigma(tfw, tgrid, ts, taux)
    act = ts.active.numpy()
    np.testing.assert_allclose(sigma.numpy()[act], np.asarray(jsigma)[act], rtol=1e-5)
    np.testing.assert_allclose(rho.numpy()[act], np.asarray(jrho)[act], rtol=0, atol=1e-6)

    info = ts.info.numpy()
    ptype = np.where(act, info & 7, 4)
    f_num = (info >> 16) & 0xFF
    vol = np.exp(ts.extras["grenier_J"].numpy().astype(np.float64)) \
        * ts.extras["grenier_vol0"].numpy()
    b_sigma, b_rho = brute_grenier_density(
        ts.pos.numpy(), ts.mass.numpy(), ptype, f_num, np.maximum(vol, 1e-30),
        h=tfw.sp.slength, boundary="dyn" if boundary == "DYN_BOUNDARY" else "lj")
    # the tolerances of tests/test_grenier.py
    proc = ptype <= 1
    np.testing.assert_allclose(sigma.numpy()[proc], b_sigma[proc], rtol=2e-5, atol=1e-3)
    upd = (ptype == 0) | ((ptype == 1) & (boundary == "DYN_BOUNDARY"))
    rho0 = np.asarray(RHO0S)[f_num]
    np.testing.assert_allclose(((rho.numpy().astype(np.float64) + 1.0) * rho0)[upd],
                               b_rho[upd], rtol=5e-5, atol=1e-6)
    # the density of the particles the pass does not refresh is kept
    np.testing.assert_array_equal(rho.numpy()[~upd], ts.rho.numpy()[~upd])


@pytest.mark.parametrize("step", [1, 2])
def test_grenier_euler_step_matches_jax(step):
    """Euler integrates the log-volume J with DJ/Dt and keeps the density
    (the COMPUTE_DENSITY pass refreshes it before every forces pass)."""
    jfw, jgrid, js, _, tfw, tgrid, ts, _ = _sorted_scene()
    rng = np.random.default_rng(99)
    n = ts.capacity
    f = {k: rng.normal(0, s, size=shape).astype(np.float32)
         for k, s, shape in (("DvDt", 1.0, (n, 3)), ("DrDt", 0.5, (n,)),
                             ("xsph", 0.0, (n, 3)), ("DEDt", 0.0, (n,)))}
    scal = dict(max_accel=1.0, max_sspeed=25.0, max_kinvisc=1e-4)
    dt = np.float32(1e-3)
    jout = jeuler_step(jfw, js, JForcesOut(**{k: jnp.asarray(v) for k, v in f.items()},
                                           **{k: jnp.float32(v) for k, v in scal.items()}),
                       dt * (0.5 if step == 1 else 1.0), step=step, full_dt=dt, grid=jgrid)
    tout = euler_step(tfw, ts, ForcesOut(**{k: torch.as_tensor(v) for k, v in f.items()},
                                         **{k: torch.tensor(v) for k, v in scal.items()}),
                      torch.tensor(dt * (0.5 if step == 1 else 1.0)), step=step,
                      full_dt=torch.tensor(dt), grid=tgrid)
    got, want = state_to_numpy(tout), state_to_numpy(state_from_numpy(jout))
    for k in ("pos", "vel", "rho"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(got["rho"], ts.rho.numpy())  # density kept
    J_new, J_old = got["extras"]["grenier_J"], ts.extras["grenier_J"].numpy()
    np.testing.assert_allclose(J_new, want["extras"]["grenier_J"], rtol=1e-6, atol=1e-9)
    assert np.abs(J_new - J_old).max() > 1e-5  # J moved


def test_density_from_pressure_matches_jax():
    """The inverse EOS per fluid (RTInstability's and Bubble's initial
    density), and pressure(density_from_pressure(p)) = p."""
    tfw = T.setup_framework(physparams=T.PhysParams(fluids=(
        T.Fluid(rho0=1.0, gamma=1.4, c0=300.0), T.Fluid(rho0=1000.0, gamma=7.0, c0=20.0))),
        simparams=T.SimParams(deltap=0.01)).finalize()
    jfw = J.setup_framework(physparams=J.PhysParams(fluids=(
        J.Fluid(rho0=1.0, gamma=1.4, c0=300.0), J.Fluid(rho0=1000.0, gamma=7.0, c0=20.0))),
        simparams=J.SimParams(deltap=0.01)).finalize()
    rng = np.random.default_rng(5)
    press = rng.uniform(0.0, 8000.0, size=400).astype(np.float32)
    f_num = rng.integers(0, 2, size=400).astype(np.int32)
    got = eos.density_from_pressure(tfw.pp, torch.as_tensor(press), torch.as_tensor(f_num))
    want = np.asarray(jeos.density_from_pressure(jfw.pp, jnp.asarray(press),
                                                 jnp.asarray(f_num)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    back = eos.pressure(tfw.pp, got, torch.as_tensor(f_num)).numpy()
    np.testing.assert_allclose(back, press, rtol=1e-3, atol=1e-2)
    # one fluid index for a whole column, as the problems call it
    one = eos.density_from_pressure(tfw.pp, torch.as_tensor(press), torch.tensor(1))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jeos.density_from_pressure(jfw.pp, jnp.asarray(press), 1)),
        rtol=0, atol=1e-6)
