"""Port vs JAX package on DamBreak3D at dp 0.06 (2,650 particles): the
problem build, the Euler/dt/body steps, and one whole chunk.

Inputs reach both packages as the same numpy arrays (``convert.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu import bodies as jbodies
from gpusph_tpu.integrator import make_sim_chunk as jmake_sim_chunk
from gpusph_tpu.ops import integrate as jintegrate
from gpusph_tpu.ops.forces import ForcesOut as JForcesOut
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch import bodies as tbodies
from gpusph_tpu_torch.convert import (bodies_from_numpy, bodies_to_numpy,
                                      state_from_numpy, state_to_numpy)
from gpusph_tpu_torch.integrator import make_sim_chunk
from gpusph_tpu_torch.ops import integrate as tintegrate
from gpusph_tpu_torch.ops.forces import ForcesOut as TForcesOut
from gpusph_tpu_torch.problems.base import get_problem

DELTAP = 0.06
RTOL = 1e-6  # same f32 formulas; libm and summation order may move an ulp


@pytest.fixture(scope="module")
def dambreak():
    jp = jget_problem("DamBreak3D")({"deltap": DELTAP})
    jgrid, jst = jp.build()
    tp = get_problem("DamBreak3D")({"deltap": DELTAP})
    tgrid, tst = tp.build()
    return jp, jgrid, jst, tp, tgrid, tst


def test_problem_build_matches(dambreak):
    jp, jgrid, jst, tp, tgrid, tst = dambreak
    for f in ("origin", "ncells", "cell_size", "periodic", "order"):
        assert getattr(tgrid, f) == getattr(jgrid, f), f
    got = state_to_numpy(tst)
    for k in ("pos", "vel", "mass", "info", "id"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)), err_msg=k)
    # hydrostatic fill: an f32 pow in each framework
    np.testing.assert_allclose(got["rho"], np.asarray(jst.rho), rtol=RTOL, atol=1e-9)
    for f in ("max_blocks", "max_block_groups", "max_run_extent", "max_flat_tiles",
              "max_parts_per_cell", "slength", "influenceradius", "dt", "tend"):
        assert getattr(tp.fw.sp, f) == getattr(jp.fw.sp, f), f
    assert tp.fw.flags == int(jp.fw.flags)
    assert [int(p) for p in tp.fw.postprocess] == [int(p) for p in jp.fw.postprocess]
    jspecs, tspecs = jp.body_specs(), tp.body_specs()
    assert len(tspecs) == len(jspecs) == 1
    for a, b in zip(jspecs, tspecs):
        assert (b.object_idx, b.mass, b.inertia, b.floating) == \
            (a.object_idx, a.mass, a.inertia, a.floating)


def _random_forces(n, seed):
    rng = np.random.default_rng(seed)
    d = dict(DvDt=rng.normal(0, 5, (n, 3)), DrDt=rng.normal(0, 0.1, n),
             xsph=rng.normal(0, 0.1, (n, 3)), DEDt=np.zeros(n),
             max_accel=np.asarray(rng.uniform(5, 50)),
             max_sspeed=np.asarray(rng.uniform(19, 21)),
             max_kinvisc=np.asarray(1e-6))
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    return (JForcesOut(**{k: jnp.asarray(v) for k, v in d.items()}),
            TForcesOut(**{k: torch.as_tensor(v) for k, v in d.items()}))


def _sorted(dambreak):
    jp, jgrid, jst, tp, tgrid, tst = dambreak
    js, _ = jbuild_cells(jgrid, jst)
    return js, state_from_numpy(js)


@pytest.mark.parametrize("step", [1, 2])
def test_euler_step_matches(dambreak, step):
    jp, jgrid, _, tp, tgrid, _ = dambreak
    js, ts = _sorted(dambreak)
    jf, tf = _random_forces(js.capacity, seed=step)
    dt = np.float32(1.1e-3)
    eff = dt * np.float32(0.5) if step == 1 else dt
    full = dict(full_dt=jnp.float32(dt)) if step == 2 else {}
    tfull = dict(full_dt=torch.tensor(dt)) if step == 2 else {}
    want = jintegrate.euler_step(jp.fw.finalize(), js, jf, jnp.float32(eff),
                                 step=step, grid=jgrid, **full)
    got = tintegrate.euler_step(tp.fw.finalize(), ts, tf, torch.tensor(eff),
                                step=step, grid=tgrid, **tfull)
    for k in ("pos", "vel", "rho"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


def test_compute_dt_matches(dambreak):
    jp, _, jst, tp, _, _ = dambreak
    for seed in range(4):
        jf, tf = _random_forces(8, seed)
        want = float(jintegrate.compute_dt(jp.fw.finalize(), jf))
        got = float(tintegrate.compute_dt(tp.fw.finalize(), tf))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def _body_specs(mod, specs):
    """The problem's feedback obstacle plus a floating and a prescribed body
    sharing its particles' object number, to cover every branch."""
    (s,) = specs
    return (s,
            mod.BodySpec(object_idx=2, mass=3.0, inertia=(0.1, 0.2, 0.3), floating=True),
            mod.BodySpec(object_idx=3, motion=lambda t: ((0.1, 0.0, -0.05),
                                                         (0.0, 0.0, 0.7))))


def _body_state(dambreak):
    """Sorted state whose moving particles are split over objects 1-3."""
    js, _ = _sorted(dambreak)
    d = state_to_numpy(state_from_numpy(js))
    info = d["info"].astype(np.int64)
    moving = (info & (1 << 4)) != 0
    idx = np.flatnonzero(moving)
    obj = 1 + (np.arange(len(idx)) % 3)
    info[idx] = (info[idx] & ~(0xFF << 16)) | (obj << 16)
    d["info"] = info.astype(np.uint32)
    jst = js.replace(info=jnp.asarray(d["info"]))
    return jst, state_from_numpy(d)


def test_bodies_match(dambreak):
    jp, _, _, tp, _, _ = dambreak
    jst, tst = _body_state(dambreak)
    jspecs = _body_specs(jbodies, jp.body_specs())
    tspecs = _body_specs(tbodies, tp.body_specs())
    jb = jbodies.init_bodies_state(jspecs, jst)
    tb = tbodies.init_bodies_state(tspecs, tst)
    rng = np.random.default_rng(9)
    # give the bodies some motion so that the rotation paths are exercised
    motion = dict(linvel=rng.normal(0, 0.1, (4, 3)), angvel=rng.normal(0, 0.5, (4, 3)))
    d = {k: np.asarray(v, np.float32) for k, v in motion.items()}
    jb = jb.replace(**{k: jnp.asarray(v) for k, v in d.items()})
    tb = tb.replace(**{k: torch.as_tensor(v) for k, v in d.items()})
    dvdt = rng.normal(0, 50, (jst.capacity, 3)).astype(np.float32)

    def close(got, want, what):
        for k, v in bodies_to_numpy(got).items():
            np.testing.assert_allclose(v, np.asarray(getattr(want, k)), rtol=RTOL,
                                       atol=RTOL * max(np.abs(v).max(), 1.0),
                                       err_msg=f"{what}.{k}")

    jb = jbodies.reduce_body_forces(jspecs, jst, jnp.asarray(dvdt), jb)
    tb = tbodies.reduce_body_forces(tspecs, tst, torch.as_tensor(dvdt), tb)
    close(tb, jb, "reduce_body_forces")
    assert np.abs(bodies_to_numpy(tb)["force"][1:]).min() > 0

    dt = np.float32(1e-3)
    jb = jbodies.step_bodies(jspecs, jb, (0.0, 0.0, -9.81), jnp.float32(0.02), jnp.float32(dt))
    tb = tbodies.step_bodies(tspecs, tb, (0.0, 0.0, -9.81), torch.tensor(0.02),
                             torch.tensor(dt))
    close(tb, jb, "step_bodies")

    jnew = jbodies.apply_body_motion(jspecs, jst, jb, jnp.float32(dt))
    tnew = tbodies.apply_body_motion(tspecs, tst, tb, torch.tensor(dt))
    for k in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tnew, k).numpy(), np.asarray(getattr(jnew, k)),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    # converters round-trip
    back = bodies_to_numpy(bodies_from_numpy(bodies_to_numpy(tb)))
    for k, v in bodies_to_numpy(tb).items():
        np.testing.assert_array_equal(back[k], v)


def test_one_chunk_matches(dambreak):
    """One chunk (rebuild + 10 predictor/corrector steps with body feedback)
    of the port on the CPU against the JAX chunk through its Pallas kernel
    path (``use_pallas=True``, interpret mode), so that both use the same
    plan and pair set.  Tolerances: pos 1e-6 m, vel 1e-5 m/s, rho 1e-6,
    dt rtol 1e-5 — the per-particle pair sums differ in summation order
    (~1e-7 relative) and 20 forces passes carry that into the state."""
    jp, jgrid, jst, tp, tgrid, _ = dambreak
    jfw, tfw = jp.fw.finalize(), tp.fw.finalize()
    tst = state_from_numpy(jst)
    jb = jbodies.init_bodies_state(jp.body_specs(), jst)
    tb = tbodies.init_bodies_state(tp.body_specs(), tst)
    dt0 = np.float32(0.1 * jfw.sp.slength / 20.0)

    jchunk = jmake_sim_chunk(jfw, jgrid, use_pallas=True, bodies_specs=jp.body_specs())
    jout = jchunk(jst, jnp.float32(dt0), jnp.float32(0.0), jnp.int32(0), jb)
    tchunk = make_sim_chunk(tfw, tgrid, bodies_specs=tp.body_specs())
    tout = tchunk(tst, torch.tensor(dt0), torch.tensor(0.0, dtype=torch.float32), 0, tb)

    js, ts = jout[0], tout[0]
    np.testing.assert_array_equal(ts.id.numpy().view(np.uint32), np.asarray(js.id))
    for k, atol in (("pos", 1e-6), ("vel", 1e-5), ("rho", 1e-6)):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   rtol=0, atol=atol, err_msg=k)
    assert np.abs(ts.vel.numpy()).max() > 0.05  # the column has started to fall
    np.testing.assert_allclose(float(tout[1]), float(jout[1]), rtol=1e-5)
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=1e-5)
    assert tout[3] == int(jout[3]) == 10
    close = dict(rtol=1e-5, atol=1e-5)
    for k, v in bodies_to_numpy(tout[4]).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jout[4], k)), err_msg=k, **close)
    jstats, tstats = jout[5], tout[5]
    for k in ("max_occupancy", "n_active", "max_run"):
        assert int(getattr(tstats, k)) == int(getattr(jstats, k)), k
    np.testing.assert_allclose(float(tstats.max_accel), float(jstats.max_accel), rtol=1e-4)
