"""Port vs JAX package: repacking on DamBreak3D at dp 0.06 (2,650
particles), on the CPU.

* ``repack_forces`` on the built (sorted) state: rtol 1e-5, atol 1e-6 x
  max|DvDt| (the pair sums are taken in another order).
* One repack chunk (a rebuild and 10 pseudo-dynamic steps) against the JAX
  ``make_repack_chunk`` (the one jitted chunk of the port's tests): positions
  within 1e-6 m, velocities within 1e-5 x max|vel|, the kinetic energy at
  rtol 1e-5.  The f32 differences of the sums grow over the 10 steps.
* ``finish_repacking`` deactivates surface-flagged boundary particles and
  zeroes velocities, as the JAX function does; ``run_repacking`` through
  the CLI's ``--repack-only`` writes ``repack.npz``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu import repacking as jrepack
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch import cli, repacking
from gpusph_tpu_torch.convert import state_from_numpy, state_to_numpy
from gpusph_tpu_torch.io.hotfile import load_hotfile
from gpusph_tpu_torch.ops.neighbors import build_cells
from gpusph_tpu_torch.problems.base import get_problem
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

DELTAP = 0.06


@pytest.fixture(scope="module")
def dambreak():
    jp = jget_problem("DamBreak3D")({"deltap": DELTAP})
    jgrid, jst = jp.build()
    tp = get_problem("DamBreak3D")({"deltap": DELTAP})
    tgrid, _ = tp.build()
    return jp.fw.finalize(), jgrid, jst, tp.fw.finalize(), tgrid


def test_repack_forces_match(dambreak):
    jfw, jgrid, jst, tfw, tgrid = dambreak
    js, jaux = jbuild_cells(jgrid, jst)
    ts, taux = build_cells(tgrid, state_from_numpy(jst))
    want = np.asarray(jax.jit(lambda s, a: jrepack.repack_forces(jfw, jgrid, s, a))(js, jaux))
    got = repacking.repack_forces(tfw, tgrid, ts, taux).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_repack_chunk_matches(dambreak):
    jfw, jgrid, jst, tfw, tgrid = dambreak
    got, tekin = repacking.make_repack_chunk(tfw, tgrid, 10)(state_from_numpy(jst))
    # the JAX chunk donates its input: give it a copy
    want, jekin = jrepack.make_repack_chunk(jfw, jgrid, 10)(jax.tree.map(jnp.copy, jst))
    g = state_to_numpy(got)
    np.testing.assert_array_equal(g["id"], np.asarray(want.id))
    np.testing.assert_allclose(g["pos"], np.asarray(want.pos), rtol=0, atol=1e-6)
    wvel = np.asarray(want.vel)
    assert np.abs(wvel).max() > 0.01
    np.testing.assert_allclose(g["vel"], wvel, rtol=0, atol=1e-5 * np.abs(wvel).max())
    np.testing.assert_allclose(float(tekin), float(jekin), rtol=1e-5)


def test_finish_repacking_matches(dambreak):
    """Surface-flagged boundary particles go inactive, fluid ones stay."""
    jfw, jgrid, jst, _, _ = dambreak
    rng = np.random.default_rng(5)
    info = np.asarray(jst.info).copy()
    flag = rng.random(len(info)) < 0.3
    info[flag] |= np.uint32(1 << 9)  # FG_SURFACE
    jst = jst.replace(info=jnp.asarray(info))
    want = jrepack.finish_repacking(jst)
    got = state_to_numpy(repacking.finish_repacking(state_from_numpy(jst)))
    np.testing.assert_array_equal(got["info"], np.asarray(want.info))
    assert not got["vel"].any()
    inactive = (got["info"] & (1 << 11)) != 0
    assert 0 < inactive.sum() < flag.sum()


def test_cli_repack_only(tmp_path):
    """``--repack-only`` runs the repacking loop (depth cut by the
    problem option ``repack_maxiter``) and writes ``repack.npz``."""
    out = tmp_path / "repack"
    assert cli.main(["DamBreak3D", "--deltap", "0.1", "--repack-only",
                     "--repack_maxiter", "10", "--device", "cpu",
                     "--dir", str(out)]) == 0
    st, header, _ = load_hotfile(str(out / "repack.npz"))
    assert (header["t"], header["dt"], header["iterations"]) == (0.0, 0.0, 0)
    assert torch.isfinite(st.pos).all() and not st.vel.any()
    assert sorted(p.name for p in out.iterdir()) == ["repack.npz"]
