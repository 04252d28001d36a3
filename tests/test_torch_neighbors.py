"""Port vs JAX package: the cell sort and the forces kernel's block plan.

Both must be exactly equal on the same input: the sort order, the sorted
hashes, the cell starts and every field of the block plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.ops.forces_pallas import build_block_plan as jbuild_block_plan
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.ops.neighbors import make_grid as jmake_grid
from gpusph_tpu.problems.base import get_problem as jget_problem
from gpusph_tpu.state import empty_state as jempty_state

from gpusph_tpu_torch.convert import state_from_numpy
from gpusph_tpu_torch.ops.block_plan import GPT, build_block_plan
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid
from gpusph_tpu_torch.problems.base import get_problem


def random_state(seed, n=600, cap=700, box=(0.5, 0.4, 0.3)):
    """Random particles with some dead and disabled slots (numpy)."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(0, 1, (cap, 3)) * np.asarray(box)).astype(np.float32)
    info = np.full(cap, 4, np.uint32)  # ParticleType.NONE
    info[:n] = rng.integers(0, 2, n).astype(np.uint32)
    info[rng.choice(n, 20, replace=False)] |= np.uint32(1 << 11)  # FG_INACTIVE
    return dict(pos=pos, vel=np.zeros((cap, 3), np.float32),
                rho=np.zeros(cap, np.float32), mass=np.ones(cap, np.float32),
                info=info, id=np.arange(cap, dtype=np.uint32))


def jax_state(d):
    st = jempty_state(len(d["pos"]))
    return st.replace(**{k: jnp.asarray(d[k]) for k in
                         ("pos", "vel", "rho", "mass", "info", "id")})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("periodic", [0, 6])  # none, Y|Z
def test_build_cells_exact(seed, periodic):
    d = random_state(seed)
    jgrid = jmake_grid((0, 0, 0), (0.5, 0.4, 0.3), 0.052, periodic=periodic)
    tgrid = make_grid((0, 0, 0), (0.5, 0.4, 0.3), 0.052, periodic=periodic)
    assert tgrid.ncells == jgrid.ncells and tgrid.order == jgrid.order
    js, jaux = jbuild_cells(jgrid, jax_state(d))
    ts, taux = build_cells(tgrid, state_from_numpy(d))
    np.testing.assert_array_equal(ts.id.numpy().view(np.uint32), np.asarray(js.id))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    for k in ("hash_sorted", "cell_start", "cell_count"):
        np.testing.assert_array_equal(getattr(taux, k).numpy(),
                                      np.asarray(getattr(jaux, k)), err_msg=k)
    assert int(taux.max_occupancy) == int(jaux.max_occupancy)
    assert int(taux.n_active) == int(jaux.n_active)


def _dambreak(deltap, **opts):
    jp = jget_problem("DamBreak3D")(dict(deltap=deltap, **opts))
    jgrid, jst = jp.build()
    tp = get_problem("DamBreak3D")(dict(deltap=deltap, **opts))
    tgrid, _ = tp.build()
    return jp.fw.finalize(), jgrid, jst, tp.fw.finalize(), tgrid


def _plans(jfw, jgrid, jst, tfw, tgrid):
    js, jaux = jbuild_cells(jgrid, jst)
    ts, taux = build_cells(tgrid, state_from_numpy(jst))
    return (jbuild_block_plan(jfw, jgrid, js, jaux),
            build_block_plan(tfw, tgrid, ts, taux))


def _assert_plans_equal(jplan, tplan):
    for k in ("flat_groups", "tile_block", "cen_idx", "slot_of_sorted", "max_run"):
        got = getattr(tplan, k)
        assert got.dtype == torch.int32, k
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jplan, k)),
                                      err_msg=k)


def _assert_tile_off_matches(tplan):
    """tile_off[b] .. tile_off[b+1] are exactly the tiles whose tile_block is b."""
    tb = tplan.tile_block.numpy()
    off = tplan.tile_off.numpy()
    nb = tplan.n_blocks
    assert off[0] == 0 and np.all(np.diff(off) >= 0)
    t_used = off[-1]
    np.testing.assert_array_equal(tb[:t_used],
                                  np.repeat(np.arange(nb), np.diff(off)))
    assert np.all(tb[t_used:] == nb)
    assert tplan.flat_groups.shape[0] == tb.shape[0] * GPT


@pytest.mark.parametrize("moved", [False, True])
def test_block_plan_exact_dambreak(moved):
    """DamBreak3D at dp 0.06, as built and with the fluid jostled (so that
    blocks, runs and the AABB cull see a disordered layout)."""
    jfw, jgrid, jst, tfw, tgrid = _dambreak(0.06)
    if moved:
        rng = np.random.default_rng(5)
        pos = np.asarray(jst.pos)
        fluid = (np.asarray(jst.info) & 7) == 0
        pos = pos + fluid[:, None] * rng.normal(0, 0.01, pos.shape).astype(np.float32)
        jst = jst.replace(pos=jnp.asarray(np.clip(pos, 0.0, 0.59)))
    jplan, tplan = _plans(jfw, jgrid, jst, tfw, tgrid)
    _assert_plans_equal(jplan, tplan)
    _assert_tile_off_matches(tplan)
    assert int(tplan.max_run) < 1_000_000


def test_block_plan_exact_random_periodic():
    """Random scene, periodic on the slow axes, with dead/disabled slots."""
    from gpusph_tpu import BoundaryType, SimParams, setup_framework
    from gpusph_tpu_torch import BoundaryType as TB, SimParams as TSP
    from gpusph_tpu_torch import setup_framework as tsetup

    d = random_state(3, n=1500, cap=1600)
    kw = dict(periodicity=6)
    jfw = setup_framework(boundary=BoundaryType.DYN_BOUNDARY,
                          simparams=SimParams(deltap=0.02, max_parts_per_cell=48),
                          **kw).finalize()
    tfw = tsetup(boundary=TB.DYN_BOUNDARY,
                 simparams=TSP(deltap=0.02, max_parts_per_cell=48), **kw).finalize()
    jgrid = jmake_grid((0, 0, 0), (0.5, 0.4, 0.3), jfw.influenceradius, periodic=6)
    tgrid = make_grid((0, 0, 0), (0.5, 0.4, 0.3), tfw.influenceradius, periodic=6)
    jplan, tplan = _plans(jfw, jgrid, jax_state(d), tfw, tgrid)
    _assert_plans_equal(jplan, tplan)
    _assert_tile_off_matches(tplan)


def test_block_plan_overflow_flags_and_clamps():
    """A flat tile list too small for the layout: both packages flag the
    overflow in max_run; the port clamps tile_off to the list it has."""
    jfw, jgrid, jst, tfw, tgrid = _dambreak(0.06)
    import dataclasses

    jfw = dataclasses.replace(jfw, simparams=dataclasses.replace(jfw.sp, max_flat_tiles=64))
    tfw = dataclasses.replace(tfw, simparams=dataclasses.replace(tfw.sp, max_flat_tiles=64))
    jplan, tplan = _plans(jfw, jgrid, jst, tfw, tgrid)
    _assert_plans_equal(jplan, tplan)
    assert int(tplan.max_run) >= 1_000_000
    assert int(tplan.tile_off[-1]) == tplan.tile_block.shape[0] == 64
