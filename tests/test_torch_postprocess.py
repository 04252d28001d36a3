"""Port vs JAX package: the cell-pair combinator and the write-time
post-process passes.

* ``neighbor_apply``: six random scenes made as those of
  ``tests/test_forces_pallas.py`` (``make_random_scene``, 150 fluid and 60
  boundary particles, seeds 0-5) and one scene periodic in Y and Z, with
  one sum key and one ``min_`` key.
* ``vorticity``, ``testpoint_values``, ``surface_detection`` and
  ``make_write_postprocess`` as a whole, on DamBreak3D at dp 0.06 with two
  more test points inside the water column, positions jittered by 0.05 dp
  and velocities perturbed from a numpy seed.  The jitter keeps the
  interior normals above the f32 noise of their cancelling sums, so the
  normalized normals of both packages point the same way.

Tolerance: rtol 1e-5, atol 1e-6 x max|value| (the pair sums are taken in
another order); the surface flags in ``Info`` exactly.  A unit normal is a
sum of terms that nearly cancel inside the fluid, so its rounding error is
f32 epsilon times its condition number, sum|terms| / |sum terms|: about 16
of the 2,652 particles have condition numbers of 20 to 45 and normals that
differ by up to 2.2e-5.  Each normal is held to the larger of the stated
tolerance and 4 x 2^-24 x its condition number.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.defs import Periodicity as JPeriodicity
from gpusph_tpu.defs import PostProcessType as JPP
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.ops.neighbors import make_grid as jmake_grid
from gpusph_tpu.ops.pair import neighbor_apply as jneighbor_apply
from gpusph_tpu.ops.postprocess import make_write_postprocess as jmake_post
from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch.convert import state_from_numpy
from gpusph_tpu_torch.defs import Periodicity, PostProcessType
from gpusph_tpu_torch.ops import postprocess as tpost
from gpusph_tpu_torch.ops.kernels import F as kernF
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid
from gpusph_tpu_torch.ops.pair import merge_vec, neighbor_apply
from gpusph_tpu_torch.problems.base import get_problem

from test_forces import DP, make_random_scene
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

RTOL = 1e-5
ATOL_FRAC = 1e-6
BOX = (0.3, 0.3, 0.3)
INFLUENCE = 2.0 * 1.3 * DP  # Wendland radius 2h at the scenes' dp
K = 32


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_FRAC * float(np.abs(want).max()), err_msg=what)


def _scene(seed, periodic):
    st, _ = make_random_scene(np.random.default_rng(seed), n_fluid=150, n_bound=60)
    if periodic:
        # spread the particles over the whole box and across the Y/Z walls,
        # so that pairs reach through the periodic faces
        rng = np.random.default_rng(100 + seed)
        pos = np.asarray(st.pos).copy()
        n = 210
        pos[:n] = rng.uniform(0.0, BOX[0], size=(n, 3)).astype(np.float32)
        st = st.replace(pos=jnp.asarray(pos))
    return st


def _pair_fn(xp_where, inf):
    def pair_fn(c, n, g):
        w = (1.0 - g.r / INFLUENCE) ** 2 * n["mass"] * (n["vel_x"] - c["vel_y"])
        return {"s": xp_where(g.mask, w, 0.0),
                "min_r": xp_where(g.mask, g.r + 0.5 * n["vel_z"] * n["vel_z"], inf)}
    return pair_fn


@pytest.mark.parametrize("seed,periodic", [(s, False) for s in range(6)] + [(0, True)],
                         ids=[f"scene{s}" for s in range(6)] + ["periodic_yz"])
def test_neighbor_apply_matches(seed, periodic):
    st = _scene(seed, periodic)
    per = (JPeriodicity.Y | JPeriodicity.Z) if periodic else JPeriodicity.NONE
    jgrid = jmake_grid((0, 0, 0), BOX, INFLUENCE, periodic=per)
    tgrid = make_grid((0, 0, 0), BOX, INFLUENCE, periodic=Periodicity(int(per)))
    assert tgrid == dataclasses.replace(tgrid, **{f.name: getattr(jgrid, f.name)
                                                  for f in dataclasses.fields(jgrid)})
    js, jaux = jbuild_cells(jgrid, st)
    ts, taux = build_cells(tgrid, state_from_numpy(st))

    def fields(s, split):
        return dict(**split("pos", s.pos), **split("vel", s.vel), mass=s.mass)

    def jsplit(name, v):
        return {f"{name}_{a}": v[:, i] for i, a in enumerate("xyz")}

    kw = dict(max_parts_per_cell=K, influenceradius=INFLUENCE)
    want = jax.jit(lambda s, a: jneighbor_apply(
        jgrid, a, fields(s, jsplit), _pair_fn(jnp.where, jnp.inf), **kw))(js, jaux)
    got = neighbor_apply(tgrid, taux, fields(ts, jsplit), _pair_fn(torch.where, torch.inf),
                         **kw)
    assert int(taux.max_occupancy) <= K
    act = ts.active.numpy()
    assert np.isfinite(got["min_r"].numpy()[act]).sum() > 150  # most have neighbors
    _close(got["s"].numpy(), want["s"], "sum key")
    want_min = np.asarray(want["min_r"])
    np.testing.assert_array_equal(np.isinf(got["min_r"].numpy()), np.isinf(want_min))
    fin = np.isfinite(want_min)
    _close(got["min_r"].numpy()[fin], want_min[fin], "min key")
    if periodic:
        # some pair crosses a periodic face: its distance is below the
        # plain one (the minimum image is taken)
        p = ts.pos.numpy()
        assert ((p[:, 1] < INFLUENCE) & act).any() and ((p[:, 2] > BOX[2] - INFLUENCE)
                                                        & act).any()


# --- the write-time post-process passes on DamBreak3D -------------------------

EXTRA_TESTPOINTS = ((0.2, 0.335, 0.1), (0.3, 0.2, 0.2))


def _all_passes(m, fw):
    pps = (m.VORTICITY, m.TESTPOINTS, m.SURFACE_DETECTION)
    return dataclasses.replace(fw, postprocess=pps)


@pytest.fixture(scope="module")
def dambreak():
    """Both problems with all three passes, the same jittered state, and the
    JAX pass's output (one jit)."""
    jp = jget_problem("DamBreak3D")({"deltap": 0.06})
    tp = get_problem("DamBreak3D")({"deltap": 0.06})
    for p in (jp, tp):
        for x in EXTRA_TESTPOINTS:
            p.add_testpoint(x)
    jgrid, jst = jp.build()
    tgrid, _ = tp.build()
    jfw = _all_passes(JPP, jp.fw.finalize())
    tfw = _all_passes(PostProcessType, tp.fw.finalize())
    rng = np.random.default_rng(11)
    pos = np.asarray(jst.pos) + rng.uniform(-0.2, 0.2, jst.pos.shape) * 0.06
    vel = rng.normal(0, 0.3, jst.vel.shape)
    jst = jst.replace(pos=jnp.asarray(pos, jnp.float32), vel=jnp.asarray(vel, jnp.float32))
    want = {k: np.asarray(v) for k, v in jmake_post(jfw, jgrid)(jst).items()}
    tst = state_from_numpy(jst)
    return tfw, tgrid, tst, want, _normal_atol(tfw, tgrid, tst)


def _normal_atol(fw, grid, state):
    """Per input row: the rounding bound of the unit normal's components,
    4 x 2^-24 x sum|terms| / |sum terms| of its normal sum."""
    st, aux = build_cells(grid, state)
    h = fw.sp.slength

    def terms(c, n, g):
        coeff = torch.where(g.mask, n["mass"] / n["rho"] * kernF(fw.kerneltype, g.r, h), 0.0)
        parts = {f"n_{a}": coeff * r for a, r in zip("xyz", (g.relx, g.rely, g.relz))}
        return dict(parts, abs=sum(v.abs() for v in parts.values()))

    sums = neighbor_apply(grid, aux, tpost._fields(fw, st), terms,
                          max_parts_per_cell=fw.sp.max_parts_per_cell,
                          influenceradius=fw.sp.influenceradius)
    norm = torch.linalg.vector_norm(merge_vec(sums, "n"), dim=1)
    cond = (sums["abs"] / torch.clamp(norm, min=1e-30)).numpy()
    out = np.empty_like(cond)
    out[st.id.numpy().view(np.uint32)] = 4 * 2.0**-24 * cond
    return out[:, None]


def _close_normals(got, want, atol_rows, what):
    atol = np.maximum(ATOL_FRAC * float(np.abs(want).max()), atol_rows)
    bad = np.abs(got - want) > atol + RTOL * np.abs(want)
    assert not bad.any(), (what, np.argwhere(bad), got[bad], want[bad])


def test_make_write_postprocess_matches(dambreak):
    tfw, tgrid, tst, want, natol = dambreak
    got = tpost.make_write_postprocess(tfw, tgrid)(tst)
    assert sorted(got) == sorted(want)
    for k in ("Vorticity", "TestpointVel", "TestpointPress"):
        _close(got[k].numpy(), want[k], k)
    _close_normals(got["Normals"].numpy(), want["Normals"], natol, "Normals")
    np.testing.assert_array_equal(got["Info"].numpy().view(np.uint32), want["Info"])
    tp = (want["Info"] & 7) == 3
    assert tp.sum() == 5 and np.abs(want["TestpointPress"][tp]).max() > 0
    surf = (want["Info"] & (1 << 9)) != 0
    assert 0 < surf.sum() < (want["Info"] & 7 == 0).sum()


@pytest.mark.parametrize("name", ["vorticity", "testpoint_values", "surface_detection"])
def test_pass_matches(dambreak, name):
    """Each pass on the port's sorted state against the JAX pass's output in
    that order (the ids are the input rows)."""
    tfw, tgrid, tst, want, natol = dambreak
    st, aux = build_cells(tgrid, tst)
    rows = st.id.numpy().view(np.uint32)
    out = getattr(tpost, name)(tfw, tgrid, st, aux)
    if name == "vorticity":
        _close(out.numpy(), want["Vorticity"][rows], name)
    elif name == "testpoint_values":
        vel, press = out
        _close(vel.numpy(), want["TestpointVel"][rows], "vel")
        _close(press.numpy(), want["TestpointPress"][rows], "press")
    else:
        info, normals = out
        np.testing.assert_array_equal(info.numpy().view(np.uint32), want["Info"][rows])
        _close_normals(normals.numpy(), want["Normals"][rows], natol[rows], "normals")
