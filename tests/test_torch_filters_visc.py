"""Port vs JAX package: the density filters and the viscosity engine.

Scenes: the random scene of ``tests/test_forces.py`` (``make_random_scene``,
200 fluid and 80 boundary particles scattered in a 0.3 m box, dp 0.02),
with its cells built by each package from the same numpy arrays.  Outputs
are compared by particle id.

* ``shepard_filter`` and ``mls_filter`` under DYN boundaries (boundary
  particles are neighbors) and under LJ (they are not).  The random scene
  holds isolated and near-planar neighborhoods, so MLS takes both branches
  of the JAX package's regularisation (|det| < 1e-7 for 22 of the 200 fluid
  particles under DYN and 33 under LJ).  Tolerance on the physical
  density: Shepard rtol 1e-5 (the sums are taken in another order); MLS
  rtol 5e-5, since its density is weighted by the solution of a 4x4
  system whose rounding the near-singular neighborhoods magnify: the JAX
  package's own jitted and eager results differ by 1.2e-5 at one of them.
* ``shear_rate_tensor``, ``sps_stress`` and ``effective_viscosity`` for
  every rheology but the granular one (its effective pressure comes from
  the Jacobi solver, which is not ported): rtol 1e-5, atol 1e-6 x
  max|value|.  The JAX package's shear-rate pass runs once; its SPS and
  effective-viscosity functions reuse its output.  The parameters put particles in both branches of the
  Papanastasiou regularisation (isolated particles have a zero shear rate)
  and under the limiting viscosity.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpusph_tpu import (BoundaryType as JBoundary, Fluid as JFluid, PhysParams as JPhysParams,
                        RheologyType as JRheology, SimParams as JSimParams,
                        setup_framework as jsetup)
from gpusph_tpu.defs import FilterType as JFilter
from gpusph_tpu.ops import filters as jfilters
from gpusph_tpu.ops import visc as jvisc
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.ops.neighbors import make_grid as jmake_grid

from gpusph_tpu_torch import (BoundaryType, Fluid, PhysParams, RheologyType, SimParams,
                              setup_framework)
from gpusph_tpu_torch.defs import FilterType
from gpusph_tpu_torch.convert import state_from_numpy
from gpusph_tpu_torch.ops import eos, filters, visc
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid
from gpusph_tpu_torch.state import fluid_num

from test_forces import DP, make_random_scene
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

BOX = (0.3, 0.3, 0.3)
K = 32  # the scenes hold at most a few particles per cell


def _frameworks(boundary, rheology=RheologyType.INVISCID, fluid=None, **pp):
    """The same configuration in both packages."""
    fluid = dict(rho0=1000.0, gamma=7.0, c0=30.0, **(fluid or {}))
    out = []
    for setup, B, R, F, PP, SP, Fl in (
            (jsetup, JBoundary, JRheology, JFilter, JPhysParams, JSimParams, JFluid),
            (setup_framework, BoundaryType, RheologyType, FilterType, PhysParams, SimParams,
             Fluid)):
        out.append(setup(
            boundary=B(int(boundary)), rheology=R(int(rheology)),
            filters=((F.SHEPARD, 1), (F.MLS, 1)),
            simparams=SP(deltap=DP, max_parts_per_cell=K),
            physparams=PP(fluids=(Fl(**fluid),), gravity=(0.0, 0.0, -9.81), **pp),
        ).finalize())
    return out


def _scenes(seed, jfw, tfw):
    """The random scene of ``seed``, sorted into its cells by each package."""
    st, _ = make_random_scene(np.random.default_rng(seed))
    jgrid = jmake_grid((0, 0, 0), BOX, jfw.influenceradius)
    tgrid = make_grid((0, 0, 0), BOX, tfw.influenceradius)
    ts, taux = build_cells(tgrid, state_from_numpy(st))
    assert int(taux.max_occupancy) <= K
    return (jgrid, *jbuild_cells(jgrid, st)), (tgrid, ts, taux)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _by_id(state, values):
    """``values`` [N, ...] of the active rows of a sorted state of either
    package, ordered by particle id."""
    act = _np(state.active)
    ids = _np(state.id).view(np.uint32)[act]
    return _np(values)[act][np.argsort(ids)]


def _phys(fw, state, rho):
    """Physical density of the relative density ``rho`` of ``state``'s rows."""
    info = torch.as_tensor(np.array(_np(state.info)).view(np.int32))
    rho = torch.as_tensor(np.array(_np(rho)))
    return eos.physical_density(fw.pp, rho, fluid_num(info)).numpy()


@pytest.mark.parametrize("boundary", [BoundaryType.DYN_BOUNDARY, BoundaryType.LJ_BOUNDARY],
                         ids=["dyn", "lj"])
def test_filters_match(boundary):
    jfw, tfw = _frameworks(boundary)
    (jgrid, js, jaux), (tgrid, ts, taux) = _scenes(3, jfw, tfw)
    np.testing.assert_array_equal(_by_id(ts, _np(ts.id).view(np.uint32)),
                                  _by_id(js, _np(js.id).view(np.uint32)))
    fluid = _by_id(ts, (_np(ts.info) & 7) == 0)
    before = _by_id(ts, _phys(tfw, ts, ts.rho))
    for name, rtol in (("shepard_filter", 1e-5), ("mls_filter", 5e-5)):
        jfn = jax.jit(lambda s_, a_, fn=getattr(jfilters, name): fn(jfw, jgrid, s_, a_).rho)
        want = _by_id(js, _phys(tfw, js, jfn(js, jaux)))
        got = _by_id(ts, _phys(tfw, ts, getattr(filters, name)(tfw, tgrid, ts, taux).rho))
        assert np.abs(want - before)[fluid].max() > 1.0, name  # the filter acts
        np.testing.assert_array_equal(got[~fluid], before[~fluid], err_msg=name)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=name)

    # the cadence: filter f runs at global iteration it when it % f == f - 1
    fw = dataclasses.replace(tfw, filters=((FilterType.SHEPARD, 20), (FilterType.MLS, 10)))
    due = {it: [f.__name__ for f in filters.filters_due(fw, it)] for it in (0, 9, 19, 39, 41)}
    assert due == {0: [], 9: ["mls_filter"], 19: ["shepard_filter", "mls_filter"],
                   39: ["shepard_filter", "mls_filter"], 41: []}


RHEOLOGIES = [r for r in RheologyType if r not in (RheologyType.INVISCID, RheologyType.GRANULAR)]


def test_viscosity_engine_matches(monkeypatch):
    fluid = dict(kinematic_visc=1e-3, yield_strength=2.0, visc_nonlinear_param=0.6,
                 visc_regularization_param=100.0)
    jfw, tfw = _frameworks(BoundaryType.DYN_BOUNDARY, RheologyType.NEWTONIAN, fluid,
                           limiting_kinvisc=5e-3)
    (jgrid, js, jaux), (tgrid, ts, taux) = _scenes(4, jfw, tfw)

    def close(got, want, what):
        want = _by_id(js, want)
        np.testing.assert_allclose(_by_id(ts, got), want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=what)

    tau = visc.shear_rate_tensor(tfw, tgrid, ts, taux)
    assert tau.shape == (ts.capacity, 6)
    shrate = np.sqrt(visc.shear_rate_norm2(tau).numpy())
    act = ts.active.numpy()
    assert (shrate[act] == 0).any() and (shrate[act] > 10).any()
    # the JAX package's shear-rate pass, once: its later callers reuse it
    jshear = jax.jit(lambda s_, a_: jvisc.shear_rate_tensor(jfw, jgrid, s_, a_))(js, jaux)
    close(tau.numpy(), jshear, "shear rate")
    monkeypatch.setattr(jvisc, "shear_rate_tensor", lambda *a, **k: jshear)
    jtau, jnu = jax.jit(lambda s_, a_: jvisc.sps_stress(jfw, jgrid, s_, a_))(js, jaux)
    ttau, tnu = visc.sps_stress(tfw, tgrid, ts, taux)
    close(ttau.numpy(), jtau, "sps tau")
    close(tnu.numpy(), jnu, "sps nu")

    rho = _phys(tfw, ts, ts.rho)
    for rt in RHEOLOGIES:
        fws = [dataclasses.replace(fw, visc=dataclasses.replace(fw.visc, rheologytype=R(int(rt))))
               for fw, R in ((jfw, JRheology), (tfw, RheologyType))]
        got = visc.effective_viscosity(fws[1], tgrid, ts, taux).numpy()
        want = jax.jit(lambda s_, a_, fw_=fws[0]: jvisc.effective_viscosity(
            fw_, jgrid, s_, a_))(js, jaux)
        close(got, want, rt.name)
        if rt == RheologyType.POWER_LAW:
            # slow particles reach the limiting (dynamic) viscosity 5e-3 x rho0
            assert np.isclose(got * rho, 5.0, rtol=1e-5)[act].any()
