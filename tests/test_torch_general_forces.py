"""Port vs JAX package: the general forces pass (``ops/forces.py``).

The port's ``compute_forces`` on the CPU against the JAX ``compute_forces``
(its XLA pair path) on the seeded random scenes of
``tests/test_forces_pallas.py``, one case per branch of the pass: the six
configurations of that file, then the formulations (F2, Hu & Adams,
Grenier with the pseudo surface tension), the viscous models and averages,
SPS, the repulsive boundaries, every density diffusion (Colagrossi on one
and two fluids, Ferrari, Brezzi with its dt), moving-body feedback rows,
planes, a gravity callback at a time t and a grid periodic along its fast
axis.  Both packages take the same numpy inputs and sum the same pair set in
the same slot layout, in another order: DrDt, DvDt, XSPH and DEDt are held
at rtol 1e-4 and atol 1e-6 x max|.|.  The same pass is also held against the
brute-force float64 sums of ``tests/reference_sph.py`` at that file's
tolerances (``tests/test_forces.py:28``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusph_tpu as J
import gpusph_tpu.defs  # noqa: F401  (J.defs)
from gpusph_tpu.ops.forces import compute_forces as jcompute_forces
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.ops.neighbors import make_grid as jmake_grid

import gpusph_tpu_torch as T
import gpusph_tpu_torch.defs  # noqa: F401  (T.defs)
from gpusph_tpu_torch.convert import state_from_numpy
from gpusph_tpu_torch.ops.forces import compute_forces
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid

from reference_sph import brute_forces
from test_forces import DP, make_random_scene
from test_grenier import make_two_fluid_scene
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

RTOL = 1e-4
ATOL_FRAC = 1e-6
BOX = 0.3
SEED = 1234

# one case per branch: framework options (names of each package's enums),
# plus what the scene and the call take
CASES = {
    # the six configurations of tests/test_forces_pallas.py
    "dyn_artvisc": dict(),
    "lj": dict(boundary="LJ_BOUNDARY"),
    "laminar": dict(turb="LAMINAR_FLOW", kinvisc=1e-4),
    "colagrossi": dict(diffusion="COLAGROSSI", xi=0.1),
    "xsph": dict(flags="ENABLE_XSPH"),
    "internal_energy": dict(flags="ENABLE_INTERNAL_ENERGY", turb="LAMINAR_FLOW",
                            kinvisc=1e-4),
    # the formulations
    "f2_ferrari": dict(formulation="SPH_F2", diffusion="FERRARI", xi=0.1),
    "ha_colagrossi_two_fluids": dict(formulation="SPH_HA", diffusion="COLAGROSSI", xi=0.1,
                                     turb="LAMINAR_FLOW", kinvisc=1e-4, two_fluids=True),
    "ha_ferrari_two_fluids": dict(formulation="SPH_HA", diffusion="FERRARI", xi=0.1,
                                  two_fluids=True),
    "ha_brezzi": dict(formulation="SPH_HA", diffusion="BREZZI", xi=0.1, dt=1e-4),
    "grenier_epsinterface": dict(formulation="SPH_GRENIER", diffusion="COLAGROSSI", xi=0.1,
                                 turb="LAMINAR_FLOW", kinvisc=1e-4, two_fluids=True,
                                 epsinterface=0.08),
    "grenier_espanol_revenga": dict(formulation="SPH_GRENIER", turb="LAMINAR_FLOW",
                                    kinvisc=1e-4, visc_model="ESPANOL_REVENGA",
                                    bulk_visc=0.05, two_fluids=True),
    # the viscous models and averages
    "monaghan": dict(turb="LAMINAR_FLOW", kinvisc=1e-4, visc_model="MONAGHAN"),
    "espanol_revenga_harmonic": dict(turb="LAMINAR_FLOW", kinvisc=1e-4,
                                     visc_model="ESPANOL_REVENGA", bulk_visc=0.05,
                                     avg="HARMONIC"),
    "morris_geometric_effvisc": dict(turb="LAMINAR_FLOW", kinvisc=1e-4, avg="GEOMETRIC",
                                     effvisc=True),
    "sps": dict(boundary="LJ_BOUNDARY", turb="SPS", kinvisc=5e-6, sps=True),
    # Monaghan-Kajtar: K = g H, d = dp, beta = h/d (the reference's defaults)
    "mk": dict(boundary="MK_BOUNDARY", pp=dict(mk_k=9.81 * 0.3, mk_d=DP, mk_beta=1.3)),
    # the density diffusions outside the kernel
    "colagrossi_two_fluids": dict(diffusion="COLAGROSSI", xi=0.1, two_fluids=True),
    "brezzi": dict(diffusion="BREZZI", xi=0.1, dt=1e-4),
    # rows and terms of the finalize and the step
    "moving_feedback": dict(moving=True),
    "planes": dict(planes=True, turb="LAMINAR_FLOW", kinvisc=1e-4),
    "gcallback": dict(gcallback=True, diffusion="COLAGROSSI", xi=0.1),
    "periodic_fast_axis": dict(periodic="XYZ", turb="LAMINAR_FLOW", kinvisc=1e-4),
    # the DEM terrain's force after the planes
    "dem": dict(dem=True, turb="LAMINAR_FLOW", kinvisc=1e-4),
}

PLANES = (((0.0, 0.0, 0.02), (0.0, 0.0, 1.0)), ((0.28, 0.0, 0.0), (-1.0, 0.0, 1.0)))


def _terrain():
    """A seeded terrain under the scene's lower layers (0.01-0.06 m), packed
    alike by both packages."""
    from gpusph_tpu_torch.ops.dem import pack_dem

    rng = np.random.default_rng(SEED + 2)
    h = 0.01 + 0.05 * rng.uniform(size=(8, 9))
    return pack_dem(h, 0.0, 0.0, BOX / 8, BOX / 7)
T_CALLBACK = 0.7


def _gcallback(m):
    """The same variable gravity in either package: g_x = 2 sin(9.8 (t - 0.3))."""
    if m is J:
        return lambda t: (2.0 * jnp.sin(9.8 * (t - 0.3)), jnp.zeros_like(t),
                          jnp.full_like(t, -9.81))
    return lambda t: (2.0 * torch.sin(9.8 * (t - 0.3)), torch.zeros_like(t),
                      torch.full_like(t, -9.81))


def framework(m, *, boundary="DYN_BOUNDARY", turb="ARTIFICIAL", kinvisc=0.0,
              diffusion="NONE", xi=0.0, flags=None, formulation="SPH_F1",
              visc_model="MORRIS", avg="ARITHMETIC", bulk_visc=0.0, two_fluids=False,
              epsinterface=0.0, moving=False, planes=False, gcallback=False,
              periodic="NONE", pp=None, dem=False, **_):
    """A framework of package ``m`` (``gpusph_tpu`` or ``gpusph_tpu_torch``)."""
    E = m.defs
    f = E.SimFlags.ENABLE_DTADAPT
    if flags is not None:
        f |= getattr(E.SimFlags, flags)
    if two_fluids:
        f |= E.SimFlags.ENABLE_MULTIFLUID
    if moving:
        f |= E.SimFlags.ENABLE_MOVING_BODIES
    if planes:
        f |= E.SimFlags.ENABLE_PLANES
    if dem:
        f |= E.SimFlags.ENABLE_DEM
    rhos = (1000.0, 1100.0) if two_fluids else (1000.0,)
    c0 = 25.0 if two_fluids else 30.0
    fw = m.setup_framework(
        boundary=getattr(E.BoundaryType, boundary),
        formulation=getattr(E.SPHFormulation, formulation),
        turbulence_model=getattr(E.TurbulenceModel, turb),
        rheology=E.RheologyType.NEWTONIAN if kinvisc > 0 else E.RheologyType.INVISCID,
        visc_model=getattr(E.ViscousModel, visc_model),
        visc_average=getattr(E.AverageOperator, avg),
        density_diffusion=getattr(E.DensityDiffusionType, diffusion),
        periodicity=getattr(E.Periodicity, periodic),
        flags=f,
        simparams=m.SimParams(deltap=DP, max_parts_per_cell=32 if not two_fluids else 48,
                              densityDiffCoeff=xi if xi else float("nan")),
        physparams=m.PhysParams(
            fluids=tuple(m.Fluid(rho0=r, gamma=7.0, c0=c0, kinematic_visc=kinvisc,
                                 bulk_visc=bulk_visc) for r in rhos),
            gravity=(0.0, 0.0, -9.81), dcoeff=50.0, epsinterface=epsinterface,
            **(pp or {})),
    )
    fw = dataclasses.replace(fw, planes=PLANES if planes else (),
                             gcallback=_gcallback(m) if gcallback else None,
                             dem=_terrain() if dem else None)
    return fw.finalize()


def scene(case):
    """The seeded scene of a case (a JAX package state) and its particle
    types (0 fluid, 1 boundary, 4 unused)."""
    rng = np.random.default_rng(SEED)
    if case.get("two_fluids"):
        st, ptype, _ = make_two_fluid_scene(rng)
        # a perturbed density: the density pass of a Grenier run refreshes it
        rho = np.zeros(st.capacity, np.float32)
        n = int((ptype <= 1).sum())
        rho[:n] = rng.uniform(-0.005, 0.01, size=n)
        st = st.replace(rho=jnp.asarray(rho))
    else:
        st, ptype = make_random_scene(rng, n_fluid=150, n_bound=60)
    if case.get("moving"):
        # half of the boundary particles form body 1, which takes feedback
        from gpusph_tpu_torch.state import FG_COMPUTE_FORCE, FG_MOVING_BOUNDARY

        info = np.asarray(st.info).copy()
        info[np.flatnonzero(ptype == 1)[::2]] |= np.uint32(
            FG_MOVING_BOUNDARY | FG_COMPUTE_FORCE | (1 << 16))
        st = st.replace(info=jnp.asarray(info))
    return st, ptype


def _sorted(case, jfw, tfw):
    st, _ = scene(case)
    per = case.get("periodic", "NONE")
    jgrid = jmake_grid((0, 0, 0), (BOX,) * 3, jfw.influenceradius,
                       periodic=getattr(J.defs.Periodicity, per))
    tgrid = make_grid((0, 0, 0), (BOX,) * 3, tfw.influenceradius,
                      periodic=getattr(T.defs.Periodicity, per))
    js, jaux = jbuild_cells(jgrid, st)
    ts, taux = build_cells(tgrid, state_from_numpy(st))
    np.testing.assert_array_equal(ts.id.numpy().view(np.uint32), np.asarray(js.id))
    return jgrid, js, jaux, tgrid, ts, taux


def _call_kwargs(case, st_numpy):
    """Per-pass inputs of a case (the same numpy arrays for both packages):
    Brezzi's dt, the SPS stress, an effective viscosity, Grenier's sigma and
    the callback's time."""
    rng = np.random.default_rng(SEED + 1)
    n = st_numpy["pos"].shape[0]
    kw = {}
    if "dt" in case:
        kw["dt"] = np.float32(case["dt"])
    if case.get("sps"):
        kw["sps_tau"] = rng.normal(0.0, 1e-3, size=(n, 6)).astype(np.float32)
    if case.get("effvisc"):
        kw["effvisc"] = rng.uniform(0.5e-4, 2e-4, size=n).astype(np.float32)
    if case.get("formulation") == "SPH_GRENIER":
        kw["sigma"] = rng.uniform(0.8, 1.2, size=n).astype(np.float32) / DP**3
    if case.get("gcallback"):
        kw["t"] = np.float32(T_CALLBACK)
    return kw


def both_passes(name):
    case = CASES[name]
    jfw, tfw = framework(J, **case), framework(T, **case)
    jgrid, js, jaux, tgrid, ts, taux = _sorted(case, jfw, tfw)
    kw = _call_kwargs(case, {"pos": np.asarray(js.pos)})
    want = jcompute_forces(jfw, jgrid, js, jaux, chunk_cells=16,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    got = compute_forces(tfw, tgrid, ts, taux,
                         **{k: torch.as_tensor(v) for k, v in kw.items()})
    return tfw, tgrid, ts, want, got


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_FRAC * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_general_pass_matches_jax(name):
    tfw, tgrid, ts, want, got = both_passes(name)
    act = ts.active.numpy()
    _close(got.DvDt.numpy()[act], np.asarray(want.DvDt)[act], "DvDt")
    _close(got.DrDt.numpy()[act], np.asarray(want.DrDt)[act], "DrDt")
    assert np.abs(np.asarray(want.DrDt)[act]).max() > 0
    _close(got.xsph.numpy()[act], np.asarray(want.xsph)[act], "xsph")
    _close(got.DEDt.numpy()[act], np.asarray(want.DEDt)[act], "DEDt")
    for k in ("max_accel", "max_sspeed", "max_kinvisc"):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   rtol=RTOL, err_msg=k)
    if name == "xsph":
        assert np.abs(np.asarray(want.xsph)[act]).max() > 0
    if name == "internal_energy":
        assert np.abs(np.asarray(want.DEDt)[act]).max() > 0
    if name == "dem":
        # the terrain pushes some fluid particles: the pass differs from one
        # without it
        plain = compute_forces(dataclasses.replace(tfw, dem=None), tgrid, ts,
                               build_cells(tgrid, ts)[1])
        assert np.abs(plain.DvDt.numpy()[act] - got.DvDt.numpy()[act]).max() > 1.0


@pytest.mark.parametrize("name", ["dyn_artvisc", "lj", "laminar", "colagrossi",
                                  "espanol_revenga_harmonic"])
def test_general_pass_matches_brute_force(name):
    """The port's pass against ``reference_sph.brute_forces`` (float64 sums
    over all pairs), at ``tests/test_forces.py``'s tolerances: 2e-4 of the
    larger of max|DvDt| and 1, and of max|DrDt| and 1e-3."""
    case = CASES[name]
    tfw = framework(T, **case)
    _, _, _, tgrid, ts, taux = _sorted(case, framework(J, **case), tfw)
    out = compute_forces(tfw, tgrid, ts, taux)
    act = ts.active.numpy()
    ptype = np.where(ts.info.numpy() & 7 == 0, 0, 1)
    kinvisc = case.get("kinvisc", 0.0)
    ref_DvDt, ref_DrDt = brute_forces(
        ts.pos.numpy()[act], ts.vel.numpy()[act], ts.rho.numpy()[act],
        ts.mass.numpy()[act], ptype[act],
        h=tfw.slength, rho0=1000.0, c0=30.0, gamma=7.0,
        gravity=np.array([0.0, 0.0, -9.81]),
        boundary="dyn" if case.get("boundary", "DYN_BOUNDARY") == "DYN_BOUNDARY" else "lj",
        artvisc_alpha=0.3 if case.get("turb", "ARTIFICIAL") == "ARTIFICIAL" else 0.0,
        epsartvisc=tfw.pp.epsartvisc, kinvisc=kinvisc,
        visc_avgop=case.get("avg", "ARITHMETIC").lower(),
        visc_model=case.get("visc_model", "MORRIS").lower(),
        bulk_visc=case.get("bulk_visc", 0.0),
        lj_d=50.0, lj_r0=tfw.pp.r0, colagrossi_xi=case.get("xi", 0.0))
    scale_v = max(1.0, np.abs(ref_DvDt).max())
    scale_r = max(1e-3, np.abs(ref_DrDt).max())
    np.testing.assert_allclose(out.DvDt.numpy()[act], ref_DvDt, atol=2e-4 * scale_v)
    np.testing.assert_allclose(out.DrDt.numpy()[act], ref_DrDt, atol=2e-4 * scale_r)


def test_unported_branches_raise():
    """k-epsilon names its slice; SA boundaries run (the DEM terrain too:
    the "dem" case above; tests/test_torch_sa.py holds the SA pass against
    the JAX package's)."""
    fw = framework(T)
    grid = make_grid((0, 0, 0), (BOX,) * 3, fw.influenceradius)
    st, aux = build_cells(grid, state_from_numpy(scene({})[0]))
    sa = dataclasses.replace(fw, boundarytype=T.defs.BoundaryType.SA_BOUNDARY)
    with pytest.raises(NotImplementedError, match="k-epsilon"):
        compute_forces(dataclasses.replace(sa, visc=dataclasses.replace(
            fw.visc, turbmodel=T.defs.TurbulenceModel.KEPSILON)), grid, st, aux)
    # the SA extras of a scene without a mesh: no normals, no triangles
    zeros = {k: torch.zeros_like(st.pos) for k in ("belem", "vr0", "vr1", "vr2")}
    out = compute_forces(sa, grid, st.replace(extras=zeros), aux)
    assert bool(torch.isfinite(out.DvDt).all())
