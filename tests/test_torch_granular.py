"""Port vs JAX package: the granular effective pressure.

The surface and interface detection, the Jacobi solve at a fixed count and
at convergence, the granular effective viscosity with a non-zero effective
pressure, and a granular chunk, each on the jittered sediment column of
``tests/test_jacobi.py`` (640 sediment particles over a 192-particle DYN
floor, periodic in x and y).  Inputs reach both packages as the same numpy
arrays (``convert.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.bodies import init_bodies_state as jinit_bodies
from gpusph_tpu.integrator import make_sim_chunk as jmake_sim_chunk
from gpusph_tpu.ops.jacobi import detect_surface_interface as jdetect
from gpusph_tpu.ops.jacobi import jacobi_effpres as jjacobi
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.ops.visc import effective_viscosity as jeffective_viscosity
from test_jacobi import DP, RHO0, sediment_column

from gpusph_tpu_torch.bodies import init_bodies_state
from gpusph_tpu_torch.convert import state_from_numpy, state_to_numpy
from gpusph_tpu_torch.defs import (BoundaryType, ParticleType, Periodicity, RheologyType,
                                   SimFlags, TurbulenceModel)
from gpusph_tpu_torch.framework import setup_framework
from gpusph_tpu_torch.integrator import make_sim_chunk
from gpusph_tpu_torch.ops import jacobi
from gpusph_tpu_torch.ops.jacobi import detect_surface_interface, jacobi_effpres
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid
from gpusph_tpu_torch.ops.pair import neighbor_apply, split_vec
from gpusph_tpu_torch.ops.visc import effective_viscosity
from gpusph_tpu_torch.params import Fluid, PhysParams, SimParams
from gpusph_tpu_torch.state import FG_INTERFACE, FG_SURFACE, part_type
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)


def columns(jacobi_residual=None, **kw):
    """The JAX column of tests/test_jacobi.py and the port's copy of it:
    ((fw, grid, state) of the JAX package, the same of the port), with
    ``jacobi_residual`` in place of the default where given."""
    jfw, jgrid, jst = sediment_column(**kw)
    if jacobi_residual is not None:
        jfw = dataclasses.replace(jfw, simparams=dataclasses.replace(
            jfw.sp, jacobi_residual=jacobi_residual))
    jsp = jfw.sp
    fw = setup_framework(
        boundary=BoundaryType.DYN_BOUNDARY,
        rheology=RheologyType.GRANULAR,
        turbulence_model=TurbulenceModel.LAMINAR_FLOW,
        periodicity=Periodicity.XY,
        flags=SimFlags.ENABLE_DTADAPT,
        simparams=SimParams(deltap=DP, max_parts_per_cell=64,
                            jacobi_backerr=jsp.jacobi_backerr,
                            jacobi_residual=jsp.jacobi_residual,
                            jacobi_maxiter=jsp.jacobi_maxiter),
        physparams=PhysParams(
            fluids=(Fluid(rho0=RHO0, gamma=7.0, c0=30.0, kinematic_visc=1e-4, sinpsi=0.5),),
            gravity=(0.0, 0.0, -9.81)),
    ).finalize()
    world = tuple(n * c for n, c in zip(jgrid.ncells, jgrid.cell_size))
    grid = make_grid(jgrid.origin, world, fw.influenceradius, periodic=Periodicity.XY)
    for f in ("origin", "ncells", "cell_size", "order"):
        assert getattr(grid, f) == getattr(jgrid, f), f
    return (jfw, jgrid, jst), (fw, grid, state_from_numpy(jst))


def sorted_pair(j, t):
    """Both states sorted by the rebuild, and the port's occupied cells."""
    (jfw, jgrid, jst), (fw, grid, st) = j, t
    jsts, jaux = jbuild_cells(jgrid, jst)
    sts, aux = build_cells(grid, st)
    np.testing.assert_array_equal(state_to_numpy(sts)["id"], np.asarray(jsts.id))
    cells = torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)
    return (jfw, jgrid, jsts, jaux), (fw, grid, sts, aux, cells)


def cone_margins(fw, grid, sts, aux, info):
    """Per particle, the smallest |crit - r |n| cos| over its neighbours of
    the free-surface cone test (how far the flag is from flipping)."""
    pp, h = fw.pp, fw.sp.slength
    from gpusph_tpu_torch.ops.kernels import F as kernF

    fields = dict(**split_vec("pos", sts.pos), ptype=part_type(info))

    def normal_fn(c, n, g):
        f = kernF(fw.kerneltype, g.r, h)
        return {k: torch.where(g.mask, -f * r, 0.0)
                for k, r in (("nx", g.relx), ("ny", g.rely), ("nz", g.relz))}

    kw = dict(max_parts_per_cell=fw.sp.max_parts_per_cell,
              influenceradius=fw.sp.influenceradius)
    nrm = neighbor_apply(grid, aux, fields, normal_fn, **kw)
    fields.update(nrm, nlen=torch.sqrt(nrm["nx"] ** 2 + nrm["ny"] ** 2 + nrm["nz"] ** 2))

    def margin_fn(c, n, g):
        cos = torch.where(n["ptype"] == ParticleType.FLUID, pp.cosconeanglefluid,
                          pp.cosconeanglenonfluid)
        crit = -(c["nx"] * g.relx + c["ny"] * g.rely + c["nz"] * g.relz)
        m = torch.abs(crit - g.r * c["nlen"] * cos)
        return {"min_margin": torch.where(g.mask, m, torch.inf)}

    return neighbor_apply(grid, aux, fields, margin_fn, **kw)["min_margin"]


def test_surface_flags_match():
    """FG_SURFACE and FG_INTERFACE of every particle, exact; a mismatch
    names the particle and how far its cone test was from flipping."""
    j, t = sorted_pair(*columns())
    (jfw, jgrid, jsts, jaux), (fw, grid, sts, aux, cells) = j, t
    want = np.asarray(jdetect(jfw, jgrid, jsts, jaux, chunk_cells=16)).view(np.int32)
    got = detect_surface_interface(fw, grid, sts, aux, cells=cells)
    flags = FG_SURFACE | FG_INTERFACE
    bad = np.nonzero((got.numpy() & flags) != (want & flags))[0]
    if len(bad):
        margin = cone_margins(fw, grid, sts, aux, got).numpy()
        pos = sts.pos.numpy()
        raise AssertionError("surface flags differ at " + "; ".join(
            f"id {int(sts.id[i])} at {pos[i].round(5).tolist()}: port "
            f"{int(got[i]) & flags:#x}, JAX {int(want[i]) & flags:#x}, cone margin "
            f"{margin[i]:.3g}" for i in bad[:10]))
    surf = (got.numpy() & FG_SURFACE) != 0
    assert surf.sum() >= 64  # the top layer at least
    np.testing.assert_array_equal(got.numpy(), want)


def test_jacobi_fixed_count():
    """Thresholds 0: both solves run jacobi_maxiter = 20 iterations;
    effpres within rtol 1e-5 (atol 1e-5 of its max: another f32 summation
    order)."""
    j, t = sorted_pair(*columns(jacobi_residual=0.0, jacobi_backerr=0.0, jacobi_maxiter=20))
    (jfw, jgrid, jsts, jaux), (fw, grid, sts, aux, cells) = j, t
    jep, jinfo, jit = jjacobi(jfw, jgrid, jsts, jaux, chunk_cells=16)
    ep, info, it = jacobi_effpres(fw, grid, sts, aux, cells=cells)
    assert int(it) == int(jit) == 20
    np.testing.assert_array_equal(info.numpy(), np.asarray(jinfo).view(np.int32))
    want = np.asarray(jep)
    assert want.max() > 100.0
    np.testing.assert_allclose(ep.numpy(), want, rtol=1e-5, atol=1e-5 * want.max())


@pytest.mark.parametrize("check_every", [1, 8])
def test_jacobi_converged(check_every, monkeypatch):
    """With DamBreakMobileBed's thresholds (residual and backward error
    1e-3) both solves stop at the same iteration (48 on the port), whatever
    the port's host-read cadence (``ops/jacobi.py:CHECK_EVERY``), and
    effpres agrees within 1e-4 of its max.  (At the default residual 1e-6 the f32 residual never gets there:
    both run to jacobi_maxiter.)"""
    j, t = sorted_pair(*columns(jacobi_residual=1e-3, nz_sed=6, jacobi_backerr=1e-3,
                                jacobi_maxiter=200))
    (jfw, jgrid, jsts, jaux), (fw, grid, sts, aux, cells) = j, t
    jep, _, jit = jjacobi(jfw, jgrid, jsts, jaux, chunk_cells=16)
    monkeypatch.setattr(jacobi, "CHECK_EVERY", check_every)
    ep, _, it = jacobi_effpres(fw, grid, sts, aux, cells=cells)
    assert 0 < int(jit) < fw.sp.jacobi_maxiter
    assert int(it) == int(jit)
    want = np.asarray(jep)
    np.testing.assert_allclose(ep.numpy(), want, rtol=0, atol=1e-4 * want.max())


def test_granular_effective_viscosity():
    """The granular effective viscosity with the Jacobi solve's effpres on a
    seeded shear (rtol 1e-5: the same f32 formulas, another summation
    order in the shear rate)."""
    j, t = sorted_pair(*columns(jacobi_backerr=0.0, jacobi_maxiter=10))
    (jfw, jgrid, jsts, jaux), (fw, grid, sts, aux, cells) = j, t
    rng = np.random.default_rng(11)
    vel = rng.normal(0.0, 0.05, (sts.capacity, 3)).astype(np.float32)
    vel[:, 0] += 2.0 * sts.pos.numpy()[:, 2]  # a shear along z
    jsts = jsts.replace(vel=jnp.asarray(vel))
    sts = sts.replace(vel=torch.as_tensor(vel))
    jep, _, _ = jjacobi(jfw, jgrid, jsts, jaux, chunk_cells=16)
    ep = torch.as_tensor(np.array(jep))
    assert float(ep.max()) > 100.0
    want = np.asarray(jeffective_viscosity(jfw, jgrid, jsts, jaux, effpres=jep,
                                           chunk_cells=16))
    got = effective_viscosity(fw, grid, sts, aux, effpres=ep, cells=cells).numpy()
    zero = effective_viscosity(fw, grid, sts, aux, cells=cells).numpy()
    assert np.abs(got - zero).max() > 1e-3 * np.abs(zero).max()  # effpres matters
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_granular_chunk_matches():
    """Two steps of a granular chunk (EFFPRES before each of the four
    forces passes, effpres carried in the state, so that the later solves
    stop early) against the JAX chunk, by particle id: pos 1e-6 m, vel
    1e-5 m/s, rho 1e-6, effpres 1e-4 of its max, flags exact, dt rtol
    1e-5."""
    (jfw, jgrid, jst), (fw, grid, st) = columns(jacobi_residual=1e-3, nz_sed=5,
                                                jacobi_backerr=1e-3, jacobi_maxiter=60)
    steps = 2
    jfw, fw = (dataclasses.replace(f, simparams=dataclasses.replace(
        f.sp, buildneibsfreq=steps)).finalize() for f in (jfw, fw))
    jst = jst.replace(extras={"effpres": jnp.zeros((jst.capacity,), jnp.float32)})
    st = state_from_numpy(jst)
    dt0 = np.float32(1e-5)
    jchunk = jmake_sim_chunk(jfw, jgrid, chunk_cells=16, use_pallas=False)
    jout = jchunk(jst, jnp.float32(dt0), jnp.float32(0.0), jnp.int32(0),
                  jinit_bodies((), jst))
    chunk = make_sim_chunk(fw, grid)
    out = chunk(st, torch.tensor(dt0), torch.tensor(0.0), 0, init_bodies_state((), st))

    js, ts = state_to_numpy(state_from_numpy(jout[0])), state_to_numpy(out[0])
    jo, to = np.argsort(js["id"]), np.argsort(ts["id"])
    np.testing.assert_array_equal(ts["id"][to], js["id"][jo])
    np.testing.assert_array_equal(ts["info"][to], js["info"][jo])
    for k, atol in (("pos", 1e-6), ("vel", 1e-5), ("rho", 1e-6)):
        np.testing.assert_allclose(ts[k][to], js[k][jo], rtol=0, atol=atol, err_msg=k)
    ep_j = js["extras"]["effpres"][jo]
    assert ep_j.max() > 100.0
    np.testing.assert_allclose(ts["extras"]["effpres"][to], ep_j, rtol=0,
                               atol=1e-4 * ep_j.max())
    np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=1e-5)


def test_cli_resume_carries_effpres(tmp_path):
    """``python -m gpusph_tpu_torch LithostaticDYN`` on the CPU with
    checkpoints: the final hotfile (iteration 10) carries the effective
    pressure, a resume from it loads that state and writes it back as its
    first hotfile bit for bit, and continues to iteration 20.  The scene is
    cut to dp 0.25 (1,026 particles, cells capped at 104 particles) and to
    one Jacobi iteration a solve: a dense CPU pass costs 10-40 ns per pair
    slot, so at dp 0.1 a chunk takes about a minute."""
    from gpusph_tpu_torch import cli
    from gpusph_tpu_torch.io.hotfile import load_hotfile

    args = ["LithostaticDYN", "--deltap", "0.25", "--max_ppc", "104", "--jacobi_maxiter", "1",
            "--checkpoint-every", "1e-4", "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    assert cli.main(args + ["--maxiter", "10", "--dir", str(a)]) == 0
    state, header, _ = load_hotfile(str(a / "hot_00000.npz"))
    assert header["iterations"] == 10
    with np.load(a / "hot_00000.npz") as z:
        np.testing.assert_array_equal(state.extras["effpres"].numpy(), z["extra.effpres"])
        assert np.abs(z["extra.effpres"]).max() > 1000.0
    assert cli.main(args + ["--maxiter", "20", "--dir", str(b),
                            "--resume", str(a / "hot_00000.npz")]) == 0
    with np.load(a / "hot_00000.npz") as want, np.load(b / "hot_00000.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, header, _ = load_hotfile(str(b / "hot_00001.npz"))
    assert header["iterations"] == 20
