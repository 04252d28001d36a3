"""Port vs JAX package: one forces pass through the kernel path.

The port's ``compute_forces_kernel`` on the CPU (the kernel's plain version)
against the JAX ``compute_forces_pallas`` in Pallas interpret mode, on the
scenes and the six configurations of ``tests/test_forces_pallas.py``, at
that file's tolerances (rtol 2e-3; atol 1e-4 on DvDt, 1e-6 on DrDt): the two
sum the pairs of a particle in different orders.  The CUDA kernel itself is
held to the plain version on the card by ``tests/test_torch_forces_gpu.py``.
"""
import dataclasses
import re
from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU, see conftest.py)
import numpy as np
import pytest

import gpusph_tpu as J
from gpusph_tpu.ops.forces_pallas import compute_forces_pallas
from gpusph_tpu.ops.neighbors import build_cells as jbuild_cells
from gpusph_tpu.ops.neighbors import make_grid as jmake_grid

import gpusph_tpu_torch as T
from gpusph_tpu_torch.convert import state_from_numpy
from gpusph_tpu_torch.ops import forces_kernel
from gpusph_tpu_torch.ops.block_plan import B, build_block_plan
from gpusph_tpu_torch.ops.forces_kernel import (compute_forces_kernel,
                                                kernel_supported, pair_forces,
                                                prop_table)
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid

from test_forces import DP, make_random_scene
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

CASES = {
    "dyn_artvisc": dict(boundary="DYN_BOUNDARY", turb="ARTIFICIAL", kinvisc=0.0,
                        diffusion="NONE"),
    "lj": dict(boundary="LJ_BOUNDARY", turb="ARTIFICIAL", kinvisc=0.0,
               diffusion="NONE"),
    "laminar": dict(boundary="DYN_BOUNDARY", turb="LAMINAR_FLOW", kinvisc=1e-4,
                    diffusion="NONE"),
    "colagrossi": dict(boundary="DYN_BOUNDARY", turb="ARTIFICIAL", kinvisc=0.0,
                       diffusion="COLAGROSSI", xi=0.1),
    "xsph": dict(boundary="DYN_BOUNDARY", turb="ARTIFICIAL", kinvisc=0.0,
                 diffusion="NONE", flags="ENABLE_XSPH"),
    "internal_energy": dict(boundary="DYN_BOUNDARY", turb="ARTIFICIAL", kinvisc=0.0,
                            diffusion="NONE", flags="ENABLE_INTERNAL_ENERGY"),
}


def frameworks(boundary, turb, kinvisc, diffusion, xi=0.0, flags=None):
    """The same configuration in both packages (as tests/test_forces_pallas.py)."""
    out = []
    for m in (J, T):
        kw = {}
        if flags is not None:
            kw["flags"] = m.SimFlags.ENABLE_DTADAPT | getattr(m.SimFlags, flags)
        out.append(m.setup_framework(
            boundary=getattr(m.BoundaryType, boundary),
            turbulence_model=getattr(m.TurbulenceModel, turb),
            rheology=(m.RheologyType.NEWTONIAN if kinvisc > 0
                      else m.RheologyType.INVISCID),
            density_diffusion=getattr(m.DensityDiffusionType, diffusion),
            simparams=m.SimParams(deltap=DP, max_parts_per_cell=32,
                                  densityDiffCoeff=xi if xi else float("nan")),
            physparams=m.PhysParams(
                fluids=(m.Fluid(rho0=1000.0, gamma=7.0, c0=30.0,
                                kinematic_visc=kinvisc),),
                gravity=(0.0, 0.0, -9.81), dcoeff=50.0),
            **kw).finalize())
    return out


def sorted_scenes(jfw, tfw, seed=1234):
    st, _ = make_random_scene(np.random.default_rng(seed), n_fluid=150, n_bound=60)
    jgrid = jmake_grid((0, 0, 0), (0.3, 0.3, 0.3), jfw.influenceradius)
    tgrid = make_grid((0, 0, 0), (0.3, 0.3, 0.3), tfw.influenceradius)
    js, jaux = jbuild_cells(jgrid, st)
    ts, taux = build_cells(tgrid, state_from_numpy(st))
    return jgrid, js, jaux, tgrid, ts, taux


@pytest.mark.parametrize("case", list(CASES))
def test_forces_match_jax(case):
    jfw, tfw = frameworks(**CASES[case])
    jgrid, js, jaux, tgrid, ts, taux = sorted_scenes(jfw, tfw)
    assert kernel_supported(tfw, tgrid)
    want = compute_forces_pallas(jfw, jgrid, js, jaux)
    got = compute_forces_kernel(tfw, tgrid, ts, build_block_plan(tfw, tgrid, ts, taux))
    act = ts.active.numpy()
    np.testing.assert_allclose(got.DvDt.numpy()[act], np.asarray(want.DvDt)[act],
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got.DrDt.numpy()[act], np.asarray(want.DrDt)[act],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(float(got.max_accel), float(want.max_accel), rtol=2e-3)
    np.testing.assert_allclose(float(got.max_sspeed), float(want.max_sspeed), rtol=1e-6)
    if case == "xsph":
        np.testing.assert_allclose(got.xsph.numpy()[act], np.asarray(want.xsph)[act],
                                   rtol=2e-3, atol=1e-7)
    if case == "internal_energy":
        ref = np.asarray(want.DEDt)[act]
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.DEDt.numpy()[act], ref, rtol=2e-3,
                                   atol=1e-5 * np.abs(ref).max())
    # the inactive tail of the capacity gets exact zeros
    assert not got.DrDt.numpy()[~act].any()


def test_unvisited_blocks_are_zero():
    """Blocks that no tile visits get zeros, not stale memory: the empty
    blocks past the used ones, and — when the flat tile list overflows its
    capacity — blocks holding particles."""
    jfw, tfw = frameworks(**CASES["colagrossi"])
    _, _, _, tgrid, ts, taux = sorted_scenes(jfw, tfw)
    plan = build_block_plan(tfw, tgrid, ts, taux)
    off = plan.tile_off.numpy()
    empty = np.flatnonzero(np.diff(off) == 0)
    assert len(empty) > 0
    out = pair_forces(tfw, tgrid, prop_table(tfw, ts), plan).numpy()
    slots = (empty[:, None] * B + np.arange(B)).ravel()
    assert not out[:, slots].any()

    small = dataclasses.replace(tfw, simparams=dataclasses.replace(tfw.sp, max_flat_tiles=8))
    plan = build_block_plan(small, tgrid, ts, taux)
    assert int(plan.max_run) >= 1_000_000  # the overflow is flagged
    off = plan.tile_off.numpy()
    counts = np.bincount(plan.slot_of_sorted.numpy()[ts.active.numpy()] // B,
                         minlength=plan.n_blocks)
    starved = np.flatnonzero((np.diff(off) == 0) & (counts > 0))
    assert len(starved) > 0
    out = pair_forces(small, tgrid, prop_table(small, ts), plan).numpy()
    slots = (starved[:, None] * B + np.arange(B)).ravel()
    assert not out[:, slots].any()
    assert np.abs(out).max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_params_match_cuda_layout(case):
    """The wrapper's two parameter arrays have the lengths the CUDA source
    declares, for every configuration (the library checks the same counts
    when it is loaded)."""
    src = (Path(forces_kernel.__file__).parent.parent / "csrc" / "forces.cu").read_text()
    declared = {k: int(v) for k, v in
                re.findall(r"constexpr int (N_INT_PARAMS|N_FLOAT_PARAMS) = (\d+);", src)}
    assert declared == {"N_INT_PARAMS": forces_kernel.N_INT_PARAMS,
                        "N_FLOAT_PARAMS": forces_kernel.N_FLOAT_PARAMS}
    _, tfw = frameworks(**CASES[case])
    tgrid = make_grid((0, 0, 0), (0.3, 0.3, 0.3), tfw.influenceradius)
    ints, floats = forces_kernel.kernel_params(tfw, tgrid)
    assert (len(ints), len(floats)) == (forces_kernel.N_INT_PARAMS,
                                        forces_kernel.N_FLOAT_PARAMS)
