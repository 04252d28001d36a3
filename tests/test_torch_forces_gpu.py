"""The forces kernel against its plain PyTorch version on the card.

Needs a CUDA card and imports neither JAX nor the JAX package, so it runs on
a machine without JAX.  ``tests/conftest.py`` imports JAX, so run it there
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_forces_gpu.py

The scenes are made with numpy from a seed: the random fluid blob and
boundary particles of ``tests/test_forces.py:make_random_scene`` under the
six configurations of ``tests/test_forces_pallas.py`` (copies of
``chip_smoke.py:random_scene`` and ``small_configs``).  Tolerances: rtol
2e-3, atol 1e-4 on DvDt and 1e-3 on raw DrDt, because the kernel sums the
pairs of a particle in another order than the plain version.
"""
import numpy as np
import pytest
import torch

from gpusph_tpu_torch import (BoundaryType, DensityDiffusionType, Fluid, PhysParams,
                              RheologyType, SimFlags, SimParams, TurbulenceModel,
                              setup_framework)
from gpusph_tpu_torch.convert import state_from_numpy
from gpusph_tpu_torch.defs import ParticleType
from gpusph_tpu_torch.ops import forces_kernel
from gpusph_tpu_torch.ops.block_plan import build_block_plan
from gpusph_tpu_torch.ops.forces_kernel import (kernel_supported, pair_forces,
                                                pair_forces_reference, prop_table)
from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid

DP = 0.02


def random_scene(rng, dp, n_fluid=150, n_bound=60, box=0.3):
    """Random fluid blob + boundary particles, as numpy arrays."""
    capacity = n_fluid + n_bound + 20
    pos = np.zeros((capacity, 3), np.float32)
    pos[:n_fluid + n_bound] = np.concatenate([
        rng.uniform(0.05, box - 0.05, size=(n_fluid, 3)),
        rng.uniform(0.0, box, size=(n_bound, 3)),
    ]).astype(np.float32)
    vel = np.zeros((capacity, 3), np.float32)
    vel[:n_fluid] = rng.normal(0, 0.5, size=(n_fluid, 3))
    rho = np.zeros(capacity, np.float32)
    rho[: n_fluid + n_bound] = rng.uniform(-0.005, 0.01, size=n_fluid + n_bound)
    info = np.full(capacity, int(ParticleType.NONE), np.uint32)
    info[:n_fluid] = int(ParticleType.FLUID)
    info[n_fluid:n_fluid + n_bound] = int(ParticleType.BOUNDARY)
    return dict(pos=pos, vel=vel, rho=rho,
                mass=np.full(capacity, 1000.0 * dp**3, np.float32),
                info=info, id=np.arange(capacity, dtype=np.uint32))


def small_configs(periodicity=0):
    """The six framework configurations of tests/test_forces_pallas.py."""
    def fw(boundary, turb, kinvisc, diffusion, xi=0.0, flags=None):
        kw = dict(periodicity=periodicity)
        if flags is not None:
            kw["flags"] = flags
        return setup_framework(
            boundary=boundary, turbulence_model=turb,
            rheology=RheologyType.NEWTONIAN if kinvisc > 0 else RheologyType.INVISCID,
            density_diffusion=diffusion,
            simparams=SimParams(deltap=DP, max_parts_per_cell=32,
                                densityDiffCoeff=xi if xi else float("nan")),
            physparams=PhysParams(
                fluids=(Fluid(rho0=1000.0, gamma=7.0, c0=30.0, kinematic_visc=kinvisc),),
                gravity=(0.0, 0.0, -9.81), dcoeff=50.0),
            **kw).finalize()

    DYN, LJ = BoundaryType.DYN_BOUNDARY, BoundaryType.LJ_BOUNDARY
    ART, LAM = TurbulenceModel.ARTIFICIAL, TurbulenceModel.LAMINAR_FLOW
    NONE, COL = DensityDiffusionType.NONE, DensityDiffusionType.COLAGROSSI
    return {
        "dyn_artvisc": fw(DYN, ART, 0.0, NONE),
        "lj": fw(LJ, ART, 0.0, NONE),
        "laminar": fw(DYN, LAM, 1e-4, NONE),
        "colagrossi": fw(DYN, ART, 0.0, COL, xi=0.1),
        "xsph": fw(DYN, ART, 0.0, NONE,
                   flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_XSPH),
        "internal_energy": fw(DYN, ART, 0.0, NONE,
                              flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_INTERNAL_ENERGY),
    }


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forces kernel has no CPU mode")
    return torch.device("cuda")


def _scene(tfw, dev, seed=1234):
    """Sorted state, plan and property table of the random scene on ``dev``.
    On a periodic grid the scene is shifted by half the box along the
    periodic axes, so the fluid blob straddles their boundaries."""
    tgrid = make_grid((0, 0, 0), (0.3, 0.3, 0.3), tfw.influenceradius,
                      periodic=tfw.periodicbound)
    scene = random_scene(np.random.default_rng(seed), DP)
    for axis in range(3):
        if tfw.periodicbound & (1 << axis):
            scene["pos"][:, axis] = (scene["pos"][:, axis] + np.float32(0.15)) % np.float32(0.3)
    state = state_from_numpy(scene, device=dev)
    ts, taux = build_cells(tgrid, state)
    plan = build_block_plan(tfw, tgrid, ts, taux)
    return tgrid, ts, plan, prop_table(tfw, ts)


def _assert_matches_plain_version(tfw, case, dev):
    tgrid, ts, plan, P = _scene(tfw, dev)
    assert kernel_supported(tfw, tgrid)
    n0 = forces_kernel.launches
    got = pair_forces(tfw, tgrid, P, plan)
    assert forces_kernel.launches == n0 + 1
    ref = pair_forces_reference(tfw, tgrid, P, plan)
    torch.cuda.synchronize()
    used = plan.slot_of_sorted[ts.active].long()
    g, r = got[:, used].cpu().numpy(), ref[:, used].cpu().numpy()
    np.testing.assert_allclose(g[1:4], r[1:4], rtol=2e-3, atol=1e-4, err_msg=case)
    # raw DrDt is not yet divided by rho0 = 1000: atol 1e-6 x 1000
    np.testing.assert_allclose(g[0], r[0], rtol=2e-3, atol=1e-3, err_msg=case)
    np.testing.assert_allclose(g[4:], r[4:], rtol=2e-3,
                               atol=1e-5 * max(np.abs(r[4:]).max(), 1.0),
                               err_msg=case)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, on the six
    configurations (tolerances as above: different summation order)."""
    dev = _cuda()
    for case, tfw in small_configs().items():
        _assert_matches_plain_version(tfw, case, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["colagrossi", "laminar"])
def test_cuda_kernel_matches_plain_version_periodic(case):
    """The same on a grid periodic on its slow axes (Y and Z), where pairs
    meet across the boundary by the minimum image; colagrossi runs the
    kernel's lean instantiation, laminar the general one."""
    _assert_matches_plain_version(small_configs(periodicity=6)[case], case, _cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["colagrossi", "internal_energy"])
def test_cuda_kernel_is_deterministic(case):
    """Two launches on the same inputs are bit-identical: the kernel sums in
    a fixed order and uses no atomics.  Every output slot is written, so
    the blocks that no tile visits hold zeros in both."""
    dev = _cuda()
    tfw = small_configs()[case]
    tgrid, ts, plan, P = _scene(tfw, dev)
    first = pair_forces(tfw, tgrid, P, plan)
    second = pair_forces(tfw, tgrid, P, plan)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert bool(torch.isfinite(first).all())
    empty = torch.nonzero(plan.tile_off[1:] == plan.tile_off[:-1]).flatten()
    assert empty.numel() > 0
    assert not bool(first.reshape(first.shape[0], -1, 64)[:, empty].any())
