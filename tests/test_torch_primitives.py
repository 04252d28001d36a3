"""Port vs JAX package: smoothing kernels, equation of state, info bits.

Inputs come from numpy seeds; both packages compute in f32 on the CPU.
Tolerance rtol 1e-6: the same f32 formulas, where libm's pow/exp may differ
by an ulp between the two frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu import KernelType
from gpusph_tpu.ops import eos as jeos
from gpusph_tpu.ops import kernels as jkern
from gpusph_tpu.params import Fluid as JFluid
from gpusph_tpu.params import PhysParams as JPhysParams
from gpusph_tpu import state as jstate

from gpusph_tpu_torch.ops import eos as teos
from gpusph_tpu_torch.ops import kernels as tkern
from gpusph_tpu_torch.params import Fluid as TFluid
from gpusph_tpu_torch.params import PhysParams as TPhysParams
from gpusph_tpu_torch import state as tstate
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

RTOL = 1e-6


@pytest.mark.parametrize("kt", [KernelType.CUBICSPLINE, KernelType.QUADRATIC,
                                KernelType.WENDLAND, KernelType.GAUSSIAN])
def test_kernels_W_F(kt):
    h = 0.026
    rng = np.random.default_rng(7)
    radius = (3.0 if kt == KernelType.GAUSSIAN else 2.0) * h
    r = rng.uniform(1e-4, radius, size=4096).astype(np.float32)
    for name in ("W", "F"):
        want = np.asarray(getattr(jkern, name)(kt, jnp.asarray(r), h))
        got = getattr(tkern, name)(int(kt), torch.as_tensor(r), h).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=name)


def _pp(mod_fluid, mod_pp):
    return mod_pp(fluids=(mod_fluid(rho0=1000.0, gamma=7.0, c0=20.0,
                                    kinematic_visc=1e-6),
                          mod_fluid(rho0=1.2, gamma=1.4, c0=30.0,
                                    kinematic_visc=1.5e-5)),
                  gravity=(0.0, 0.0, -9.81))


@pytest.mark.parametrize("fn", ["pressure", "sound_speed", "physical_density",
                                "numerical_density"])
@pytest.mark.parametrize("n_fluids", [1, 2])
def test_eos(fn, n_fluids):
    jpp, tpp = _pp(JFluid, JPhysParams), _pp(TFluid, TPhysParams)
    if n_fluids == 1:
        jpp = jpp.__class__(fluids=jpp.fluids[:1], gravity=jpp.gravity)
        tpp = tpp.__class__(fluids=tpp.fluids[:1], gravity=tpp.gravity)
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.02, 0.03, size=2048).astype(np.float32)
    if fn == "numerical_density":
        x = (x + 1.0) * 1000.0
    fnum = rng.integers(0, n_fluids, size=2048).astype(np.int32)
    want = np.asarray(getattr(jeos, fn)(jpp, jnp.asarray(x), jnp.asarray(fnum)))
    got = getattr(teos, fn)(tpp, torch.as_tensor(x), torch.as_tensor(fnum)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_hydrostatic_density():
    jpp, tpp = _pp(JFluid, JPhysParams), _pp(TFluid, TPhysParams)
    depth = np.linspace(0.0, 0.4, 513).astype(np.float32)
    want = np.asarray(jeos.hydrostatic_density(jpp, jnp.asarray(depth), 0))
    got = teos.hydrostatic_density(tpp, torch.as_tensor(depth), 0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_info_helpers_with_sign_bit():
    """Info words from numpy, including IO object numbers that set bit 31:
    the int32 helpers must give the uint32 helpers' fields."""
    rng = np.random.default_rng(3)
    n = 512
    words = (rng.integers(0, 5, n)
             | (rng.integers(0, 2, (n, 10)) << np.arange(3, 13)).sum(1)
             | (rng.integers(0, 256, n) << 16)
             | (rng.integers(0, 256, n) << 24)).astype(np.uint32)
    words[0] = np.uint32(0x80000000 | (7 << 16) | int(tstate.FG_INACTIVE) | 1)
    words[1] = np.uint32(0xFF000000 | int(tstate.FG_MOVING_BOUNDARY))
    assert (words >> 31).any()
    ju = jnp.asarray(words)
    ti = torch.as_tensor(words.view(np.int32))
    pairs = [(jstate.part_type, tstate.part_type),
             (jstate.fluid_num, tstate.fluid_num),
             (jstate.io_object_num, tstate.io_object_num),
             (jstate.is_active, tstate.is_active),
             (jstate.is_fluid, tstate.is_fluid),
             (jstate.is_boundary, tstate.is_boundary)]
    for jf, tf in pairs:
        np.testing.assert_array_equal(tf(ti).numpy(), np.asarray(jf(ju)),
                                      err_msg=tf.__name__)
    for flag in (tstate.FG_COMPUTE_FORCE, tstate.FG_MOVING_BOUNDARY,
                 tstate.FG_INACTIVE, tstate.FG_INTERFACE):
        np.testing.assert_array_equal(tstate.has_flag(ti, flag).numpy(),
                                      np.asarray(jstate.has_flag(ju, flag)))
    # make_info packs the same bits, IO object number included
    for ptype, flags, fo, io in [(1, tstate.FG_MOVING_BOUNDARY, 3, 0),
                                 (0, 0, 1, 200), (4, tstate.FG_INACTIVE, 255, 255)]:
        want = int(jstate.make_info(ptype, flags, fo)) | (io << 24)
        got = tstate.make_info(ptype, flags, fo, io)
        assert np.int32(got).view(np.uint32) == np.uint32(want)
