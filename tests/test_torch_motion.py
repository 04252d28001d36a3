"""Port vs JAX package: the prescribed body motions, and what the chunk
still refuses.

* Each motion callback of DamBreakGate, WaveTank, SolitaryWave (the piston
  and the ten cylinders), SlidingWedge and OffshorePile (the piston; its
  cylinder has no motion) against the JAX closure of the same problem, at
  times before, inside and after each active window.  The port's callback takes the chunk's 0-d f32 time
  tensor and returns two f32[3] tensors on its device; the JAX closure
  takes a f32 scalar.  Tolerance: rtol 1e-6, atol 1e-7 m/s (the same f32
  formulas; libm's sin and cosh may differ by an ulp).
* ``make_sim_chunk`` raises for the configurations of the next slices
  (variable gravity, SPS, granular rheology) and builds four of the seven
  of this one (the chunk tests of ``test_torch_catalog.py`` run three);
  ``get_problem`` names what Seiche waits for.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusph_tpu.problems.base import get_problem as jget_problem

from gpusph_tpu_torch.defs import RheologyType, TurbulenceModel
from gpusph_tpu_torch.integrator import make_sim_chunk
from gpusph_tpu_torch.problems.base import get_problem
from torch_threads import share_cores  # noqa: F401  (autouse: threads per worker)

MOTION_CASES = {
    "DamBreakGate": dict(deltap=0.1),
    "WaveTank": dict(deltap=0.1),
    "SolitaryWave": dict(deltap=0.1),
    "SlidingWedge": dict(deltap=0.3),
    "OffshorePile": dict(deltap=0.25),
}
# the windows: the gate from 0.1 s, the paddle in (0.2, 30), the piston in
# [0.2, 2.84], the cylinders in [0, 1], the wedge in [0.4, 3.07], the
# OffshorePile piston from 0.2 s
TIMES = (0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.5, 0.8, 1.0, 1.3, 2.0, 2.9, 3.05, 3.2, 5.0,
         29.9, 30.5)


def test_motion_callbacks_match():
    n_moving = 0
    for name, opts in MOTION_CASES.items():
        jspecs = jget_problem(name)(dict(opts)).body_specs()
        tspecs = get_problem(name)(dict(opts)).body_specs()
        assert len(tspecs) == len(jspecs) > 0
        for js, ts in zip(jspecs, tspecs):
            assert (ts.motion is None) == (js.motion is None)
            if ts.motion is None:
                continue  # OffshorePile's cylinder: a fixed obstacle with feedback
            for t in TIMES:
                t_dev = torch.tensor(t, dtype=torch.float32)
                got = ts.motion(t_dev)
                want = [np.asarray(v, np.float32) for v in js.motion(jnp.float32(t))]
                for g, w, what in zip(got, want, ("linvel", "angvel")):
                    assert g.dtype == torch.float32 and g.shape == (3,)
                    assert g.device == t_dev.device
                    np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                               err_msg=f"{name} {what} at t={t}")
                    n_moving += bool(np.abs(w).max() > 0)
    assert n_moving >= 5 * 3  # every problem moves at several of the times


def test_chunk_refuses_the_next_slices():
    """Open boundaries wait for their slice; a gravity callback, SPS and the
    granular rheology build on the general pair path, and so does
    Seiche."""
    p = get_problem("Poiseuille")({"ppH": 4})
    grid, _ = p.build()
    fw = p.fw.finalize()
    with pytest.raises(NotImplementedError, match="open boundaries"):
        make_sim_chunk(dataclasses.replace(fw, io=((0.0,),)), grid)
    for change in (dict(gcallback=lambda t: (0.0, 0.0, -9.81)),
                   dict(visc=dataclasses.replace(fw.visc, turbmodel=TurbulenceModel.SPS)),
                   dict(visc=dataclasses.replace(fw.visc, rheologytype=RheologyType.GRANULAR))):
        make_sim_chunk(dataclasses.replace(fw, **change), grid)
    for name, opts in (("PoiseuillePapanastasiou", {"ppH": 4}),
                       ("DamBreak3D", {"deltap": 0.1, "density-diffusion": 0}),
                       ("OffshorePile", {"deltap": 0.25}),
                       ("WaveTank", {"deltap": 0.1}),
                       ("Seiche", {"deltap": 0.1})):
        q = get_problem(name)(dict(opts))
        make_sim_chunk(q.fw.finalize(), q.build()[0], bodies_specs=q.body_specs())
