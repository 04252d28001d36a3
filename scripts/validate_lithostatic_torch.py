#!/usr/bin/env python
"""Hydrostatic validation of the PyTorch/CUDA port: settled column vs the
analytic profile.

Counterpart of ``scripts/validate_lithostatic.py`` (the reference's
`scripts/validate-lithostatic.py`, driving `gpusph-valid.tex:233`'s
hydrostatic-basin 1% bar): run the still water column (StillWater) to rest
on the CUDA card, or on the CPU with ``--device cpu``, and compare the
fluid pressure profile against rho0 g (surface - z); also report the
residual velocity.  The JAX script's SA problems (StillWaterSA,
LithostaticSA) wait for the SA slice.

The reference pressure uses the *actual* settled surface (top fluid layer
+ dp/2, the SPH surface convention) rather than the nominal fill height.

Usage: python scripts/validate_lithostatic_torch.py [--ppH 24] [--tend 3]
           [--deltap DP] [--device cuda|cpu]
Prints the card's name and power limit, then one JSON line; exits 1 unless
the L2 error is below 1%.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from validate_poiseuille_torch import card_line  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="StillWater")
    ap.add_argument("--ppH", type=int, default=24)
    ap.add_argument("--tend", type=float, default=3.0)
    ap.add_argument("--deltap", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()

    import numpy as np

    from gpusph_tpu_torch.integrator import Simulator, resolve_device
    from gpusph_tpu_torch.ops import eos
    from gpusph_tpu_torch.problems.base import get_problem
    from gpusph_tpu_torch.state import fluid_num, is_fluid

    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    opts = dict(ppH=args.ppH, tend=args.tend)
    if args.deltap:
        opts["deltap"] = args.deltap
    P = get_problem(args.problem)(opts)
    grid, state = P.build()
    sim = Simulator(P.fw, grid, bodies_specs=P.body_specs(), device=device)
    t0 = time.perf_counter()
    state = sim.run(state, tend=args.tend, maxiter=0)
    wall = time.perf_counter() - t0

    act = (state.active & is_fluid(state.info)).cpu().numpy()
    z = state.pos.cpu().numpy()[act, 2]
    press = eos.pressure(P.fw.pp, state.rho, fluid_num(state.info)).cpu().numpy()[act]
    vmax = float(np.abs(state.vel.cpu().numpy()[act]).max())

    g = 9.81
    dp = P.fw.sp.deltap
    rho0 = P.fw.pp.fluids[0].rho0
    surface = float(z.max()) + 0.5 * dp
    depth = surface - z
    p_ref = rho0 * g * np.maximum(depth, 0.0)

    # exclude the free-surface smearing zone (one kernel radius)
    core = depth > P.fw.influenceradius
    scale = p_ref[core].max()
    l2 = float(np.sqrt(np.mean((press[core] - p_ref[core]) ** 2)) / scale)
    linf = float(np.abs(press[core] - p_ref[core]).max() / scale)

    out = dict(
        problem=args.problem,
        particles=int(act.sum()),
        t=sim.t,
        iters=sim.iterations,
        l2_rel=l2,
        linf_rel=linf,
        residual_vmax=vmax,
        wall_s=wall,
        mipps=sim.mipps,
        device=str(sim.device),
        pass_1pct=l2 < 0.01,
    )
    print(json.dumps(out))
    sys.exit(0 if out["pass_1pct"] else 1)


if __name__ == "__main__":
    main()
