#!/usr/bin/env python
"""Poiseuille validation of the PyTorch/CUDA port: steady profile vs the
analytic parabola.

Counterpart of ``scripts/validate_poiseuille.py`` (the reference's
`scripts/validate-poiseuille.py`, which compares against
v_x(z) = F/(2 nu) ((lz/2)^2 - z^2)).  Runs the port's Poiseuille problem to
(near) steady state on the CUDA card, or on the CPU with ``--device cpu``,
and reports the L2/Linf error of the fluid velocity profile.

Usage: python scripts/validate_poiseuille_torch.py [--ppH 16] [--tend 30]
           [--sweep] [--device cuda|cpu]
Prints the card's name and power limit, then one JSON line per
configuration; exits 1 unless every L2 error is below 1%.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"


def run_case(ppH, tend, compvisc, viscavg, device, steady_init=True):
    import numpy as np

    from gpusph_tpu_torch.integrator import Simulator
    from gpusph_tpu_torch.problems.base import get_problem
    from gpusph_tpu_torch.state import is_fluid

    P = get_problem("Poiseuille")(dict(
        ppH=ppH, compvisc=compvisc, viscavg=viscavg,
        **({"steady-init": True} if steady_init else {})))
    grid, state = P.build()
    sim = Simulator(P.fw, grid, device=device)
    t0 = time.perf_counter()
    state = sim.run(state, tend=tend, maxiter=0)
    wall = time.perf_counter() - t0

    act = (state.active & is_fluid(state.info)).cpu().numpy()
    z = state.pos.cpu().numpy()[act, 2]
    vx = state.vel.cpu().numpy()[act, 0]
    v_ref = np.asarray([P.compute_poiseuille_vel(zz) for zz in z])
    vmax = v_ref.max()
    return dict(
        case=f"ppH{ppH}_cv{compvisc}_avg{viscavg}",
        particles=int(state.count_active()),
        t=sim.t,
        iters=sim.iterations,
        l2_rel=float(np.sqrt(np.mean((vx - v_ref) ** 2)) / vmax),
        linf_rel=float(np.abs(vx - v_ref).max() / vmax),
        vmax_measured=float(vx.max()),
        vmax_analytic=float(vmax),
        wall_s=wall,
        mipps=sim.mipps,
        device=str(sim.device),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ppH", type=int, default=16)
    ap.add_argument("--tend", type=float, default=30.0)
    ap.add_argument("--sweep", action="store_true",
                    help="sweep compvisc x viscavg like the reference script")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()

    from gpusph_tpu_torch.integrator import resolve_device

    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    cases = [(0, 1)]  # kinematic + harmonic (reference default)
    if args.sweep:
        cases = [(cv, avg) for cv in (0, 1) for avg in (0, 1, 2)]

    ok = True
    for cv, avg in cases:
        r = run_case(args.ppH, args.tend, cv, avg, device)
        r["pass_1pct"] = r["l2_rel"] < 0.01
        ok &= r["pass_1pct"]
        print(json.dumps(r), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
