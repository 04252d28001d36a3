#!/usr/bin/env python
"""The granular effective pressure's slope on a lithostatic problem.

Builds LithostaticDYN or LithostaticLJ, runs one EFFPRES Jacobi solve from
zero effective pressure (the first solve of a run) with the problem's
thresholds, and fits p_eff(z) over the interior sediment with the port's
``ops/jacobi.py:effpres_slope`` (the fit ``chip_smoke.py`` uses).  Prints
one JSON line: the iterations, the slope, its ratio to (rho_sed - rho_w) g
and the fit's R^2.

    python scripts/lithostatic_slope.py --package torch [--device cuda|cpu]
        [--problem LithostaticDYN] [--deltap 0.1] [--dyn-layers N]
    python scripts/lithostatic_slope.py --package jax --deltap 0.1

``--package jax`` runs the JAX package on the CPU (its reference); the
port runs on the CUDA card unless ``--device cpu`` is given.
``--dyn-layers N`` gives LithostaticDYN's tank N wall layers instead of 3.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def with_layers(cls, n):
    """``cls`` with ``n`` dynamic-boundary layers: the problem's own
    assignment of its default is ignored."""
    if n is None:
        return cls
    return type("_Layered" + cls.__name__, (cls,),
                {"dyn_layers": property(lambda self: n, lambda self, v: None)})


def run_torch(name, dp, device, layers):
    import torch

    from gpusph_tpu_torch.integrator import resolve_device
    from gpusph_tpu_torch.ops.jacobi import jacobi_effpres
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.problems.base import get_problem

    dev = resolve_device(device)
    p = with_layers(get_problem(name), layers)({"deltap": dp})
    grid, state = p.build()
    sts, aux = build_cells(grid, state.to(dev))
    cells = torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)
    ep, info, iters = jacobi_effpres(p.fw, grid, sts, aux, sts.extras["effpres"], cells=cells)
    return p.fw, int(iters), sts.pos, ep, info, str(dev)


def run_jax(name, dp, layers):
    import jax
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    from gpusph_tpu.ops.jacobi import jacobi_effpres
    from gpusph_tpu.ops.neighbors import build_cells
    from gpusph_tpu.problems.base import get_problem

    from gpusph_tpu_torch.problems.base import get_problem as port_problem

    p = with_layers(get_problem(name), layers)({"deltap": dp})
    grid, state = p.build()
    sts, aux = build_cells(grid, state)
    ep, info, iters = jacobi_effpres(p.fw.finalize(), grid, sts, aux, sts.extras["effpres"])
    fw = port_problem(name)({"deltap": dp}).fw  # the same fluids and gravity
    return (fw, int(iters), torch.as_tensor(np.asarray(sts.pos)),
            torch.as_tensor(np.asarray(ep)), torch.as_tensor(np.asarray(info)), "cpu (JAX)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--problem", default="LithostaticDYN")
    ap.add_argument("--deltap", type=float, default=0.1)
    ap.add_argument("--device", default=None)
    ap.add_argument("--dyn-layers", type=int, default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.package == "jax":
        fw, iters, pos, ep, info, dev = run_jax(args.problem, args.deltap, args.dyn_layers)
    else:
        fw, iters, pos, ep, info, dev = run_torch(args.problem, args.deltap, args.device,
                                                  args.dyn_layers)
    from gpusph_tpu_torch.ops.jacobi import effpres_slope

    slope, r2, n, drho_g = effpres_slope(fw, pos, ep, info)
    out = {"package": args.package, "problem": args.problem, "deltap": args.deltap,
           "dyn_layers": args.dyn_layers, "device": dev, "iterations": iters,
           "jacobi_maxiter": fw.sp.jacobi_maxiter, "drho_g": drho_g, "slope": slope,
           "ratio": slope / drho_g, "r2": r2, "n": n, "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
