"""Command-line entry point of the port.

Usage:
  python -m gpusph_tpu_torch <ProblemName> [--deltap X] [--tend T]
      [--maxiter N] [--device cuda|cpu] [--key value ...]

Runs on the CUDA card unless ``--device cpu`` is given, and prints the
iteration / MIPPS status lines of ``python -m gpusph_tpu``.  Ported so far:
DamBreak3D.  Not ported yet: the writers (VTK, text, energy, test points),
hotfile checkpoints and resume, repacking, the post-process passes and
multi-device runs; this CLI therefore takes no output or checkpoint flags.
"""
from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="gpusph_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("problem", help="problem name (see problems/catalog.py)")
    ap.add_argument("--deltap", type=float, default=None)
    ap.add_argument("--tend", type=float, default=None)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    args, extra = ap.parse_known_args(argv)

    # free-form --key value options forwarded to the problem (main.cc:254-259)
    opts = {}
    i = 0
    while i < len(extra):
        tok = extra[i]
        if tok.startswith("--"):
            key = tok[2:]
            if i + 1 < len(extra) and not extra[i + 1].startswith("--"):
                opts[key] = extra[i + 1]
                i += 2
            else:
                opts[key] = "true"
                i += 1
        else:
            i += 1
    return args, opts


def main(argv=None):
    args, opts = parse_args(sys.argv[1:] if argv is None else argv)

    from .integrator import Simulator
    from .problems.base import get_problem

    if args.deltap is not None:
        opts.setdefault("deltap", args.deltap)
    problem = get_problem(args.problem)(opts)
    if args.deltap is not None and problem.deltap != args.deltap:
        problem.set_deltap(args.deltap)
    if args.tend is not None:
        problem.set_tend(args.tend)

    grid, state = problem.build()
    sim = Simulator(problem.fw, grid, bodies_specs=problem.body_specs(),
                    device=args.device)
    n = int(state.count_active())
    print(f"Problem {problem.name}: {n} particles, grid {grid.ncells}, "
          f"device {sim.device}")

    def on_write(s: Simulator, st):
        print(f"iter {s.iterations} t={s.t:.6g} dt={s.dt:.6g} "
              f"parts {n} MIPPS {s.mipps:.3f}")

    sim.run(state, tend=args.tend, maxiter=args.maxiter, on_write=on_write,
            write_every=problem.vtk_write_every)
    print(f"Simulation end: t={sim.t:.6g}, {sim.iterations} iterations, "
          f"total MIPPS {sim.mipps:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
