"""Command-line entry point of the port.

Counterpart of ``python -m gpusph_tpu`` (the reference's
`src/main.cc:385-477`): problem selection, option parsing, repacking,
resume, checkpointing, the writers and the run loop.

Usage:
  python -m gpusph_tpu_torch <ProblemName> [--deltap X] [--tend T]
      [--maxiter N] [--dir OUT] [--resume FILE] [--checkpoint-every S]
      [--checkpoints N] [--repack] [--repack-only] [--device cuda|cpu]
      [--key value ...]

Every other ``--key value`` goes to the problem as an option, among them
``--config FILE`` (Generic: the INI file that defines the scene),
``--dem FILE`` (DEMExample: a GRASS ASCII terrain instead of the built-in
hill), ``--jacobi_maxiter N`` (the granular problems), ``--max_ppc N``
(the cell capacity) and the catalog problems' own options.

Runs on the CUDA card unless ``--device cpu`` is given.  Output goes to
``--dir`` (default ``tests/<Problem>_<YYYYmmddTHHMMSS>``):

  summary.txt, energy.txt, testpoints.txt, rbdata.txt, objectforces.txt
      the CommonWriter series (test points and bodies when the problem has
      them, WaveGage.txt when it has gages)
  data/PART_NNNNN.vtu, data/PART.pvd
      particle frames at the problem's writer frequency, and their index
  hot_NNNNN.npz
      checkpoints every ``--checkpoint-every`` simulated seconds, checked
      at the write cadence; the last ``--checkpoints`` are kept
  repack.npz
      the repacked state, with ``--repack`` or ``--repack-only``

The last write of a run is forced: the final state is always written as a
frame and, with checkpoints on, as a hotfile.  ``--resume`` takes a hotfile
of either package and continues from its iteration; a granular problem's
hotfile carries its effective pressure.  Ported so far: the problems of
``problems/catalog.py`` (DamBreak3D, Poiseuille, PoiseuillePapanastasiou,
StillWater, LockExchange, OpenChannel, BuoyancyTest, Spheric2,
AccuracyTest, Objects, DynBoundsExample, ProblemExample, DamBreakGate,
WaveTank, SolitaryWave, SlidingWedge, OffshorePile, Seiche, RTInstability,
Bubble, BiFluidPoiseuille, LithostaticLJ, LithostaticDYN,
DamBreakMobileBed, DEMExample, OilJet, and on SA walls StillWaterSA (at its
default, density summation; ``--density_sum 0`` takes gamma by
quadrature), StillWaterRepackSA, BiFluidPoiseuilleSA and LithostaticSA)
and Generic (``problems/generic.py``); the SA problems with k-epsilon or
open boundaries wait for their slices.  With ``--repack`` the repacking
runs before the dynamic gamma is seeded on the repacked particles.  Not
ported: multi-device runs (``--ndev``), and ``--debug timing``, whose
counterpart is ``chip_smoke.py`` [4 layers].
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="gpusph_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("problem", help="problem name (see problems/catalog.py)")
    ap.add_argument("--deltap", type=float, default=None)
    ap.add_argument("--tend", type=float, default=None)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--dir", default=None, help="output directory")
    ap.add_argument("--resume", default=None, help="hotfile to resume from")
    ap.add_argument(
        "--checkpoint-every", type=float, default=0.0,
        help="simulated seconds between hotfile checkpoints",
    )
    ap.add_argument("--checkpoints", type=int, default=3, help="hotfiles kept")
    ap.add_argument("--repack", action="store_true", help="run repacking first")
    ap.add_argument("--repack-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--ndev", type=int, default=1,
                    help="devices to shard over (not ported: only 1)")
    ap.add_argument("--debug", default="", help="comma list of debug flags")
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
    if args.ndev > 1:
        raise NotImplementedError(
            "not ported yet: multi-device runs (--ndev > 1) come with the "
            "multi-GPU slice")
    if "timing" in args.debug.split(","):
        raise NotImplementedError(
            "--debug timing is not ported, by decision: its counterpart is "
            "chip_smoke.py [4 layers]")

    from .bodies import bodies_from_dict
    from .integrator import Simulator
    from .io.hotfile import load_hotfile
    from .io.writers import WriterDispatcher
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
    fw = sim.fw
    outdir = args.dir or f"tests/{problem.name}_{time.strftime('%Y%m%dT%H%M%S')}"
    n = int(state.count_active())
    print(f"Problem {problem.name}: {n} particles, grid {grid.ncells}, "
          f"device {sim.device}")

    if args.repack or args.repack_only:
        from .repacking import run_repacking

        state = run_repacking(sim, state, outdir=outdir)
        print(f"Repacked: {os.path.join(outdir, 'repack.npz')}")
        if args.repack_only:
            return 0

    if args.resume:
        state, header, body_dict = load_hotfile(args.resume)
        sim.t = header["t"]
        sim.dt = header["dt"]
        sim.iterations = header["iterations"]
        sim.bodies = bodies_from_dict(body_dict)
        print(f"Resumed from {args.resume} @ t={sim.t} it={sim.iterations}")

    writers = WriterDispatcher(
        outdir,
        fw,
        vtk_every=problem.vtk_write_every,
        vtklegacy_every=problem.writer_freqs.get("vtklegacy", 0.0),
        text_every=problem.writer_freqs.get("text", 0.0),
        hot_every=args.checkpoint_every,
        keep_hot=args.checkpoints,
        gages=problem.gages,
        n_bodies=len(sim.bodies_specs),
        grid=grid,
    )

    freqs = [problem.vtk_write_every] + list(problem.writer_freqs.values())
    freqs = [f for f in freqs if f and f > 0]
    write_every = min(freqs) if freqs else 0.0

    def on_write(s: Simulator, st):
        writers.maybe_write(
            s.t, st, dt=s.dt, iterations=s.iterations, bodies=s.bodies,
            force=s.finished,
        )
        print(
            f"iter {s.iterations} t={s.t:.6g} dt={s.dt:.6g} "
            f"parts {n} MIPPS {s.mipps:.3f}"
        )

    sim.run(
        state,
        tend=args.tend,
        maxiter=args.maxiter,
        on_write=on_write,
        write_every=write_every,
    )
    writers.close()
    tm = writers.timing
    k = max(tm["writes"], 1)
    print(f"Writes: {tm['writes']} to {outdir}; ms per write: post-process "
          f"{tm['post'] / k * 1e3:.6g}, host copy {tm['copy'] / k * 1e3:.6g}, "
          f"files {tm['files'] / k * 1e3:.6g}")
    print(
        f"Simulation end: t={sim.t:.6g}, {sim.iterations} iterations, "
        f"total MIPPS {sim.mipps:.3f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
