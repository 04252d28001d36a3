#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no ``ok`` line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds the port's kernels from ``gpusph_tpu_torch/csrc``;
   prints the ``-Xptxas -v`` registers / shared memory / spills and the
   list of ported kernels;
3. kernel vs plain version on the card: the six small configurations of
   ``tests/test_forces_pallas.py`` (random scenes from a numpy seed) and
   DamBreak3D at dp 0.012 after two chunks, on every active particle; two
   launches on the same DamBreak3D inputs must be bit-identical;
4. main path at full size: ``Simulator.run`` on DamBreak3D at dp 0.012 for
   5 chunks (50 iterations); the forces kernel must have launched exactly
   twice per step; particle-steps/s, kernel and plain-version ms, the
   kernel's bound and the compaction figure of its thread mapping
   (``pair_stats``);
5. golden fingerprint: DamBreak3D at dp 0.04 (max_ppc 64), 100 iterations,
   against ``tests/references/DamBreak3D_100.npz``;
6. output path at dp 0.012, in a temporary directory: the CLI with
   checkpoints (layout, the last VTU frame against the final checkpoint,
   test points, energy and body series), a resume from a middle hotfile
   against the straight run, the write-time post-process pass on the card
   against the CPU, ``--repack-only``, and the cost of a write and of a
   repack chunk;
7. the catalog at full width: each problem of ``CATALOG`` at its default
   options, ``Simulator.run`` for 50 iterations (two forces-kernel launches
   per step, ``n_active`` conserved, a finite state, dt > 1e-10,
   particle-steps/s, kernel ms per launch, kernel vs plain version on the
   final state at phase 3's tolerances); the JAX goldens of
   ``tests/references`` that the JAX package still meets, at the options of
   ``scripts/check_problem.py``, against phase 5's limit; Poiseuille from its
   steady start against the analytic profile;
8. prescribed body motion, the density filters and the effective viscosity:
   each configuration of ``SLICE`` (DamBreakGate, WaveTank, SolitaryWave,
   SlidingWedge, OffshorePile, PoiseuillePapanastasiou and DamBreak3D with
   MLS) at its default width, ``Simulator.run`` for 50 iterations with
   phase 7's checks, its chunk ms from CUDA events and the ms of its
   in-loop neighbor passes (filters, shear rate); for each motion problem
   one chunk from inside its bodies' motion windows, each body particle
   where the callback's velocity integrated over the chunk puts it; one
   MLS pass and one effective-viscosity pass at full width on the card
   against the CPU; the JAX goldens of DamBreakGate and WaveTank;
9. the general pair path (``ops/forces.py`` on ``neighbor_apply``): each
   configuration of ``GENERAL`` (Seiche with SPS and its gravity callback,
   RTInstability with Grenier, BiFluidPoiseuille with Hu & Adams,
   Poiseuille with Espanol-Revenga, Bubble at twice its default dp) at its
   default width (Bubble also at its default dp, in chunks of 2 steps), a
   warm-up chunk from the build and one timed chunk (CUDA
   events), phase 4's checks and no forces-kernel launch; its particles,
   pair slots per pass, ms per general forces pass and per Grenier / SPS
   pass; Seiche's timed chunk inside the callback's window, the gravity of
   every pass against the callback at t and t + dt/2; one general pass, its
   Grenier and SPS passes card vs CPU at the reduced widths of
   ``GENERAL_CPU``; the general path against the forces kernel on
   DamBreak3D at dp 0.012; the JAX goldens of RTInstability and Bubble;
10. the granular Jacobi solver, the DEM terrain, OilJet and Generic:
   LithostaticLJ at its default dp and LithostaticDYN at dp 0.1 (a warm-up
   and a timed chunk, phase 4's checks, no forces-kernel launch, the Jacobi
   iterations of every solve and ms per iteration; the effective pressure
   after the cold solve linear in depth, its slope printed beside
   (rho_sed - rho_w) g, and the cold solve's slope at dp 0.1 within 1% of
   the JAX package's: neither package comes within 15% of (rho_sed -
   rho_w) g, ROADMAP section 3); DamBreakMobileBed at its
   default width, one forces phase part by part (surface detection, the
   Jacobi solve and its iterations, CALC_VISC, the general pass), and one
   chunk of 4 steps from its build at twice its dp; DEMExample at its default dp for
   50 iterations (two forces-kernel launches per step, no fluid particle
   below the terrain, kernel vs plain version on the final state); OilJet
   (the piston's chunk against its integrated callback, then a timed chunk
   on the general path); Generic, an INI file with an STL obstacle written
   into a temporary directory, through the CLI on the card; card vs CPU at
   reduced widths: the surface flags exact, a fixed-count Jacobi solve,
   the DEM force;
11. SA walls on the gamma-quadrature path (``ops/sa.py``): StillWaterSA
   ``--density_sum 0`` at its default width (ppH 24), a warm-up and a timed
   chunk, phase 9's checks (no forces-kernel launch, ``n_active``
   conserved, a finite state, dt > 1e-10) and no fluid particle outside the
   SA box; the hydrostatic error over the central column, printed; the ms of
   the gamma, wall-condition and SA general passes on the final state, with
   their pair slots and fluid-segment pairs; at ppH 10 the flat-wall
   oracles of ``tests/test_sa.py`` on the card, and the gamma, the wall
   density and one SA general pass card vs CPU;
12. density summation and the dynamic gamma on SA walls
   (``ops/density_sum.py``): StillWaterSA at its default (density
   summation) and width, a warm-up chunk through ``Simulator.run`` (gamma
   seeded by quadrature) and a timed chunk with its peak device memory,
   phase 11's checks and the JAX density-sum test's bars (|rho| < 0.2,
   gamma in [0.1, 1]); the ms of ``volumic_terms``,
   ``gamma_boundary_terms``, ``apply_density_diffusion`` and
   ``density_sum_update`` on the final state; the static identity, and
   gamma integrated over a rigid displacement against the quadrature; the
   passes card vs CPU at ppH 10; BiFluidPoiseuilleSA (periodic SA plates):
   the n+1 grad gamma at no motion against the quadrature, and one chunk;
   LithostaticSA at dp 0.1, a chunk with its cold EFFPRES solve and the
   effective pressure's slope; StillWaterRepackSA through the CLI
   (``--repack``, then 10 iterations).

Each phase prints its host seconds (``[time]``), and the script its total
before the kernels' line.  Then one JSON line describing each kernel, and
last the ``ok`` line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SCRIPT_T0 = time.perf_counter()  # the script's total counts from here
ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# f32 operations of the forces kernel under the DamBreak3D options
# (Wendland, SPH_F1, DYN, artificial viscosity, Colagrossi diffusion,
# moving-body feedback), counted from _pair_chunk and csrc/forces.cu.
# Every candidate pair pays the offset (3), r^2 (5) and the range test (2);
# the kernel skips the rest unless 0 < r^2 < rad^2.  An in-range pair then
# pays sqrt (1), Wendland F (5), relative velocity + v.r (8), m*F (1), DYN
# continuity gate (4), DrDt term (2), fluid-fluid factor (1), g.r (5),
# Colagrossi gate + term (13), momentum gate with feedback (3), pressure
# term (1), s (3), artificial viscosity (11) and accumulation (7).
CANDIDATE_FLOPS = 10
IN_RANGE_FLOPS_DAMBREAK3D = 65

# tolerances of tests/test_forces_pallas.py: the kernel sums in another
# order than the plain version
RTOL = 2e-3
ATOL_DRDT = 1e-6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``n`` calls, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def random_scene(rng, dp, n_fluid=150, n_bound=60, box=0.3):
    """Random fluid blob + boundary particles (the scene of
    tests/test_forces.py:make_random_scene), as numpy arrays."""
    from gpusph_tpu_torch.defs import ParticleType

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


def small_configs():
    """The six framework configurations of tests/test_forces_pallas.py."""
    from gpusph_tpu_torch import (BoundaryType, DensityDiffusionType, Fluid,
                                  PhysParams, RheologyType, SimFlags, SimParams,
                                  TurbulenceModel, setup_framework)

    dp = 0.02

    def fw(boundary, turb, kinvisc, diffusion, xi=0.0, flags=None):
        kw = {} if flags is None else dict(flags=flags)
        return setup_framework(
            boundary=boundary, turbulence_model=turb,
            rheology=RheologyType.NEWTONIAN if kinvisc > 0 else RheologyType.INVISCID,
            density_diffusion=diffusion,
            simparams=SimParams(deltap=dp, max_parts_per_cell=32,
                                densityDiffCoeff=xi if xi else float("nan")),
            physparams=PhysParams(
                fluids=(Fluid(rho0=1000.0, gamma=7.0, c0=30.0, kinematic_visc=kinvisc),),
                gravity=(0.0, 0.0, -9.81), dcoeff=50.0),
            **kw).finalize()

    DYN, LJ = BoundaryType.DYN_BOUNDARY, BoundaryType.LJ_BOUNDARY
    ART, LAM = TurbulenceModel.ARTIFICIAL, TurbulenceModel.LAMINAR_FLOW
    NONE, COL = DensityDiffusionType.NONE, DensityDiffusionType.COLAGROSSI
    return dp, {
        "dyn_artvisc": fw(DYN, ART, 0.0, NONE),
        "lj": fw(LJ, ART, 0.0, NONE),
        "laminar": fw(DYN, LAM, 1e-4, NONE),
        "colagrossi": fw(DYN, ART, 0.0, COL, xi=0.1),
        "xsph": fw(DYN, ART, 0.0, NONE,
                   flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_XSPH),
        "internal_energy": fw(DYN, ART, 0.0, NONE,
                              flags=SimFlags.ENABLE_DTADAPT | SimFlags.ENABLE_INTERNAL_ENERGY),
    }


# the forces kernel's thread mapping (csrc/forces.cu): a warp holds 8
# consecutive centrals of a block, each with 4 slot lanes; lane l owns the
# slots l + 4j, j = 0..31, of a tile
LANES = 4
WARP = 32
CPW = WARP // LANES  # centrals per warp


def pair_stats(P, plan, capacity, rad2, chunk=256, grid=None):
    """The work of one forces pass of property table ``P`` over ``plan``,
    counted from the data:

    * candidates: real centrals x slots of the groups the plan kept;
    * in_range: those with 0 < r^2 < rad^2, whose physics the kernel
      evaluates (offsets by minimum image along the periodic axes of
      ``grid``, as the kernel takes them);
    * warp_tiles: (warp, tile) pairs of warps that hold a real central (the
      kernel skips the others);
    * body_compacted: the pair-body iterations of those warps, max-popcount
      per tile, the largest number of in-range slots among a warp's 32
      threads;
    * body_slotwise: what a warp stepping through its slot indices j
      together would issue instead, one for each j where any of its threads
      is in range."""
    import torch

    from gpusph_tpu_torch.ops.block_plan import B, GPT, GROUP, TS

    nb = plan.n_blocks
    dev = P.device
    n_groups = P.shape[0] // GROUP - 1  # group n_groups is the pad sentinel
    pos = P[:, :3]
    rad2_t = torch.tensor(rad2, dtype=torch.float32, device=dev)
    t_used = int(plan.tile_off[-1])
    tb = plan.tile_block[:t_used].long()
    cen = plan.cen_idx[: nb * B].long().reshape(nb, B)
    fg = plan.flat_groups[: t_used * GPT].long().reshape(t_used, GPT)
    real = cen < capacity
    kept_slots = (fg < n_groups).sum(dim=1) * GROUP
    candidates = int((real.sum(dim=1)[tb] * kept_slots).sum())
    live = real.reshape(nb, B // CPW, CPW).any(dim=2)  # [nb, warps]
    warp_tiles = int(live[tb].sum())
    lane = torch.arange(GROUP, device=dev)
    periodic = [] if grid is None else [
        (a, grid.world_size[a]) for a in range(3) if int(grid.periodic) & (1 << a)]
    in_range = body_compacted = body_slotwise = 0
    for s in range(0, t_used, chunk):
        e = min(s + chunk, t_used)
        c = pos[cen[tb[s:e]]]  # [tiles, B, 3]
        w = pos[(fg[s:e, :, None] * GROUP + lane).reshape(e - s, TS)]  # [tiles, TS, 3]
        d = c[:, :, None, :] - w[:, None, :, :]
        for a, L in periodic:
            d[..., a] -= L * torch.round(d[..., a] * (1.0 / L))
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        hit = (r2 > 0) & (r2 < rad2_t)  # [tiles, B, TS]
        in_range += int(hit.sum())
        # centrals -> [warp, central]; slot lane + 4j -> [j, lane]
        hit = hit.reshape(e - s, B // CPW, CPW, TS // LANES, LANES)
        body_compacted += int(hit.sum(dim=3).amax(dim=(2, 3)).sum())
        body_slotwise += int(hit.any(dim=4).any(dim=2).sum())
    return dict(candidates=candidates, in_range=in_range, warp_tiles=warp_tiles,
                body_compacted=body_compacted, body_slotwise=body_slotwise)


def compaction(stats):
    """The compaction figure of ``pair_stats``: the mean popcount of a
    thread against the mean of its warp's max popcount, over (warp, tile);
    their ratio is the share of the body iterations a warp issues that do
    useful work on a lane."""
    n = max(stats["warp_tiles"], 1)
    mean_pop = stats["in_range"] / (WARP * n)
    mean_max = stats["body_compacted"] / n
    return dict(mean_popcount=mean_pop, mean_max_popcount=mean_max,
                useful_share=mean_pop / mean_max if mean_max else 0.0,
                slotwise_per_warp_tile=stats["body_slotwise"] / n)


def compare_kernel(fw, grid, state):
    """Kernel vs plain version on the card for one sorted state, with the
    effective viscosity where the rheology needs it.  Returns (ok, max
    |DvDt| error, report dict)."""
    import torch

    from gpusph_tpu_torch import SimFlags
    from gpusph_tpu_torch.ops.block_plan import build_block_plan
    from gpusph_tpu_torch.ops.forces_kernel import (finalize_forces, pair_forces,
                                                    pair_forces_reference,
                                                    prop_table)
    from gpusph_tpu_torch.ops.neighbors import build_cells

    from gpusph_tpu_torch.ops.visc import effective_viscosity

    st, aux = build_cells(grid, state)
    plan = build_block_plan(fw, grid, st, aux)
    effvisc = (effective_viscosity(fw, grid, st, aux)
               if fw.visc.needs_effective_visc else None)
    P = prop_table(fw, st, effvisc)
    got = finalize_forces(fw, st, plan, pair_forces(fw, grid, P, plan), effvisc)
    ref = finalize_forces(fw, st, plan, pair_forces_reference(fw, grid, P, plan), effvisc)
    torch.cuda.synchronize()
    act = st.active
    rep = {}
    ok = True
    dv_ref = ref.DvDt[act]
    checks = {
        "DvDt": (got.DvDt[act], dv_ref, 1e-4 * float(dv_ref.abs().max())),
        "DrDt": (got.DrDt[act], ref.DrDt[act], ATOL_DRDT),
    }
    if fw.has_xsph:
        checks["xsph"] = (got.xsph[act], ref.xsph[act],
                          1e-4 * float(ref.xsph[act].abs().max()))
    if fw.flags & SimFlags.ENABLE_INTERNAL_ENERGY:
        checks["DEDt"] = (got.DEDt[act], ref.DEDt[act],
                          1e-4 * float(ref.DEDt[act].abs().max()))
    for name, (a, b, atol) in checks.items():
        if not bool(torch.isfinite(a).all()):
            ok = False
            rep[name] = "non-finite"
            continue
        err = (a - b).abs()
        excess = float((err - (atol + RTOL * b.abs())).max())
        rep[name] = dict(max_abs_err=float(err.max()), ref_max=float(b.abs().max()),
                         atol=atol, worst_excess=excess)
        ok &= excess <= 0.0
    return ok, float((got.DvDt[act] - dv_ref).abs().max()), rep


# phase 6 tolerances: the resume runs the same deterministic kernels from a
# bit-exact checkpoint, but the body-force reduction sums with index_add_
# (atomics on the card), so the state is held within RESUME_POS_TOL metres
# rather than bit for bit; the post-process pass on the card and on the CPU
# sums its pairs in another order
RESUME_POS_TOL = 1e-6
POST_RTOL = 1e-5
POST_ATOL_FRAC = 1e-6
OUTPUT_DP = 0.012
OUTPUT_ITERS = 50
REPACK_MAXITER = 10


# phase 7: the problems of the catalog that run on the forces kernel, at
# their default (full) widths, cut to CATALOG_ITERS iterations
CATALOG = ("StillWater", "Poiseuille", "OpenChannel", "LockExchange", "AccuracyTest",
           "Spheric2", "BuoyancyTest", "Objects", "DynBoundsExample", "ProblemExample")
CATALOG_ITERS = 50
# the goldens of tests/references (written by the JAX package on the CPU) with
# the options of scripts/check_problem.py; Poiseuille_100.npz is left out: the
# JAX package itself no longer meets it (dt 0.00352083 against the file's
# 0.00513873, position drift 3.25e-3 m)
GOLDENS = {"StillWater": dict(ppH=10, max_ppc=56), "LockExchange": dict(ppH=12, max_ppc=64),
           "OpenChannel": dict(deltap=0.05), "Spheric2": dict(deltap=0.05),
           "BuoyancyTest": dict(deltap=0.04)}
GOLDEN_ITERS = 100
# Poiseuille at ppH 32 from the analytic profile: L2 error of the fluid x
# velocity at most POISEUILLE_L2 of the peak after POISEUILLE_ITERS iterations
POISEUILLE_ITERS = 500
POISEUILLE_L2 = 0.05


def golden_drift(name, opts, iters):
    """Run ``name`` with ``opts`` for ``iters`` iterations on the card; the
    max |drift| of pos, vel and rho from ``tests/references/<name>_<iters>.npz``
    (by particle id), the position limit 1e-3 max|pos|, the reference's dt
    and the run's."""
    from gpusph_tpu_torch.integrator import Simulator
    from gpusph_tpu_torch.problems.base import get_problem

    prob = get_problem(name)(dict(opts))
    grid, state0 = prob.build()
    sim = Simulator(prob.fw, grid, bodies_specs=prob.body_specs(), device="cuda")
    st = sim.run(state0, tend=0.0, maxiter=iters)
    ref = np.load(os.path.join(ROOT, "tests", "references", f"{name}_{iters}.npz"))
    act = st.active.cpu().numpy()
    ids = st.id.cpu().numpy().view(np.uint32)[act]
    order = np.argsort(ids)
    if not np.array_equal(ids[order], ref["ids"]):
        fail(f"golden {name}: particle ids differ")
    drift = {key: float(np.abs(getattr(st, key).cpu().numpy()[act][order] - ref[key]).max())
             for key in ("pos", "vel", "rho")}
    return drift, 1e-3 * float(np.abs(ref["pos"]).max()), float(ref["dt"]), sim.dt


def catalog_phase(card):
    """Phase 7: the catalog at full width (see the docstring)."""
    import torch

    from gpusph_tpu_torch.integrator import Simulator
    from gpusph_tpu_torch.ops import forces_kernel
    from gpusph_tpu_torch.ops.block_plan import build_block_plan
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.problems.base import get_problem
    from gpusph_tpu_torch.state import is_fluid

    for name in CATALOG:
        t0 = time.perf_counter()
        prob = get_problem(name)({})
        grid, state0 = prob.build()
        build_s = time.perf_counter() - t0
        sim = Simulator(prob.fw, grid, bodies_specs=prob.body_specs(), device="cuda")
        n0 = int(state0.count_active())
        forces_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run(state0, maxiter=CATALOG_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = forces_kernel.launches
        n1 = int(st.count_active())
        finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))
        fw = sim.fw
        sts, aux = build_cells(grid, st)
        plan = build_block_plan(fw, grid, sts, aux)
        P = forces_kernel.prop_table(fw, sts)
        kernel_ms = cuda_ms(lambda: forces_kernel.pair_forces(fw, grid, P, plan), 20)
        work = pair_stats(P, plan, sts.capacity, fw.sp.influenceradius ** 2, grid=grid)
        ok, _, rep = compare_kernel(fw, grid, st)
        parity = ", ".join(f"{k} {v['max_abs_err']:.3g} of {v['ref_max']:.3g}"
                           if isinstance(v, dict) else f"{k} {v}" for k, v in rep.items())
        say(f"[7 catalog] {name}: {n0} particles (build {build_s:.3f} s, grid "
            f"{'x'.join(map(str, grid.ncells))}, periodic {int(grid.periodic)}), "
            f"{CATALOG_ITERS} iterations in {wall:.3f} s = {n0 * CATALOG_ITERS / wall:.6g} "
            f"particle-steps/s (host clock to synchronize, first chunk included); "
            f"launches {launches}; n_active {n0} -> {n1}; finite {finite}; dt {sim.dt:.6g}; "
            f"forces kernel {kernel_ms:.6g} ms/launch (CUDA events, 20 launches) over "
            f"{int(plan.tile_off[-1])} tiles, {work['candidates']} candidate and "
            f"{work['in_range']} in-range pairs ({work['in_range'] / n0:.4g} per particle, "
            f"{kernel_ms * 1e9 / work['in_range']:.4g} ps each); kernel vs plain "
            f"{'ok' if ok else 'MISMATCH'}: {parity} [{card}]")
        if launches != 2 * CATALOG_ITERS:
            fail(f"{name}: forces kernel launched {launches} times in {CATALOG_ITERS} "
                 f"iterations, expected {2 * CATALOG_ITERS}")
        if n1 != n0 or not finite or not sim.dt > 1e-10:
            fail(f"{name}: n_active {n0} -> {n1}, finite {finite}, dt {sim.dt}")
        if not ok:
            fail(f"{name}: kernel disagrees with the plain version")

    for name, opts in GOLDENS.items():
        drift, limit, dt_ref, dt_now = golden_drift(name, opts, GOLDEN_ITERS)
        say(f"[7 golden] {name} {opts}, {GOLDEN_ITERS} iterations: max drift pos "
            f"{drift['pos']:.6g} (limit {limit:.6g}), vel {drift['vel']:.6g}, rho "
            f"{drift['rho']:.6g}; dt_ref {dt_ref:.6g} dt_now {dt_now:.6g} [{card}]")
        if not drift["pos"] <= limit:
            fail(f"golden {name}: pos drift above 1e-3 x max|pos|")

    prob = get_problem("Poiseuille")({"ppH": 32, "steady-init": True})
    grid, state0 = prob.build()
    sim = Simulator(prob.fw, grid, device="cuda")
    st = sim.run(state0, maxiter=POISEUILLE_ITERS)
    act = (st.active & is_fluid(st.info)).cpu().numpy()
    z, vx = st.pos.cpu().numpy()[act, 2], st.vel.cpu().numpy()[act, 0]
    v_ref = prob.compute_poiseuille_vel(z.astype(np.float64))
    l2 = float(np.sqrt(np.mean((vx - v_ref) ** 2)) / v_ref.max())
    linf = float(np.abs(vx - v_ref).max() / v_ref.max())
    say(f"[7 poiseuille] ppH 32 steady start, {sim.iterations} iterations to t {sim.t:.6g}: "
        f"fluid x velocity against the analytic profile, L2 {l2:.6g}, Linf {linf:.6g} of "
        f"the peak {v_ref.max():.6g} m/s (limit L2 {POISEUILLE_L2}) [{card}]")
    if not l2 <= POISEUILLE_L2:
        fail("Poiseuille: the velocity profile is off the analytic one")


# phase 8: the configurations of prescribed body motion, the density filters
# and the effective viscosity, at their default widths, cut to SLICE_ITERS
# iterations ("DamBreak3D-mls" is DamBreak3D with its density-diffusion 0)
SLICE = {"DamBreakGate": {}, "WaveTank": {}, "SolitaryWave": {}, "SlidingWedge": {},
         "OffshorePile": {}, "PoiseuillePapanastasiou": {},
         "DamBreak3D-mls": {"density-diffusion": 0}}
SLICE_ITERS = 50
# the motion check: one chunk from a time inside every body's motion window;
# each body particle within MOTION_RTOL x the body's displacement +
# MOTION_ATOL metres of where the callback's velocity, integrated over the
# chunk on the host (a midpoint sum of the steps against the integral, and
# f32 positions), puts it
MOTION_T0 = {"DamBreakGate": 0.15, "WaveTank": 0.5, "SolitaryWave": 0.5, "SlidingWedge": 1.0,
             "OffshorePile": 0.5, "OilJet": 0.05}
MOTION_RTOL = 1e-3
MOTION_ATOL = 5e-6
# the in-loop neighbor passes on the card against the CPU at full width: the
# pair sums are taken in another order, and MLS solves a 4x4 system per
# particle, whose condition number scales their rounding.  The shear rate is
# a velocity gradient: its components are held at the field's scale
# (SHEAR_ATOL_FRAC x max).  The Papanastasiou term takes 1 - exp(-m|S|) in
# f32 (the JAX package's formula) from m|S| = 1e-4 up, which keeps only
# 2^-24 / 1e-4 = 6e-4 of relative precision there, and the card's expf and
# the CPU's may differ by an ulp: the first chip run read 2.02e-4 against
# rtol 1e-4 at such a particle (PERF.md, PR 8), so the effective viscosity
# is held at EFFVISC_RTOL
PASS_RTOL = 1e-4
PASS_ATOL_FRAC = 1e-6
SHEAR_ATOL_FRAC = 1e-5
EFFVISC_RTOL = 1e-3
# the goldens of tests/references that the JAX package meets with drift 0
# (scripts/check_problem.py NAME --cpu --maxiter 100), at its options
SLICE_GOLDENS = {"DamBreakGate": dict(deltap=0.04), "WaveTank": dict(deltap=0.04)}


def slice_problem(name, **extra):
    """The problem of a SLICE key, built at its options and ``extra``."""
    from gpusph_tpu_torch.problems.base import get_problem

    prob = get_problem(name.split("-")[0])({**SLICE[name], **extra})
    return (prob, *prob.build())


def neighbor_passes(fw, grid, st):
    """The in-loop neighbor passes of ``fw`` on the sorted ``st``: a dict of
    name -> (function of no argument, passes per chunk)."""
    import torch

    from gpusph_tpu_torch.ops.filters import FILTERS
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.ops.visc import effective_viscosity

    sts, aux = build_cells(grid, st)
    cells = torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)
    steps = fw.sp.buildneibsfreq
    out = {}
    for ftype, freq in fw.filters:
        fn = FILTERS[ftype]
        out[fn.__name__] = (lambda fn=fn: fn(fw, grid, sts, aux, cells=cells), steps / freq)
    if fw.visc.needs_effective_visc:
        out["effective_viscosity"] = (
            lambda: effective_viscosity(fw, grid, sts, aux, cells=cells), 2 * steps)
    return out


def motion_check(name, prob, grid, state0, fw, dev, card, tag="8 motion"):
    """One chunk of ``name`` from MOTION_T0; fails unless every prescribed
    body moved as its callback says; prints under ``tag``."""
    import torch

    from gpusph_tpu_torch.bodies import init_bodies_state
    from gpusph_tpu_torch.integrator import make_sim_chunk
    from gpusph_tpu_torch.state import FG_MOVING_BOUNDARY, has_flag, object_num

    specs = prob.body_specs()
    t0 = MOTION_T0[name]
    st0 = state0.to(dev)
    bodies = init_bodies_state(specs, st0)
    dt0 = fw.sp.dt or 0.1 * fw.sp.slength / max(f.c0 for f in fw.pp.fluids)
    f32 = dict(dtype=torch.float32, device=dev)
    out = make_sim_chunk(fw, grid, bodies_specs=specs)(
        st0, torch.tensor(dt0, **f32), torch.tensor(t0, **f32), 0, bodies)
    t1 = float(out[2])
    ids0 = state0.id.numpy()
    order1 = np.argsort(out[0].id.cpu().numpy())
    pos1 = out[0].pos.cpu().numpy()[order1]  # by id: the build's row order
    pos0 = state0.pos.numpy().astype(np.float64)
    body_of = object_num(state0.info).numpy()
    moving = has_flag(state0.info, FG_MOVING_BOUNDARY).numpy()
    cg0 = bodies.cg.cpu().numpy().astype(np.float64)
    # the callback integrated over [t0, t1] by the midpoint rule, on the host
    n = 400
    mids = t0 + (np.arange(n) + 0.5) * (t1 - t0) / n
    worst, moved, report = 0.0, [], []
    for spec in specs:
        sel = moving & (body_of == spec.object_idx)
        if spec.motion is None or spec.object_idx == 0 or not sel.any():
            continue  # no prescribed motion, or a geometry too thin to hold particles
        vel = [spec.motion(torch.tensor(t, dtype=torch.float32)) for t in mids]
        disp = sum(lv.double().numpy() for lv, _ in vel) * (t1 - t0) / n
        theta = sum(av.double().numpy() for _, av in vel) * (t1 - t0) / n
        angle = float(np.linalg.norm(theta))
        k = theta / angle if angle > 0 else np.zeros(3)
        arm = pos0[sel] - cg0[spec.object_idx]
        rot = (arm * np.cos(angle) + np.cross(k, arm) * np.sin(angle)
               + k * (arm @ k)[:, None] * (1 - np.cos(angle)))
        want = cg0[spec.object_idx] + disp + rot
        got = pos1[ids0[sel]]
        shift = float(np.abs(want - pos0[sel]).max())
        err = float(np.abs(got - want).max())
        limit = MOTION_RTOL * shift + MOTION_ATOL
        worst = max(worst, err - limit)
        moved.append(shift)
        report.append(f"body {spec.object_idx}: moved {shift:.6g} m, off by {err:.3g} "
                      f"(limit {limit:.3g})")
    say(f"[{tag}] {name}: one chunk from t {t0} to {t1:.6g}: " + "; ".join(report)
        + f" [{card}]")
    if not moved or worst > 0 or min(moved) <= 10 * MOTION_ATOL:
        fail(f"{name}: a prescribed body did not move as its callback says")


def slice_phase(dev, card):
    """Phase 8 (see the docstring)."""
    import torch

    from gpusph_tpu_torch.integrator import Simulator, make_sim_chunk
    from gpusph_tpu_torch.ops import forces_kernel
    from gpusph_tpu_torch.ops.block_plan import build_block_plan
    from gpusph_tpu_torch.ops.eos import physical_density
    from gpusph_tpu_torch.ops.filters import mls_filter
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.ops.visc import effective_viscosity, shear_rate_tensor
    from gpusph_tpu_torch.state import fluid_num, is_fluid

    phase_t0 = time.perf_counter()
    for name in SLICE:
        t0 = time.perf_counter()
        prob, grid, state0 = slice_problem(name)
        build_s = time.perf_counter() - t0
        specs = prob.body_specs()
        sim = Simulator(prob.fw, grid, bodies_specs=specs, device="cuda")
        fw = sim.fw
        n0 = int(state0.count_active())
        forces_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run(state0, maxiter=SLICE_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = forces_kernel.launches
        n1 = int(st.count_active())
        finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))
        # one more chunk from the run's end, and the kernel, on its final state
        chunk = make_sim_chunk(fw, grid, bodies_specs=specs)
        dt_t = torch.tensor(sim.dt, dtype=torch.float32, device=dev)
        t_t = torch.tensor(sim.t, dtype=torch.float32, device=dev)
        chunk_ms = cuda_ms(lambda: chunk(st, dt_t, t_t, sim.iterations, sim.bodies), 2,
                           warmup=1)
        sts, aux = build_cells(grid, st)
        plan = build_block_plan(fw, grid, sts, aux)
        P = forces_kernel.prop_table(fw, sts)
        kernel_ms = cuda_ms(lambda: forces_kernel.pair_forces(fw, grid, P, plan), 20)
        ok, _, rep = compare_kernel(fw, grid, st)
        parity = ", ".join(f"{k} {v['max_abs_err']:.3g} of {v['ref_max']:.3g}"
                           if isinstance(v, dict) else f"{k} {v}" for k, v in rep.items())
        passes = neighbor_passes(fw, grid, st)
        pass_ms = {k: (cuda_ms(fn, 3, warmup=1), per) for k, (fn, per) in passes.items()}
        in_loop = sum(ms * per for ms, per in pass_ms.values())
        say(f"[8 slice] {name}: {n0} particles (build {build_s:.3f} s, grid "
            f"{'x'.join(map(str, grid.ncells))}, periodic {int(grid.periodic)}, "
            f"{len(specs)} bodies), {SLICE_ITERS} iterations in {wall:.3f} s = "
            f"{n0 * SLICE_ITERS / wall:.6g} particle-steps/s (host clock to synchronize, "
            f"first chunk included); launches {launches}; n_active {n0} -> {n1}; finite "
            f"{finite}; dt {sim.dt:.6g}; t {sim.t:.6g}; one chunk from iteration "
            f"{sim.iterations} {chunk_ms:.6g} ms (CUDA events) = "
            f"{n0 * fw.sp.buildneibsfreq / chunk_ms * 1e3:.6g} particle-steps/s; forces kernel "
            f"{kernel_ms:.6g} ms/launch; in-loop neighbor passes "
            + ("none" if not pass_ms else ", ".join(
                f"{k} {ms:.6g} ms x {per:g} per chunk" for k, (ms, per) in pass_ms.items())
               + f" = {in_loop:.6g} ms per chunk")
            + f"; kernel vs plain {'ok' if ok else 'MISMATCH'}: {parity} [{card}]")
        if launches != 2 * SLICE_ITERS:
            fail(f"{name}: forces kernel launched {launches} times in {SLICE_ITERS} "
                 f"iterations, expected {2 * SLICE_ITERS}")
        if n1 != n0 or not finite or not sim.dt > 1e-10:
            fail(f"{name}: n_active {n0} -> {n1}, finite {finite}, dt {sim.dt}")
        if not ok:
            fail(f"{name}: kernel disagrees with the plain version")
        if name in MOTION_T0:
            motion_check(name, prob, grid, state0, fw, dev, card)

    # one MLS pass and the effective-viscosity passes at full width, card vs
    # CPU, each on the state of a 20-iteration run; PoiseuillePapanastasiou
    # from rest (the first chip run's state) and from the Newtonian profile,
    # where the shear rate spans 0 to its wall value
    for name, extra in (("DamBreak3D-mls", {}), ("PoiseuillePapanastasiou", {}),
                        ("PoiseuillePapanastasiou", {"steady-init": True})):
        prob, grid, state0 = slice_problem(name, **extra)
        fw = prob.fw.finalize()
        sim = Simulator(fw, grid, bodies_specs=prob.body_specs(), device="cuda")
        st = sim.run(state0, maxiter=20)
        sts, aux = build_cells(grid, st)
        cpu_st, cpu_aux = build_cells(grid, st.to("cpu"))
        if not torch.equal(sts.id.cpu(), cpu_st.id):
            fail(f"{name}: the card and the CPU sort the particles differently")
        sel = (sts.active & is_fluid(sts.info)).cpu()

        def fluid_rows(v):
            return v[sel.to(v.device)]

        if name == "DamBreak3D-mls":
            def density(s):
                return fluid_rows(physical_density(fw.pp, s.rho, fluid_num(s.info)))

            checks = [("mls_filter", "the fluid's physical density",
                       lambda st_, aux_: density(mls_filter(fw, grid, st_, aux_)),
                       PASS_RTOL, PASS_ATOL_FRAC)]
        else:
            checks = [
                ("shear_rate_tensor", "its 6 components",
                 lambda st_, aux_: fluid_rows(shear_rate_tensor(fw, grid, st_, aux_)),
                 PASS_RTOL, SHEAR_ATOL_FRAC),
                ("effective_viscosity", "the fluid's kinematic viscosity",
                 lambda st_, aux_: fluid_rows(effective_viscosity(fw, grid, st_, aux_)),
                 EFFVISC_RTOL, PASS_ATOL_FRAC)]
        for what, of, fn, rtol, atol_frac in checks:
            a = fn(sts, aux).cpu().numpy()
            t0 = time.perf_counter()
            b = fn(cpu_st, cpu_aux).numpy()
            cpu_s = time.perf_counter() - t0
            card_ms = cuda_ms(lambda: fn(sts, aux), 3, warmup=1)
            diff = np.abs(a - b)
            excess = diff - (atol_frac * float(np.abs(b).max()) + rtol * np.abs(b))
            worst = np.unravel_index(int(np.argmax(excess)), b.shape)
            say(f"[8 pass] {what} on {name}{' ' + str(extra) if extra else ''} "
                f"({int(sts.count_active())} particles, after 20 iterations), {of}: card vs CPU max abs diff {float(diff.max()):.6g}, max "
                f"rel {float((diff / np.maximum(np.abs(b), 1e-30)).max()):.3g} (rtol {rtol}, "
                f"atol {atol_frac} x max {float(np.abs(b).max()):.6g}; worst at value "
                f"{float(b[worst]):.6g}); {card_ms:.6g} ms on the card (CUDA events), "
                f"{cpu_s:.3f} s on the host CPU [{card}]")
            if not (np.isfinite(a).all() and float(excess.max()) <= 0):
                fail(f"{what}: the card disagrees with the CPU")

    for name, opts in SLICE_GOLDENS.items():
        drift, limit, dt_ref, dt_now = golden_drift(name, opts, GOLDEN_ITERS)
        say(f"[8 golden] {name} {opts}, {GOLDEN_ITERS} iterations: max drift pos "
            f"{drift['pos']:.6g} (limit {limit:.6g}), vel {drift['vel']:.6g}, rho "
            f"{drift['rho']:.6g}; dt_ref {dt_ref:.6g} dt_now {dt_now:.6g} [{card}]")
        if not drift["pos"] <= limit:
            fail(f"golden {name}: pos drift above 1e-3 x max|pos|")
    say(f"[8 golden] phase 8 took {time.perf_counter() - phase_t0:.1f} s (host clock)")


# phase 9: the general pair path at default width, one warm-up and one timed
# chunk each; "Poiseuille-er" is Poiseuille with Espanol-Revenga, and Bubble
# also runs at twice its default dp (78,849 particles against 487,620)
BUBBLE_DP = 0.128 * 0.025 / 1.3  # Bubble's default dp (h/R = 0.128)
GENERAL = {"Seiche": {}, "RTInstability": {}, "BiFluidPoiseuille": {},
           "Poiseuille-er": {"viscmodel": 2}, "Bubble-2dp": {"deltap": 2 * BUBBLE_DP},
           "Bubble": {}}
# Seiche starts inside its gravity callback's window (0.3 s, 3.0 s)
GENERAL_T0 = {"Seiche": 0.35}
# the steps of a chunk where the phase cuts its depth to make room for later
# phases (default: the problem's buildneibsfreq, 10): Bubble at its default
# width takes 18.6-23.7 s a chunk of 10 steps (PERF.md)
GENERAL_STEPS = {"Bubble": 2}
# card vs CPU: one chunk on the card at a width whose passes the host CPU
# takes in seconds, then each pass of its final state on both devices with
# the same inputs, at phase 8's tolerances.  Grenier's density is held as the
# physical density (rho/rho0 - 1 of an f32 density near 1000 resolves 6e-8,
# as phase 8 holds MLS), and its forces pass on the CPU takes the card's
# particle volume exp(J) V0 (as J = 0, V0 = the card's volume): Colagrossi's
# volume-ratio term takes V_a/V_b - 1 in f32, about 1e-5 between hydrostatic
# neighbours, so an ulp of either device's expf moves a pair's term by 1e-2
# relative (on an H100: DrDt 7.13e-05 of 0.554 with each device's own
# volume); that difference is printed, not held.  DrDt also keeps phase 3's
# absolute floor ATOL_DRDT: where the continuity terms cancel, as in
# BiFluidPoiseuille's parallel shear flow (max |DrDt| 6.5e-09 after one
# chunk on an H100), the sum is rounding noise
GENERAL_CPU = {"Seiche": {"deltap": 0.025}, "RTInstability": {"deltap": 0.02},
               "BiFluidPoiseuille": {}, "Poiseuille-er": {"viscmodel": 2, "ppH": 16},
               "Bubble-2dp": {"deltap": 4 * BUBBLE_DP}}
# the gravity a pass used against the callback evaluated on the host in
# float64 (f32 sine on either side)
GRAVITY_ATOL = 1e-5
# the goldens of tests/references that the JAX package meets with drift 0
# (scripts/check_problem.py NAME --cpu --maxiter 100), at its options
GENERAL_GOLDENS = {"RTInstability": dict(deltap=0.04), "Bubble": dict(deltap=0.05)}


def general_problem(name, opts):
    """The problem of a GENERAL key, built at ``opts``: (problem, framework,
    grid, state)."""
    from gpusph_tpu_torch.problems.base import get_problem

    prob = get_problem(name.split("-")[0])(dict(opts))
    grid, state = prob.build()
    return prob, prob.fw.finalize(), grid, state


def general_inputs(fw, grid, st):
    """The sorted state, its tables and occupied cells, and the per-pass
    inputs a chunk computes before the general pass (Grenier's sigma and
    density, the SPS stress, the effective viscosity)."""
    import torch

    from gpusph_tpu_torch.defs import SPHFormulation, TurbulenceModel
    from gpusph_tpu_torch.ops.grenier import grenier_density_sigma
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.ops.visc import effective_viscosity, sps_stress

    sts, aux = build_cells(grid, st)
    cells = torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)
    kw = {}
    if fw.sph_formulation == SPHFormulation.SPH_GRENIER:
        kw["sigma"], rho = grenier_density_sigma(fw, grid, sts, aux, cells=cells)
        sts = sts.replace(rho=rho)
    if fw.visc.turbmodel == TurbulenceModel.SPS:
        kw["sps_tau"], _ = sps_stress(fw, grid, sts, aux, cells=cells)
    if fw.visc.needs_effective_visc:
        kw["effvisc"] = effective_viscosity(fw, grid, sts, aux, cells=cells)
    return sts, aux, cells, kw


def held(a, b, rtol, atol_frac, atol_floor=0.0):
    """(ok, max abs diff, max |b|) of ``a`` against ``b`` at rtol + the
    larger of atol_frac x max|b| and atol_floor (numpy arrays)."""
    diff = np.abs(a - b)
    scale = float(np.abs(b).max()) if b.size else 0.0
    atol = max(atol_frac * scale, atol_floor)
    ok = bool(np.isfinite(a).all()) and bool((diff <= atol + rtol * np.abs(b)).all())
    return ok, float(diff.max()) if b.size else 0.0, scale


def general_phase(dev, card, dam):
    """Phase 9 (see the docstring); ``dam`` is phase 3's (framework, grid,
    state) of DamBreak3D at dp 0.012."""
    import dataclasses

    import torch

    from gpusph_tpu_torch.bodies import init_bodies_state
    from gpusph_tpu_torch.integrator import make_sim_chunk
    from gpusph_tpu_torch.ops import forces_kernel
    from gpusph_tpu_torch.ops.block_plan import build_block_plan
    from gpusph_tpu_torch.ops.eos import physical_density
    from gpusph_tpu_torch.ops.forces import compute_forces
    from gpusph_tpu_torch.ops.grenier import grenier_density_sigma, grenier_volume
    from gpusph_tpu_torch.ops.visc import sps_stress
    from gpusph_tpu_torch.state import fluid_num

    phase_t0 = time.perf_counter()
    f32 = dict(dtype=torch.float32, device=dev)

    def start(prob, fw, grid, state0, name, record=None):
        """The chunk function and its first arguments on the card."""
        if record is not None:
            cb = fw.gcallback

            def recorded(t):
                g = cb(t)
                record.append((t.clone(), *(c.clone() for c in g)))
                return g

            fw = dataclasses.replace(fw, gcallback=recorded)
        specs = prob.body_specs()
        st0 = state0.to(dev)
        dt0 = fw.sp.dt or 0.1 * fw.sp.slength / max(f.c0 for f in fw.pp.fluids)
        args = (st0, torch.tensor(dt0, **f32), torch.tensor(GENERAL_T0.get(name, 0.0), **f32),
                0, init_bodies_state(specs, st0))
        return make_sim_chunk(fw, grid, bodies_specs=specs), args

    for name, opts in GENERAL.items():
        t0 = time.perf_counter()
        prob, fw, grid, state0 = general_problem(name, opts)
        if name in GENERAL_STEPS:
            fw = dataclasses.replace(fw, simparams=dataclasses.replace(
                fw.sp, buildneibsfreq=GENERAL_STEPS[name]))
        build_s = time.perf_counter() - t0
        record = [] if fw.gcallback is not None else None
        chunk, args = start(prob, fw, grid, state0, name, record)
        n0 = int(state0.count_active())
        forces_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = chunk(*args)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if record is not None:
            record.clear()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        out = chunk(*warm[:5])
        end.record()
        torch.cuda.synchronize()
        chunk_ms = begin.elapsed_time(end)
        launches = forces_kernel.launches
        st, dt1 = out[0], float(out[1])
        n1 = int(st.count_active())
        finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))

        sts, aux, cells, kw = general_inputs(fw, grid, st)
        K = fw.sp.max_parts_per_cell
        slots = int(cells.shape[0]) * K * 27 * K
        t_end = out[2]
        pass_ms = cuda_ms(lambda: compute_forces(fw, grid, sts, aux, dt=out[1], t=t_end,
                                                 cells=cells, **kw), 3, warmup=1)
        extra_ms = {}
        if "sigma" in kw:
            extra_ms["grenier_density_sigma"] = cuda_ms(
                lambda: grenier_density_sigma(fw, grid, sts, aux, cells=cells), 3, warmup=1)
        if "sps_tau" in kw:
            extra_ms["sps_stress"] = cuda_ms(
                lambda: sps_stress(fw, grid, sts, aux, cells=cells), 3, warmup=1)
        steps = fw.sp.buildneibsfreq
        say(f"[9 general] {name}: {n0} particles (build {build_s:.3f} s, grid "
            f"{'x'.join(map(str, grid.ncells))}, periodic {int(grid.periodic)}, K {K}); "
            f"warm-up chunk {warm_s:.3f} s (host clock), timed chunk of {steps} steps from t "
            f"{float(warm[2]):.6g} {chunk_ms:.6g} ms (CUDA events) = "
            f"{n0 * steps / chunk_ms * 1e3:.6g} particle-steps/s; forces-kernel launches "
            f"{launches}; n_active {n0} -> {n1}; finite {finite}; dt {dt1:.6g}; "
            f"{cells.shape[0]} occupied cells, {slots} pair slots per pass; general forces "
            f"pass {pass_ms:.6g} ms ({pass_ms * 1e6 / slots:.4g} ns per slot) x "
            f"{2 * steps} per chunk"
            + "".join(f"; {k} {ms:.6g} ms ({ms * 1e6 / slots:.4g} ns per slot) x {2 * steps}"
                      for k, ms in extra_ms.items()) + f" [{card}]")
        if launches != 0:
            fail(f"{name}: the forces kernel launched {launches} times on the general path")
        if n1 != n0 or not finite or not dt1 > 1e-10:
            fail(f"{name}: n_active {n0} -> {n1}, finite {finite}, dt {dt1}")

        if record is not None:
            gravity_check(name, fw, grid, warm, record, sts, aux, cells, kw, card)

    # one general pass and its Grenier / SPS passes, card vs CPU
    for name, opts in GENERAL_CPU.items():
        prob, fw, grid, state0 = general_problem(name, opts)
        chunk, args = start(prob, fw, grid, state0, name)
        out = chunk(*args)
        st = out[0]
        sts, aux, cells, kw = general_inputs(fw, grid, st)
        cpu_st, cpu_aux, cpu_cells, cpu_kw = general_inputs(fw, grid, st.to("cpu"))
        if not torch.equal(sts.id.cpu(), cpu_st.id):
            fail(f"{name}: the card and the CPU sort the particles differently")
        act = sts.active.cpu().numpy()
        rows = {}
        for k, v in kw.items():  # the passes before the forces pass
            rows[k] = (v.cpu().numpy()[act], cpu_kw[k].numpy()[act])
        if "sigma" in kw:
            rows["grenier density"] = (
                physical_density(fw.pp, sts.rho, fluid_num(sts.info)).cpu().numpy()[act],
                physical_density(fw.pp, cpu_st.rho, fluid_num(cpu_st.info)).numpy()[act])
        # the forces pass on the CPU takes the card's inputs
        same_st = cpu_st.replace(rho=sts.rho.cpu())
        same_kw = {k: v.cpu() for k, v in kw.items()}
        t_pass = out[2]
        a = compute_forces(fw, grid, sts, aux, dt=out[1], t=t_pass, cells=cells, **kw)
        own = ""
        if "sigma" in kw:
            b_own = compute_forces(fw, grid, same_st, cpu_aux, dt=out[1].cpu(),
                                   t=t_pass.cpu(), cells=cpu_cells, **same_kw)
            own_err = float((a.DrDt.cpu() - b_own.DrDt)[torch.from_numpy(act)].abs().max())
            own = f"; DrDt with each device's own expf {own_err:.3g} (not held)"
            extras = dict(same_st.extras)
            extras["grenier_vol0"] = grenier_volume(sts).cpu()
            extras["grenier_J"] = torch.zeros_like(extras["grenier_J"])
            same_st = same_st.replace(extras=extras)
        t0 = time.perf_counter()
        b = compute_forces(fw, grid, same_st, cpu_aux, dt=out[1].cpu(), t=t_pass.cpu(),
                           cells=cpu_cells, **same_kw)
        cpu_s = time.perf_counter() - t0
        rows["DrDt"] = (a.DrDt.cpu().numpy()[act], b.DrDt.numpy()[act])
        rows["DvDt"] = (a.DvDt.cpu().numpy()[act], b.DvDt.numpy()[act])
        report, ok = [], True
        for k, (x, y) in rows.items():
            good, err, scale = held(x, y, PASS_RTOL, PASS_ATOL_FRAC,
                                    ATOL_DRDT if k == "DrDt" else 0.0)
            ok &= good
            report.append(f"{k} {err:.3g} of {scale:.3g}{'' if good else ' MISMATCH'}")
        say(f"[9 card-cpu] {name} {opts} ({int(sts.count_active())} particles, after one "
            f"chunk): card vs CPU max abs diff {', '.join(report)} (rtol {PASS_RTOL}, atol "
            f"{PASS_ATOL_FRAC} x max, at least {ATOL_DRDT} on DrDt){own}; the CPU pass took "
            f"{cpu_s:.3f} s [{card}]")
        if not ok:
            fail(f"{name}: the general path on the card disagrees with the CPU")

    # the general path against the forces kernel on the same state
    fw, grid, st = dam
    sts, aux, cells, kw = general_inputs(fw, grid, st)
    plan = build_block_plan(fw, grid, sts, aux)
    want = forces_kernel.compute_forces_kernel(fw, grid, sts, plan)
    got = compute_forces(fw, grid, sts, aux, cells=cells)
    torch.cuda.synchronize()
    act = sts.active.cpu().numpy()
    dv_ok, dv_err, dv_max = held(got.DvDt.cpu().numpy()[act], want.DvDt.cpu().numpy()[act],
                                 RTOL, 1e-4)
    dr_w = want.DrDt.cpu().numpy()[act]
    dr_diff = np.abs(got.DrDt.cpu().numpy()[act] - dr_w)
    dr_err = float(dr_diff.max())
    dr_ok = bool((dr_diff <= ATOL_DRDT + RTOL * np.abs(dr_w)).all())
    path_ms = cuda_ms(lambda: compute_forces(fw, grid, sts, aux, cells=cells), 2, warmup=1)
    K = fw.sp.max_parts_per_cell
    say(f"[9 path] DamBreak3D dp 0.012 ({int(sts.count_active())} particles): general path vs "
        f"forces kernel, DvDt max abs diff {dv_err:.3g} of {dv_max:.3g}, DrDt {dr_err:.3g} "
        f"(rtol {RTOL}, atol 1e-4 x max|DvDt|, {ATOL_DRDT} on DrDt); general pass "
        f"{path_ms:.6g} ms over {int(cells.shape[0]) * K * 27 * K} pair slots [{card}]")
    if not (dv_ok and dr_ok):
        fail("DamBreak3D: the general path disagrees with the forces kernel")

    for name, opts in GENERAL_GOLDENS.items():
        drift, limit, dt_ref, dt_now = golden_drift(name, opts, GOLDEN_ITERS)
        say(f"[9 golden] {name} {opts}, {GOLDEN_ITERS} iterations: max drift pos "
            f"{drift['pos']:.6g} (limit {limit:.6g}), vel {drift['vel']:.6g}, rho "
            f"{drift['rho']:.6g}; dt_ref {dt_ref:.6g} dt_now {dt_now:.6g} [{card}]")
        if not drift["pos"] <= limit:
            fail(f"golden {name}: pos drift above 1e-3 x max|pos|")
    say(f"[9 golden] phase 9 took {time.perf_counter() - phase_t0:.1f} s (host clock)")


# phase 10: the granular Jacobi solver (LithostaticLJ, LithostaticDYN and
# DamBreakMobileBed on the general path), the DEM terrain (DEMExample on the
# forces kernel), OilJet (Grenier and a piston, general path) and Generic
# (an INI file through the CLI, forces kernel).  LithostaticLJ runs at its
# default dp 0.05, LithostaticDYN at dp 0.1: the cold EFFPRES solve of a
# dp-0.05 warm-up chunk takes 841-918 iterations, about a minute, and one
# such solve is enough to time the Jacobi iteration at the default width
LITHOSTATIC = {"LithostaticLJ": {}, "LithostaticDYN": {"deltap": 0.1}}
# the effective pressure after the first (cold) solve from zero: linear in
# depth (R^2 of the fit over the interior sediment at least SLOPE_MIN_R2).
# Its slope is not (rho_sed - rho_w) g, and the JAX package's solver gives
# the same ratio (0.643 for LithostaticLJ at dp 0.1, LithostaticDYN 0.831;
# scripts/lithostatic_slope.py --package jax --problem NAME --deltap 0.1 on
# the CPU; ROADMAP section 3 has what the wall layers change).  So the
# card's slope at dp 0.1 is held against the JAX package's on the same
# scene, within SLOPE_RTOL, and the ratio is printed
SLOPE_MIN_R2 = 0.98
SLOPE_DP = 0.1
SLOPE_RTOL = 0.01
JAX_SLOPE = {"LithostaticLJ": 5628.112439805228, "LithostaticDYN": 7273.321685244211}
# DamBreakMobileBed: one forces phase at its default width (dp 0.01), part
# by part; a chunk from its build at twice its dp (a chunk at the default
# width takes 20 forces phases of several seconds each)
MOBILE_BED = {}
MOBILE_BED_CHUNK = {"deltap": 0.02}
# the steps of that chunk (its buildneibsfreq is 10: 25.1-28.7 s a chunk,
# PERF.md), cut to make room for later phases
MOBILE_BED_CHUNK_STEPS = 4
DEM = {}
DEM_ITERS = 50
OILJET = {}
# card vs CPU at reduced widths: LithostaticDYN at dp 0.1 with the seeded
# jitter of tests/test_jacobi.py (2% of dp: on a perfect lattice the normals
# are rounding noise and the cone test flips on it), the flags exact and a
# Jacobi solve of JACOBI_CPU_ITERS iterations (thresholds 0) at
# JACOBI_RTOL; the DEM force on DEMExample's final state, its particles
# moved to 0.3-1 r0 above the terrain (the force grows as (r0/d)^12 there),
# at DEM_RTOL and DEM_ATOL_FRAC of the largest
LITHOSTATIC_CPU = {"deltap": 0.1}
JACOBI_CPU_ITERS = 10
JACOBI_RTOL = 1e-4
DEM_RTOL = 1e-5
DEM_ATOL_FRAC = 1e-7
GENERIC_ITERS = 20
GENERIC_DP = 0.015
# Generic: a DamBreak3D-like box scene with an STL obstacle made by numpy
GENERIC_INI = """
[problem]
name = GenericDamBreak
deltap = {dp}
tend = 1.0
boundary = DYN_BOUNDARY
turbulence = ARTIFICIAL
density_diffusion = COLAGROSSI
gravity = 0 0 -9.81
water_level = 0.4

[domain]
origin = 0 0 0
size = 1.6 0.67 0.6

[fluid0]
rho0 = 1000
gamma = 7
c0 = 20

[geometry0]
type = fixed_boundary
shape = box_border
origin = 0 0 0
size = 1.6 0.67 0.6
open_top = true

[geometry1]
type = fluid
shape = box
origin = 0.045 0.045 0.045
size = 0.4 0.58 0.4

[geometry2]
type = fixed_boundary
shape = stl
path = {stl}

[geometry3]
type = testpoint
origin = 1.2 0.335 0.02
"""


def box_stl(path, lo, hi):
    """A binary STL of the axis-aligned box [lo, hi], made with numpy."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    corner = lambda bits: np.where(np.array(bits, bool), hi, lo)  # noqa: E731
    tris = []
    for axis in range(3):
        a1, a2 = (axis + 1) % 3, (axis + 2) % 3
        for side in (0, 1):
            def p(u, v):
                bits = [0, 0, 0]
                bits[axis], bits[a1], bits[a2] = side, u, v
                return corner(bits)
            tris += [(p(0, 0), p(1, 0), p(1, 1)), (p(0, 0), p(1, 1), p(0, 1))]
    rec = np.zeros(len(tris), np.dtype([("n", "<3f4"), ("v", "<(3,3)f4"), ("attr", "<u2")]))
    rec["v"] = np.asarray(tris, np.float32)
    with open(path, "wb") as f:
        f.write(b"box".ljust(80, b"\0"))
        f.write(np.uint32(len(tris)).tobytes())
        f.write(rec.tobytes())


def granular_phase(dev, card):
    """Phase 10 (see the docstring)."""
    import dataclasses
    import tempfile

    import torch

    from gpusph_tpu_torch import integrator
    from gpusph_tpu_torch.bodies import init_bodies_state
    from gpusph_tpu_torch.integrator import Simulator, make_sim_chunk
    from gpusph_tpu_torch.ops import forces_kernel
    from gpusph_tpu_torch.ops.dem import apply_dem_force, dem_height_normal
    from gpusph_tpu_torch.ops.forces import compute_forces
    from gpusph_tpu_torch.ops.jacobi import (detect_surface_interface, effpres_slope,
                                             jacobi_effpres)
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.ops.visc import effective_viscosity
    from gpusph_tpu_torch.problems.base import get_problem
    from gpusph_tpu_torch.state import FG_INTERFACE, FG_SURFACE, is_fluid

    phase_t0 = time.perf_counter()
    part_t0 = [phase_t0]

    def part_s():
        """Host seconds since the last call (or the phase's start)."""
        now = time.perf_counter()
        s, part_t0[0] = now - part_t0[0], now
        return s
    f32 = dict(dtype=torch.float32, device=dev)

    def problem(name, opts):
        t0 = time.perf_counter()
        prob = get_problem(name)(dict(opts))
        grid, state = prob.build()
        return prob, prob.fw.finalize(), grid, state, time.perf_counter() - t0

    def start_args(prob, fw, state0):
        st0 = state0.to(dev)
        dt0 = fw.sp.dt or 0.1 * fw.sp.slength / max(f.c0 for f in fw.pp.fluids)
        return (st0, torch.tensor(dt0, **f32), torch.tensor(0.0, **f32), 0,
                init_bodies_state(prob.body_specs(), st0))

    def sorted_inputs(fw, grid, st):
        sts, aux = build_cells(grid, st)
        cells = torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)
        return sts, aux, cells

    def with_jacobi(fw, **kw):
        return dataclasses.replace(fw, simparams=dataclasses.replace(fw.sp, **kw))

    def run_chunks(name, prob, fw, grid, state0, warm_up=True):
        """A warm-up chunk from the build (unless not ``warm_up``) and a
        timed chunk (CUDA events), recording each EFFPRES solve's iterations
        and time; phase 4's checks.  Returns (timed output, chunk ms, warm-up
        s, solves of the warm-up chunk, solves of the timed chunk, launches,
        the first solve's (positions, effpres, info))."""
        chunk = make_sim_chunk(fw, grid, bodies_specs=prob.body_specs())
        args = start_args(prob, fw, state0)
        record, first = [], []
        original = integrator.jacobi_effpres

        def recorded(*a, **k):
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            out = original(*a, **k)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            record.append((out[2], b, e))
            if not first:
                first.append((a[2].pos.clone(), out[0].clone(), out[1].clone()))
            return out

        integrator.jacobi_effpres = recorded
        try:
            forces_kernel.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm = chunk(*args) if warm_up else args
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            warm_solves = [(int(it), b.elapsed_time(e)) for it, b, e in record]
            record.clear()
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = chunk(*warm[:5])
            end.record()
            torch.cuda.synchronize()
            solves = [(int(it), b.elapsed_time(e)) for it, b, e in record]
        finally:
            integrator.jacobi_effpres = original
        launches = forces_kernel.launches
        st, dt1 = out[0], float(out[1])
        n0, n1 = int(state0.count_active()), int(st.count_active())
        finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))
        if n1 != n0 or not finite or not dt1 > 1e-10:
            fail(f"{name}: n_active {n0} -> {n1}, finite {finite}, dt {dt1}")
        if launches != 0:
            fail(f"{name}: the forces kernel launched {launches} times on the general path")
        return (out, begin.elapsed_time(end), warm_s, warm_solves, solves, launches,
                first[0] if first else None)

    def cold_slope(name, opts):
        """effpres_slope and the iterations of one solve from zero effective
        pressure on the build."""
        prob, fw, grid, state0, _ = problem(name, opts)
        sts, aux, cells = sorted_inputs(fw, grid, state0.to(dev))
        ep, info, iters = jacobi_effpres(fw, grid, sts, aux, sts.extras["effpres"],
                                         cells=cells)
        return (*effpres_slope(fw, sts.pos, ep, info), int(iters))

    def solves_text(solves):
        its = [i for i, _ in solves]
        return (f"{len(solves)} solves, iterations {min(its)}-{max(its)} (mean "
                f"{np.mean(its):.4g}), {sum(ms for _, ms in solves):.6g} ms")

    # --- the lithostatic problems ------------------------------------------------
    for name, opts in LITHOSTATIC.items():
        prob, fw, grid, state0, build_s = problem(name, opts)
        n0 = int(state0.count_active())
        out, chunk_ms, warm_s, warm_solves, solves, launches, first = run_chunks(
            name, prob, fw, grid, state0)
        steps = fw.sp.buildneibsfreq
        sts, aux, cells = sorted_inputs(fw, grid, out[0])
        # the cold solve's time over its iterations (its one surface
        # detection is under 0.5% of it)
        iters, cold_ms = warm_solves[0]
        it_ms = cold_ms / iters
        # the effective pressure after the cold solve, over the interior
        # sediment, and the same fit at dp 0.1 against the JAX package's
        slope, r2, n_fit, want = effpres_slope(fw, *first)
        t0 = time.perf_counter()
        slope_01, _, _, _, iters_01 = cold_slope(name, {**opts, "deltap": SLOPE_DP})
        slope_01_s = time.perf_counter() - t0
        K = fw.sp.max_parts_per_cell
        say(f"[10 lithostatic] {name}: {n0} particles (build {build_s:.3f} s, grid "
            f"{'x'.join(map(str, grid.ncells))}, K {K}, {int(cells.shape[0]) * K * 27 * K} "
            f"pair slots per pass); warm-up chunk {warm_s:.3f} s (host clock; "
            f"{solves_text(warm_solves)}), timed chunk {chunk_ms:.6g} ms (CUDA events; "
            f"{solves_text(solves)}) = {n0 * steps / chunk_ms * 1e3:.6g} particle-steps/s; "
            f"Jacobi {it_ms:.6g} ms per iteration (the cold solve's {cold_ms:.6g} ms over "
            f"{iters}); forces-kernel launches {launches}; dt {float(out[1]):.6g} [{card}]")
        jax_slope = JAX_SLOPE[name]
        say(f"[10 slope] {name}: effpres after the cold solve ({iters} iterations) falls "
            f"{slope:.6g} Pa/m with depth over {n_fit} interior sediment particles (R^2 "
            f"{r2:.6f}, at least {SLOPE_MIN_R2}), {slope / want:.4f} of (rho_sed - rho_w) g = "
            f"{want:.6g}; at dp {SLOPE_DP} {slope_01:.6g} Pa/m ({iters_01} iterations, "
            f"{slope_01_s:.3f} s with the build) against the JAX package's {jax_slope:.6g} "
            f"(rtol {SLOPE_RTOL}); {name} took {part_s():.1f} s [{card}]")
        if not (r2 >= SLOPE_MIN_R2 and slope > 0
                and abs(slope_01 - jax_slope) <= SLOPE_RTOL * jax_slope):
            fail(f"{name}: the effective pressure is not linear in depth, or its slope at "
                 f"dp {SLOPE_DP} is not the JAX package's")
        del out, sts, aux

    # --- DamBreakMobileBed: one forces phase at its default width ------------------
    name = "DamBreakMobileBed"
    prob, fw, grid, state0, build_s = problem(name, MOBILE_BED)
    n0 = int(state0.count_active())
    sts, aux, cells = sorted_inputs(fw, grid, state0.to(dev))
    K = fw.sp.max_parts_per_cell
    slots = int(cells.shape[0]) * K * 27 * K
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    # the surface detection alone, then the forces phase: the solve (which
    # runs its own detection first), CALC_VISC and the general pass
    ev[0].record()
    detect_surface_interface(fw, grid, sts, aux, cells=cells)
    ev[1].record()
    ep, info, iters = jacobi_effpres(fw, grid, sts, aux, sts.extras["effpres"], cells=cells)
    ev[2].record()
    sts = sts.replace(info=info, extras=dict(sts.extras, effpres=ep))
    effvisc = effective_viscosity(fw, grid, sts, aux, cells=cells, effpres=ep)
    ev[3].record()
    f = compute_forces(fw, grid, sts, aux, cells=cells, effvisc=effvisc)
    ev[4].record()
    torch.cuda.synchronize()
    det_ms, solve_ms, visc_ms, pass_ms = (ev[i].elapsed_time(ev[i + 1]) for i in range(4))
    it_ms = (solve_ms - det_ms) / int(iters)
    phase_ms = solve_ms + visc_ms + pass_ms
    finite = bool(torch.isfinite(f.DvDt).all()) and bool(torch.isfinite(ep).all())
    say(f"[10 mobile bed] {name} at dp {fw.sp.deltap}: {n0} particles (build {build_s:.3f} s, "
        f"grid {'x'.join(map(str, grid.ncells))}, K {K}, {slots} pair slots per pass); one "
        f"forces phase (CUDA events) {phase_ms:.6g} ms: EFFPRES solve {solve_ms:.6g} ms "
        f"({int(iters)} iterations from the lithostatic start; its surface detection "
        f"{det_ms:.6g} ms timed alone, {it_ms:.6g} ms per iteration), CALC_VISC "
        f"{visc_ms:.6g} ms, general pass {pass_ms:.6g} ms ({pass_ms * 1e6 / slots:.4g} ns "
        f"per slot); {n0 / phase_ms * 1e3 / 2:.6g} particle-steps/s at two phases a step; "
        f"finite {finite} [{card}]")
    if not finite:
        fail(f"{name}: a non-finite forces phase at its default width")
    del sts, aux, ep, effvisc, f
    torch.cuda.empty_cache()
    prob, fw, grid, state0, build_s = problem(name, MOBILE_BED_CHUNK)
    fw = with_jacobi(fw, buildneibsfreq=MOBILE_BED_CHUNK_STEPS)
    n0 = int(state0.count_active())
    out, chunk_ms, _, _, solves, launches, _ = run_chunks(name, prob, fw, grid, state0,
                                                          warm_up=False)
    steps = fw.sp.buildneibsfreq
    say(f"[10 mobile bed] {name} at dp {fw.sp.deltap}: {n0} particles; one chunk from the "
        f"build of {steps} steps (no warm-up chunk: the default width's forces phase ran "
        f"first) {chunk_ms:.6g} ms (CUDA events; {solves_text(solves)}) = "
        f"{n0 * steps / chunk_ms * 1e3:.6g} particle-steps/s; forces-kernel launches "
        f"{launches}; dt {float(out[1]):.6g}; {name} took {part_s():.1f} s [{card}]")
    del out
    torch.cuda.empty_cache()

    # --- DEMExample on the forces kernel -----------------------------------------
    name = "DEMExample"
    prob, fw, grid, state0, build_s = problem(name, DEM)
    n0 = int(state0.count_active())
    sim = Simulator(prob.fw, grid, bodies_specs=prob.body_specs(), device="cuda")
    forces_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim.run(state0, maxiter=DEM_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = forces_kernel.launches
    n1 = int(st.count_active())
    finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))
    fluid = (st.active & is_fluid(st.info))
    z0, _ = dem_height_normal(fw.dem, st.pos)
    clearance = float((st.pos[:, 2] - z0)[fluid].min())
    ok, err, rep = compare_kernel(sim.fw, grid, st)
    chunk_ms = cuda_ms(lambda: sim._chunk(st, torch.tensor(sim.dt, **f32),
                                         torch.tensor(sim.t, **f32), 0, sim.bodies), 1,
                       warmup=0)
    say(f"[10 dem] {name}: {n0} particles, {DEM_ITERS} iterations in {wall:.3f} s = "
        f"{n0 * DEM_ITERS / wall:.6g} particle-steps/s (host clock, first chunk included); "
        f"one chunk {chunk_ms:.6g} ms (CUDA events); forces-kernel launches {launches}; "
        f"lowest fluid particle {clearance:.6g} m above the terrain; n_active {n0} -> {n1}; "
        f"finite {finite}; dt {sim.dt:.6g}; kernel vs plain version "
        f"{'ok' if ok else 'MISMATCH'} {json.dumps(rep)} [{card}]")
    if launches != 2 * DEM_ITERS:
        fail(f"{name}: the forces kernel launched {launches} times in {DEM_ITERS} iterations")
    if n1 != n0 or not finite or not sim.dt > 1e-10 or not clearance > 0.0:
        fail(f"{name}: n_active {n0} -> {n1}, finite {finite}, dt {sim.dt}, lowest fluid "
             f"particle {clearance} m above the terrain")
    if not ok:
        fail(f"{name}: the kernel disagrees with its plain version")
    # the DEM force card vs CPU: the final state's particles moved to seeded
    # heights within r0 of the terrain, where the force acts
    is_fl = is_fluid(st.info)
    rng = np.random.default_rng(7)
    lift = torch.as_tensor(rng.uniform(0.3, 1.0, st.capacity) * fw.pp.r0, **f32)
    near = torch.cat([st.pos[:, :2], (z0 + lift)[:, None]], dim=1)
    dvdt = torch.zeros_like(st.vel)
    a = apply_dem_force(fw, near, st.vel, st.mass, is_fl, dvdt).cpu().numpy()
    b = apply_dem_force(fw, near.cpu(), st.vel.cpu(), st.mass.cpu(), is_fl.cpu(),
                        dvdt.cpu()).numpy()
    dem_ok, dem_err, dem_max = held(a, b, DEM_RTOL, DEM_ATOL_FRAC)
    pushed = int((np.abs(b) > 0).any(1).sum())
    say(f"[10 card-cpu] {name} DEM force on the final state's particles moved to seeded "
        f"heights within r0 of the terrain: max abs diff {dem_err:.3g} of {dem_max:.3g} "
        f"(rtol {DEM_RTOL}, atol {DEM_ATOL_FRAC} x max); {pushed} particles pushed; "
        f"{name} took {part_s():.1f} s [{card}]")
    if not dem_ok or pushed < int(is_fl.sum()) // 2:
        fail(f"{name}: the DEM force on the card disagrees with the CPU")
    del sim, st

    # --- OilJet on the general path ------------------------------------------------
    name = "OilJet"
    prob, fw, grid, state0, build_s = problem(name, OILJET)
    n0 = int(state0.count_active())
    # the piston's chunk (from the build, at MOTION_T0) is the warm-up chunk
    forces_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    motion_check(name, prob, grid, state0, fw, dev, card, tag="10 motion")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    chunk = make_sim_chunk(fw, grid, bodies_specs=prob.body_specs())
    args = start_args(prob, fw, state0)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = chunk(*args)
    end.record()
    torch.cuda.synchronize()
    chunk_ms = begin.elapsed_time(end)
    launches = forces_kernel.launches
    st, dt1 = out[0], float(out[1])
    n1 = int(st.count_active())
    finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))
    steps = fw.sp.buildneibsfreq
    say(f"[10 oiljet] {name}: {n0} particles (build {build_s:.3f} s); warm-up (the piston's) "
        f"chunk {warm_s:.3f} s (host clock), timed chunk from the build {chunk_ms:.6g} ms "
        f"(CUDA events) = {n0 * steps / chunk_ms * 1e3:.6g} particle-steps/s; forces-kernel "
        f"launches {launches}; n_active {n0} -> {n1}; finite {finite}; dt {dt1:.6g}; {name} "
        f"took {part_s():.1f} s [{card}]")
    if launches != 0:
        fail(f"{name}: the forces kernel launched {launches} times on the general path")
    if n1 != n0 or not finite or not dt1 > 1e-10:
        fail(f"{name}: n_active {n0} -> {n1}, finite {finite}, dt {dt1}")

    # --- Generic through the CLI ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        stl_path = os.path.join(tmp, "obstacle.stl")
        box_stl(stl_path, (0.9, 0.24, 0.045), (1.02, 0.36, 0.2))
        ini = os.path.join(tmp, "generic.ini")
        with open(ini, "w") as f:
            f.write(GENERIC_INI.format(dp=GENERIC_DP, stl=stl_path))
        forces_kernel.launches = 0
        t0 = time.perf_counter()
        text = run_cli(["Generic", "--config", ini, "--maxiter", str(GENERIC_ITERS),
                        "--dir", os.path.join(tmp, "out")])
        wall = time.perf_counter() - t0
        launches = forces_kernel.launches
        frames = sorted(os.listdir(os.path.join(tmp, "out", "data")))
        # one chunk of the same scene from its build (CUDA events)
        prob, fw, grid, state0, build_s = problem("Generic", {"config": ini})
        chunk = make_sim_chunk(fw, grid, bodies_specs=prob.body_specs())
        args = start_args(prob, fw, state0)
        chunk_ms = cuda_ms(lambda: chunk(*args), 2, warmup=1)
    head = text.splitlines()[0]
    n_gen = int(head.split(":")[1].split()[0])
    say(f"[10 generic] python -m gpusph_tpu_torch Generic --config (a DamBreak3D-like box with "
        f"an STL obstacle): {n_gen} particles, {GENERIC_ITERS} iterations in {wall:.3f} s (host "
        f"clock, build and writes included); forces-kernel launches {launches}; frames "
        f"{len(frames)}; one chunk from the build {chunk_ms:.6g} ms (CUDA events) = "
        f"{n_gen * fw.sp.buildneibsfreq / chunk_ms * 1e3:.6g} particle-steps/s; Generic took "
        f"{part_s():.1f} s [{card}]")
    if launches != 2 * GENERIC_ITERS or "Simulation end" not in text or "device cuda" not in head:
        fail(f"Generic: {launches} forces-kernel launches in {GENERIC_ITERS} iterations, or "
             "the run did not end on the card")

    # --- card vs CPU at a reduced width: surface flags and a fixed-count solve -----
    name = "LithostaticDYN"
    prob, fw, grid, state0, _ = problem(name, LITHOSTATIC_CPU)
    rng = np.random.default_rng(42)
    jitter = rng.uniform(-0.02 * fw.sp.deltap, 0.02 * fw.sp.deltap, tuple(state0.pos.shape))
    state0 = state0.replace(pos=state0.pos + torch.as_tensor(jitter, dtype=torch.float32))
    sts, aux, cells = sorted_inputs(fw, grid, state0.to(dev))
    cpu_st, cpu_aux, cpu_cells = sorted_inputs(fw, grid, sts.to("cpu"))
    if not torch.equal(sts.id.cpu(), cpu_st.id):
        fail(f"{name}: the card and the CPU sort the particles differently")
    flags = FG_SURFACE | FG_INTERFACE
    a = detect_surface_interface(fw, grid, sts, aux, cells=cells).cpu() & flags
    b = detect_surface_interface(fw, grid, cpu_st, cpu_aux, cells=cpu_cells) & flags
    flips = int((a != b).sum())
    fixed = with_jacobi(fw, jacobi_maxiter=JACOBI_CPU_ITERS, jacobi_residual=0.0,
                        jacobi_backerr=0.0)
    ep_a, _, it_a = jacobi_effpres(fixed, grid, sts, aux, sts.extras["effpres"], cells=cells)
    t0 = time.perf_counter()
    ep_b, _, it_b = jacobi_effpres(fixed, grid, cpu_st, cpu_aux, cpu_st.extras["effpres"],
                                   cells=cpu_cells)
    cpu_s = time.perf_counter() - t0
    jac_ok, jac_err, jac_max = held(ep_a.cpu().numpy(), ep_b.numpy(), JACOBI_RTOL, 1e-6)
    say(f"[10 card-cpu] {name} dp {fw.sp.deltap} (jittered 2% of dp, {int(sts.count_active())} "
        f"particles): surface and interface flags differ on {flips} particles "
        f"({int(((b & FG_SURFACE) != 0).sum())} at the surface); {int(it_a)} and {int(it_b)} "
        f"Jacobi iterations, effpres max abs diff {jac_err:.3g} of {jac_max:.3g} (rtol "
        f"{JACOBI_RTOL}, atol 1e-6 x max); the CPU solve took {cpu_s:.3f} s [{card}]")
    if flips or not jac_ok or not int(it_a) == int(it_b) == JACOBI_CPU_ITERS:
        fail(f"{name}: the surface flags or the Jacobi solve on the card disagree with the CPU")
    say(f"[10 card-cpu] phase 10 took {time.perf_counter() - phase_t0:.1f} s (host clock)")


def gravity_check(name, fw, grid, start_args, record, sts, aux, cells, kw, card):
    """The gravity of every pass of the timed chunk against the callback at
    t_k and t_k + dt_k/2 (evaluated on the host in float64), and one pass at
    the chunk's start with the callback against the same pass with that
    gravity as a constant: bit-identical accelerations."""
    import dataclasses
    import math

    import torch

    from gpusph_tpu_torch.ops.forces import compute_forces

    times = np.array([float(r[0]) for r in record])
    used = np.array([[float(c) for c in r[1:]] for r in record])
    gx = np.where((times > 0.3) & (times < 3.0),
                  2.0 * np.sin(9.8 * (times.astype(np.float64) - 0.3)), 0.0)
    want = np.stack([gx, np.zeros_like(gx), np.full_like(gx, -9.81)], axis=1)
    err = float(np.abs(used - want).max())
    # two passes per step: t_k, then t_k + dt_k/2, and t_{k+1} = t_k + dt_k
    t_pred, t_corr = times[0::2], times[1::2]
    dts = np.diff(np.append(t_pred, np.nan))[:-1]
    # (f32 times near 0.35 s resolve 3e-8 s)
    halves_ok = np.allclose(t_corr[:-1] - t_pred[:-1], dts / 2, rtol=1e-3, atol=2e-7)
    t_start = start_args[2]
    const = dataclasses.replace(fw, gcallback=None, physparams=dataclasses.replace(
        fw.pp, gravity=tuple(float(c) for c in fw.gcallback(t_start))))
    a = compute_forces(fw, grid, sts, aux, t=t_start, cells=cells, **kw)
    b = compute_forces(const, grid, sts, aux, cells=cells, **kw)
    same = torch.equal(a.DvDt, b.DvDt)
    say(f"[9 gravity] {name}: {len(record)} callback calls in the timed chunk at t "
        f"{times.min():.6g} to {times.max():.6g}, g_x {used[:, 0].min():.6g} to "
        f"{used[:, 0].max():.6g}; max |g - callback(t)| {err:.3g} (limit {GRAVITY_ATOL}); "
        f"corrector passes at t_k + dt_k/2 {halves_ok}; pass with the callback at t "
        f"{float(t_start):.6g} vs constant gravity "
        f"{'bit-identical' if same else 'DIFFERENT'} [{card}]")
    if not (len(record) == 2 * fw.sp.buildneibsfreq and err <= GRAVITY_ATOL and halves_ok
            and same and math.isfinite(err) and np.abs(used[:, 0]).max() > 0):
        fail(f"{name}: the passes did not use the gravity callback's value")


def run_cli(argv):
    """``gpusph_tpu_torch.cli.main`` in-process; returns its standard output
    (also echoed, indented)."""
    import contextlib
    import io

    from gpusph_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    for ln in out.splitlines():
        say(f"  | {ln}")
    if rc != 0:
        fail(f"cli {' '.join(argv)} exited {rc}")
    return out


def output_phase(dev, card):
    """Phase 6: DamBreak3D's output path on the card (see the docstring)."""
    import glob
    import re
    import tempfile

    import torch

    from gpusph_tpu_torch.convert import state_to_numpy
    from gpusph_tpu_torch.io.hotfile import load_hotfile
    from gpusph_tpu_torch.ops import forces_kernel
    from gpusph_tpu_torch.io.vtk import read_vtu
    from gpusph_tpu_torch.ops.eos import physical_density, pressure
    from gpusph_tpu_torch.ops.postprocess import make_write_postprocess
    from gpusph_tpu_torch.problems.base import get_problem
    from gpusph_tpu_torch.repacking import make_repack_chunk
    from gpusph_tpu_torch.state import fluid_num

    prob = get_problem("DamBreak3D")({"deltap": OUTPUT_DP})
    grid, state0 = prob.build()
    fw = prob.fw.finalize()
    base = ["DamBreak3D", "--deltap", str(OUTPUT_DP), "--maxiter", str(OUTPUT_ITERS),
            "--checkpoint-every", "0.005"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_out_") as tmp:
        straight = os.path.join(tmp, "straight")
        forces_kernel.launches = 0
        t0 = time.perf_counter()
        out = run_cli(base + ["--dir", straight])
        wall = time.perf_counter() - t0
        launches = forces_kernel.launches
        if launches != 2 * OUTPUT_ITERS:
            fail(f"forces kernel launched {launches} times in the CLI's {OUTPUT_ITERS} "
                 f"iterations, expected {2 * OUTPUT_ITERS}")
        m = re.search(r"Writes: (\d+) .*post-process ([\d.e+-]+), host copy ([\d.e+-]+), "
                      r"files ([\d.e+-]+)", out)
        if m is None:
            fail("the CLI printed no write-cost line")
        n_writes, post_ms, copy_ms, files_ms = int(m[1]), *map(float, m.groups()[1:])
        layout = ["summary.txt", "energy.txt", "testpoints.txt", "rbdata.txt",
                  "objectforces.txt", "data/PART.pvd"]
        missing = [f for f in layout if not os.path.isfile(os.path.join(straight, f))]
        frames = sorted(glob.glob(os.path.join(straight, "data", "PART_*.vtu")))
        hots = sorted(glob.glob(os.path.join(straight, "hot_*.npz")))
        if missing or not frames or len(hots) < 2:
            fail(f"output layout: missing {missing}, {len(frames)} frames, "
                 f"{len(hots)} hotfiles")
        say(f"[6 output] DamBreak3D dp {OUTPUT_DP}: CLI, {OUTPUT_ITERS} iterations in "
            f"{wall:.3f} s (host clock, build included), forces kernel launches "
            f"{launches}, {n_writes} writes: {', '.join(layout)}, "
            f"{len(frames)} x data/PART_*.vtu, "
            f"{', '.join(os.path.basename(h) for h in hots)} [{card}]")

        # the last frame is the final state: the final write is forced
        final, header, body = load_hotfile(hots[-1])
        if header["iterations"] != OUTPUT_ITERS:
            fail(f"last hotfile at iteration {header['iterations']}")
        fin = state_to_numpy(final)
        act = final.active.numpy()
        frame = read_vtu(frames[-1])
        rows = np.loadtxt(os.path.join(straight, "testpoints.txt"), ndmin=2)
        times, counts = np.unique(rows[:, 0], return_counts=True)
        # test-point rows of a frame carry the interpolated velocity, the
        # values of the last write in testpoints.txt (%.9g: exact in f32)
        tp = (fin["info"][act] & 7) == 3
        vel = fin["vel"][act].copy()
        vel[tp] = rows[rows[:, 0] == times[-1]][:, 5:8]
        exact = {"pos": fin["pos"][act], "Mass": fin["mass"][act], "Id": fin["id"][act],
                 "Info": fin["info"][act], "Velocity": vel}
        bad = [k for k, v in exact.items()
               if k not in frame or frame[k].dtype != v.dtype
               or not np.array_equal(frame[k], v)]
        f_num = fluid_num(final.info)
        eos_err = max(
            float(np.abs(frame[k][~tp] - ref.numpy()[act][~tp]).max()
                  / np.abs(ref.numpy()[act]).max())
            for k, ref in (("Pressure", pressure(fw.pp, final.rho, f_num)),
                           ("Density", physical_density(fw.pp, final.rho, f_num))))
        energy = np.loadtxt(os.path.join(straight, "energy.txt"), ndmin=2)
        rb = np.loadtxt(os.path.join(straight, "rbdata.txt"), ndmin=2)
        say(f"[6 output] last frame {os.path.basename(frames[-1])} against the final "
            f"checkpoint ({int(act.sum())} rows): pos/Mass/Id/Info/Velocity "
            f"{'exact' if not bad else 'DIFFER ' + str(bad)}, Pressure/Density max rel "
            f"err {eos_err:.3g}; testpoints.txt {len(times)} writes x {set(counts.tolist())} "
            f"rows, finite {bool(np.isfinite(rows).all())}; energy.txt {len(energy)} rows, "
            f"rbdata.txt {len(rb)} rows, finite "
            f"{bool(np.isfinite(energy).all() and np.isfinite(rb).all())}")
        if bad or not eos_err <= 1e-6:
            fail("the last VTU frame disagrees with the final state")
        if set(counts.tolist()) != {3} or not np.isfinite(rows).all():
            fail("testpoints.txt: not three finite rows per write")
        if not (np.isfinite(energy).all() and np.isfinite(rb).all() and len(rb)):
            fail("energy.txt / rbdata.txt not finite")

        # resume from a middle checkpoint to the same iteration
        middle = [h for h in hots[:-1] if load_hotfile(h)[1]["iterations"] < OUTPUT_ITERS]
        if not middle:
            fail("no middle hotfile to resume from")
        resumed = os.path.join(tmp, "resumed")
        run_cli(base + ["--dir", resumed, "--resume", middle[0]])
        again, rheader, _ = load_hotfile(sorted(glob.glob(os.path.join(resumed,
                                                                      "hot_*.npz")))[-1])
        got = state_to_numpy(again)
        drift = {k: float(np.abs(got[k] - fin[k]).max()) for k in ("pos", "vel", "rho")}
        same_ids = np.array_equal(got["id"], fin["id"])
        say(f"[6 resume] from {os.path.basename(middle[0])} (iteration "
            f"{load_hotfile(middle[0])[1]['iterations']}) to {rheader['iterations']}: max "
            f"drift from the straight run pos {drift['pos']:.6g} m (limit {RESUME_POS_TOL}), "
            f"vel {drift['vel']:.6g}, rho {drift['rho']:.6g}; ids "
            f"{'equal' if same_ids else 'DIFFER'}; t {rheader['t']!r} vs {header['t']!r}")
        if not (same_ids and rheader["iterations"] == OUTPUT_ITERS
                and drift["pos"] <= RESUME_POS_TOL):
            fail("the resumed run drifted from the straight run")

    # the write-time post-process pass: card against CPU on the final state
    post_dev = make_write_postprocess(fw, grid)
    on_card = post_dev(final.to(dev))
    on_cpu = post_dev(final)
    is_tp = (fin["info"] & 7) == 3
    worst, errs = 0.0, {}
    for k in ("TestpointVel", "TestpointPress"):
        a, b = on_card[k].cpu().numpy()[is_tp], on_cpu[k].numpy()[is_tp]
        atol = POST_ATOL_FRAC * float(np.abs(b).max())
        errs[k] = float(np.abs(a - b).max())
        worst = max(worst, float((np.abs(a - b) - (atol + POST_RTOL * np.abs(b))).max()))
    st_dev = final.to(dev)
    post_card_ms = cuda_ms(lambda: post_dev(st_dev), 5, warmup=1)
    say(f"[6 post] TESTPOINTS pass on the final state, card vs CPU: max abs diff "
        f"vel {errs['TestpointVel']:.6g}, press {errs['TestpointPress']:.6g} (rtol "
        f"{POST_RTOL}, atol {POST_ATOL_FRAC} x max); {post_card_ms:.6g} ms on the card "
        f"(CUDA events) [{card}]")
    if not (worst <= 0.0 and all(np.isfinite(v) for v in errs.values())):
        fail("the post-process pass on the card disagrees with the CPU")

    # repacking: the CLI's --repack-only, depth cut to REPACK_MAXITER
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repack_") as tmp:
        t0 = time.perf_counter()
        run_cli(["DamBreak3D", "--deltap", str(OUTPUT_DP), "--repack-only",
                 "--repack_maxiter", str(REPACK_MAXITER), "--dir", tmp])
        repack_wall = time.perf_counter() - t0
        rst, rhead, _ = load_hotfile(os.path.join(tmp, "repack.npz"))
    rfinite = bool(torch.isfinite(rst.pos).all())
    chunk = make_repack_chunk(fw, grid, 10)
    st_dev = state0.to(dev)
    repack_ms = cuda_ms(lambda: chunk(st_dev), 1, warmup=0)  # warmed up by the CLI
    moved = float((rst.pos - state0.pos[rst.id.long()]).abs().max())  # ids: built rows
    say(f"[6 repack] --repack-only, repack_maxiter {REPACK_MAXITER}: {repack_wall:.3f} s "
        f"(host clock, CLI in-process, build included); repack.npz finite {rfinite}, max "
        f"displacement {moved:.6g} m; {repack_ms:.6g} ms per repack chunk of 10 steps "
        f"(CUDA events) [{card}]")
    if not (rfinite and rhead["iterations"] == 0 and moved > 0):
        fail("repacking wrote no usable state")
    say(f"[6 cost] ms per write: post-process {post_ms:.6g}, host copy {copy_ms:.6g}, "
        f"file write {files_ms:.6g} (host clock, {n_writes} writes); "
        f"{repack_ms:.6g} ms per repack chunk [{card}]")


# phase 11: SA walls on the gamma-quadrature path.  StillWaterSA
# --density_sum 0 at its default width (ppH 24, 24,794 particles): a warm-up
# chunk from the build and a timed chunk; then, at ppH 10, the flat-wall
# oracles of tests/test_sa.py (copied below) and card vs CPU
SA_OPTS = {"density_sum": 0}
SA_CPU = {"density_sum": 0, "ppH": 10}
SA_H = 0.5  # StillWaterSA's water_height and side
SA_SIDE = 0.5
# the oracles' bars (tests/test_sa.py): gamma within SA_GAMMA_ATOL of the
# half-space integral; |grad gamma| along +z within SA_GRAD_RTOL of the
# plane integral of W (x max(ref, 1)), its tangential part under
# SA_TANGENT x ref + 1e-3, and zero (under 1e-5) beyond 2h
SA_GAMMA_ATOL = 5e-3
SA_GRAD_RTOL = 0.03
SA_TANGENT = 0.05
# card vs CPU on the same sorted ppH-10 state (its fluid at seeded
# velocities), each pass on both devices from the same inputs: (rtol, atol
# as a fraction of max|CPU|, absolute floor)
SA_CARD_CPU = {"gamma": (0.0, 0.0, 1e-6), "grad gamma": (0.0, 2e-3, 0.0),
               "wall rho": (0.0, 0.0, 2.0 ** -22), "DvDt": (0.0, 5e-4, 0.0),
               "DrDt": (0.0, 5e-4, 0.0)}


def _wendland_w(r, h):
    q = r / h
    val = 21.0 / (16.0 * np.pi * h**3) * (1.0 - 0.5 * q) ** 4 * (1.0 + 2.0 * q)
    return np.where(q < 2.0, val, 0.0)


def halfspace_gamma(z, h):
    """1 - the integral of W over the half-space beyond a wall at distance z
    (numeric oracle of tests/test_sa.py)."""
    zz = np.linspace(-2.0 * h, 2.0 * h, 400)
    rr = np.linspace(0.0, 2.0 * h, 400)
    Z, R = np.meshgrid(zz, rr, indexing="ij")
    W = _wendland_w(np.sqrt(Z**2 + R**2), h)
    return 1.0 - float((W * (Z < -z) * 2.0 * np.pi * R * (rr[1] - rr[0])
                        * (zz[1] - zz[0])).sum())


def plane_integral_w(z, h):
    """The integral of W over a wall plane at distance z: the exact flat-wall
    |grad gamma| (tests/test_sa.py)."""
    rr = np.linspace(0.0, 2.0 * h, 2000)
    W = _wendland_w(np.sqrt(z**2 + rr**2), h)
    return float((W * 2.0 * np.pi * rr * (rr[1] - rr[0])).sum())


def sa_phase(dev, card):
    """Phase 11 (see the docstring)."""
    import torch

    from gpusph_tpu_torch.bodies import init_bodies_state
    from gpusph_tpu_torch.integrator import make_sim_chunk
    from gpusph_tpu_torch.ops import eos, forces_kernel
    from gpusph_tpu_torch.ops.forces import compute_forces
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.ops.pair import neighbor_apply, split_vec
    from gpusph_tpu_torch.ops.sa import compute_gamma, impose_boundary_conditions
    from gpusph_tpu_torch.problems.base import get_problem
    from gpusph_tpu_torch.state import fluid_num, is_fluid

    phase_t0 = time.perf_counter()
    f32 = dict(dtype=torch.float32, device=dev)

    def sorted_inputs(grid, st):
        sts, aux = build_cells(grid, st)
        return sts, aux, torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)

    # --- StillWaterSA at its default width -----------------------------------------
    t0 = time.perf_counter()
    prob = get_problem("StillWaterSA")(dict(SA_OPTS))
    grid, state0 = prob.build()
    fw = prob.fw.finalize()
    build_s = time.perf_counter() - t0
    dp, steps, K = fw.sp.deltap, fw.sp.buildneibsfreq, fw.sp.max_parts_per_cell
    n0 = int(state0.count_active())
    chunk = make_sim_chunk(fw, grid)
    st0 = state0.to(dev)
    dt0 = 0.1 * fw.sp.slength / max(f.c0 for f in fw.pp.fluids)
    args = (st0, torch.tensor(dt0, **f32), torch.tensor(0.0, **f32), 0,
            init_bodies_state((), st0))
    forces_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = chunk(*args)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = chunk(*warm[:5])
    end.record()
    torch.cuda.synchronize()
    chunk_ms = begin.elapsed_time(end)
    launches = forces_kernel.launches
    st, dt1 = out[0], float(out[1])
    n1 = int(st.count_active())
    finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))
    fl = (st.active & is_fluid(st.info)).cpu().numpy()
    pos = st.pos.cpu().numpy()[fl]
    top = SA_H + 6 * dp
    outside = int(((pos[:, :2] < 0.0) | (pos[:, :2] > SA_SIDE)).any(1).sum()
                  + ((pos[:, 2] < 0.0) | (pos[:, 2] > top)).sum())
    # the hydrostatic error over the central column, a figure
    press = eos.pressure(fw.pp, st.rho, fluid_num(st.info)).cpu().numpy()[fl]
    rho0, g = fw.pp.fluids[0].rho0, abs(fw.pp.gravity[2])
    ctr = (np.abs(pos[:, 0] - SA_SIDE / 2) < 0.08) & (np.abs(pos[:, 1] - SA_SIDE / 2) < 0.08)
    hydro = float(np.mean(np.abs(press[ctr] - rho0 * g * (SA_H - pos[ctr, 2])))
                  / (rho0 * g * SA_H))
    say(f"[11 sa] StillWaterSA --density_sum 0 at ppH {round(SA_H / dp)}: {n0} particles "
        f"(build {build_s:.3f} s, grid {'x'.join(map(str, grid.ncells))}, K {K}); warm-up "
        f"chunk {warm_s:.3f} s (host clock), timed chunk {chunk_ms:.6g} ms (CUDA events) = "
        f"{n0 * steps / chunk_ms * 1e3:.6g} particle-steps/s; forces-kernel launches "
        f"{launches}; n_active {n0} -> {n1}; finite {finite}; dt {dt1:.6g}; t "
        f"{float(out[2]):.6g}; fluid particles outside the SA box [0, {SA_SIDE}]^2 x [0, "
        f"{top:.6g}]: {outside}; hydrostatic error mean |p - rho g (H - z)| / (rho g H) over "
        f"{int(ctr.sum())} central particles {hydro:.6g} (a figure, not a gate) [{card}]")
    if launches != 0:
        fail(f"StillWaterSA: the forces kernel launched {launches} times on the general path")
    if n1 != n0 or not finite or not dt1 > 1e-10 or outside:
        fail(f"StillWaterSA: n_active {n0} -> {n1}, finite {finite}, dt {dt1}, "
             f"{outside} fluid particles outside the box")

    # the three passes of a forces phase on the final state, and their pairs
    sts, aux, cells = sorted_inputs(grid, st)
    slots = int(cells.shape[0]) * K * 27 * K
    gamma, _ = compute_gamma(fw, grid, sts, aux, cells=cells, with_grad=False)
    walled = impose_boundary_conditions(fw, grid, sts, aux, gamma, cells=cells)
    gamma_ms = cuda_ms(lambda: compute_gamma(fw, grid, sts, aux, cells=cells,
                                             with_grad=False), 3, warmup=1)
    bc_ms = cuda_ms(lambda: impose_boundary_conditions(fw, grid, sts, aux, gamma,
                                                       cells=cells), 3, warmup=1)
    pass_ms = cuda_ms(lambda: compute_forces(fw, grid, walled, aux, dt=out[1], cells=cells,
                                             gamma=gamma), 3, warmup=1)
    fields = dict(**split_vec("pos", sts.pos), ptype=sts.info & 7)
    seg = neighbor_apply(grid, aux, fields, lambda c, n, g: {
        "n": (g.mask & (c["ptype"] == 0) & (n["ptype"] == 1)).float()},
        max_parts_per_cell=K, influenceradius=fw.sp.influenceradius + 0.5 * dp,
        cells=cells)["n"]
    seg_pairs = int(seg.sum())
    phase_ms = gamma_ms + bc_ms + pass_ms
    say(f"[11 passes] StillWaterSA ppH {round(SA_H / dp)} final state, {int(cells.shape[0])} "
        f"occupied cells, {slots} pair slots per pass, {seg_pairs} fluid-segment pairs: gamma "
        f"pass {gamma_ms:.6g} ms ({gamma_ms * 1e6 / slots:.4g} ns per slot), wall-condition "
        f"pass {bc_ms:.6g} ms ({bc_ms * 1e6 / slots:.4g} ns per slot), SA general pass "
        f"{pass_ms:.6g} ms ({pass_ms * 1e6 / slots:.4g} ns per slot), {phase_ms:.6g} ms a "
        f"forces phase x {2 * steps} per chunk (CUDA events, 3 each) [{card}]")
    # where a forces phase's device time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g_, _ = compute_gamma(fw, grid, sts, aux, cells=cells, with_grad=False)
        w_ = impose_boundary_conditions(fw, grid, sts, aux, g_, cells=cells)
        compute_forces(fw, grid, w_, aux, dt=out[1], cells=cells, gamma=g_)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:6]
    say(f"[11 trace] one forces phase under torch.profiler: wall {prof_ms:.6g} ms, device "
        f"busy {busy_ms:.6g} ms (share {busy_ms / prof_ms:.4f}); top device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.4g} ms x{e.count}"
                    for e in top) + f" [{card}]")
    del warm, out, st, sts, aux, walled, w_, g_
    torch.cuda.empty_cache()

    # --- the flat-wall oracles at ppH 10, on the card ------------------------------
    prob = get_problem("StillWaterSA")(dict(SA_CPU))
    grid, state0 = prob.build()
    fw = prob.fw.finalize()
    h = fw.sp.slength
    sts, aux, cells = sorted_inputs(grid, state0.to(dev))
    gam, ggam = (a.cpu().numpy() for a in compute_gamma(fw, grid, sts, aux, cells=cells))
    pos = sts.pos.cpu().numpy()
    sel = (((sts.info & 7) == 0).cpu().numpy() & (np.abs(pos[:, 0] - SA_SIDE / 2) < 0.1)
           & (np.abs(pos[:, 1] - SA_SIDE / 2) < 0.1))
    z, gs, gg = pos[sel, 2], gam[sel], ggam[sel]
    near = z < 1.9 * h
    gamma_err = max(abs(gi - halfspace_gamma(zi, h)) for zi, gi in zip(z[near], gs[near]))
    mid = (z < 1.5 * h) & (z > 0.5 * h)
    grad_err = tan_err = 0.0
    grad_ok = True
    for zi, gv in zip(z[mid], gg[mid]):
        ref = plane_integral_w(zi, h)
        grad_err = max(grad_err, abs(gv[2] - ref) / max(ref, 1.0))
        tan_err = max(tan_err, max(abs(gv[0]), abs(gv[1])) / ref)
        grad_ok &= bool(abs(gv[0]) < SA_TANGENT * ref + 1e-3
                        and abs(gv[1]) < SA_TANGENT * ref + 1e-3)
    far = float(np.abs(gg[z > 2.1 * h]).max())
    say(f"[11 oracle] StillWaterSA ppH 10 on the card, {int(sel.sum())} fluid particles over "
        f"the floor's centre: gamma against the half-space integral of W, max error "
        f"{gamma_err:.3g} over {int(near.sum())} particles (bar {SA_GAMMA_ATOL}); grad gamma "
        f"along +z against the plane integral of W, max error {grad_err:.3g} x max(ref, 1) "
        f"over {int(mid.sum())} particles (bar {SA_GRAD_RTOL}), tangential at most "
        f"{tan_err:.3g} x ref (bar {SA_TANGENT} x ref + 1e-3); beyond 2h {far:.3g} (bar "
        f"1e-5) [{card}]")
    if not (gamma_err < SA_GAMMA_ATOL and grad_err < SA_GRAD_RTOL and grad_ok
            and far < 1e-5 and near.sum() and mid.sum()):
        fail("StillWaterSA: gamma or grad gamma misses the flat-wall oracle on the card")

    # --- card vs CPU at ppH 10 ------------------------------------------------------
    rng = np.random.default_rng(11)
    fluid0 = ((state0.info & 7) == 0).numpy()
    vel = state0.vel.numpy().copy()
    vel[fluid0] = rng.normal(0.0, 0.05, size=(int(fluid0.sum()), 3))
    moving = state0.replace(vel=torch.as_tensor(vel, dtype=torch.float32))
    sts, aux, cells = sorted_inputs(grid, moving.to(dev))
    cpu_st, cpu_aux, cpu_cells = sorted_inputs(grid, moving)
    if not torch.equal(sts.id.cpu(), cpu_st.id):
        fail("StillWaterSA: the card and the CPU sort the particles differently")
    t0 = time.perf_counter()
    rows = {}
    ga, gga = compute_gamma(fw, grid, sts, aux, cells=cells)
    gb, ggb = compute_gamma(fw, grid, cpu_st, cpu_aux, cells=cpu_cells)
    rows["gamma"] = (ga.cpu().numpy(), gb.numpy())
    rows["grad gamma"] = (gga.cpu().numpy(), ggb.numpy())
    # each later pass from the card's inputs on both devices
    wa = impose_boundary_conditions(fw, grid, sts, aux, ga, cells=cells)
    wb = impose_boundary_conditions(fw, grid, cpu_st, cpu_aux, ga.cpu(), cells=cpu_cells)
    wall = ((sts.info & 7) != 0).cpu().numpy()
    rows["wall rho"] = (wa.rho.cpu().numpy()[wall], wb.rho.numpy()[wall])
    fa = compute_forces(fw, grid, wa, aux, cells=cells, gamma=ga)
    fb = compute_forces(fw, grid, cpu_st.replace(rho=wa.rho.cpu()), cpu_aux, cells=cpu_cells,
                        gamma=ga.cpu())
    act = sts.active.cpu().numpy()
    rows["DvDt"] = (fa.DvDt.cpu().numpy()[act], fb.DvDt.numpy()[act])
    rows["DrDt"] = (fa.DrDt.cpu().numpy()[act], fb.DrDt.numpy()[act])
    both_s = time.perf_counter() - t0
    report, ok = [], True
    for k, (x, y) in rows.items():
        rtol, frac, floor = SA_CARD_CPU[k]
        good, err, scale = held(x, y, rtol, frac, floor)
        ok &= good
        report.append(f"{k} {err:.3g} of {scale:.3g}{'' if good else ' MISMATCH'}")
    say(f"[11 card-cpu] StillWaterSA ppH 10 ({int(sts.count_active())} particles, fluid at "
        f"seeded velocities): card vs CPU max abs diff {', '.join(report)} (tolerances "
        f"{json.dumps(SA_CARD_CPU)} as rtol, atol x max, atol floor); both devices' passes "
        f"took {both_s:.3f} s; phase 11 took {time.perf_counter() - phase_t0:.1f} s (host "
        f"clock) [{card}]")
    if not ok:
        fail("StillWaterSA: the SA passes on the card disagree with the CPU")


# phase 12: density summation and the dynamic gamma on SA walls
# (ops/density_sum.py).  StillWaterSA at its default (density summation) and
# width (ppH 24): a warm-up chunk through Simulator.run (the quadrature seeds
# gamma first) and a timed chunk; the JAX density-sum test's bars
# (tests/test_density_sum.py): |rho| < DS_RHO_MAX, gamma in [0.1, 1], the
# static identity on the seeded state (rho within DS_STATIC_RHO, gamma within
# DS_STATIC_GAMMA), and gamma integrated over a rigid displacement of the
# fluid (8 steps of 0.3 dp / 8 towards the floor, at ppH DS_DRIFT_PPH)
# within DS_DRIFT_ATOL of the quadrature where the quadrature is under
# 0.999; the peak device memory of the timed chunk under DS_PEAK_GIB
DS_OPTS = {}
DS_RHO_MAX = 0.2
DS_STATIC_RHO = 2e-5
DS_STATIC_GAMMA = 1e-6
DS_DRIFT_PPH = 8
DS_DRIFT_ATOL = 5e-3
DS_PEAK_GIB = 16.0
# card vs CPU at ppH 10 on the seeded state, its fluid displaced by a seeded
# amount of at most 0.3 dp and its density perturbed by seeded noise: (rtol,
# atol as a fraction of max|CPU|, absolute floor), the tolerances of
# tests/test_torch_density_sum.py, stated there from the port's measured
# gaps to the JAX package (the kernel sums in another order), but for grad
# gamma.  Its f32 formula cancels near a triangle's edge: on this scene the
# CPU's f32 grad gamma is 0.0306 (5.33e-3 of the largest, 5.75) off the same
# pass in f64 on one row, so each device may be that far from the f64
# value and the two twice as far from each other: both devices are held
# against the CPU's f64 pass at DS_GRAD_F64 of its largest value, and each
# other at twice that
DS_CPU_PPH = 10
DS_GRAD_F64 = 6e-3
DS_CARD_CPU = {"volumic sum": (0.0, 5e-6, 0.0), "gamma increment": (0.0, 2e-3, 0.0),
               "grad gamma": (0.0, 2 * DS_GRAD_F64, 0.0), "summed rho": (0.0, 0.0, 1e-4),
               "summed gamma": (0.0, 0.0, 1e-4), "diffusion change": (0.0, 1e-3, 1e-7)}
# BiFluidPoiseuilleSA, periodic in x and y, with no motion: the n+1 grad
# gamma of the density sum against compute_gamma's, within this fraction of
# its largest value (the port wraps the n+1 relative position; ROADMAP
# section 3)
DS_PERIODIC_FRAC = 2e-3
LITHOSTATIC_SA = {"deltap": 0.1}
REPACK_SA_ARGV = ["StillWaterRepackSA", "--repack", "--repack_maxiter", "10", "--maxiter",
                  "10"]


def density_sum_phase(dev, card):
    """Phase 12 (see the docstring)."""
    import tempfile

    import torch

    from gpusph_tpu_torch.integrator import Simulator, make_sim_chunk
    from gpusph_tpu_torch.ops import density_sum as ds
    from gpusph_tpu_torch.ops import eos, forces_kernel
    from gpusph_tpu_torch.ops.jacobi import effpres_slope
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.ops.pair import neighbor_apply, split_vec
    from gpusph_tpu_torch.ops.sa import compute_gamma
    from gpusph_tpu_torch.problems.base import get_problem
    from gpusph_tpu_torch.state import fluid_num, is_fluid

    phase_t0 = time.perf_counter()
    part_t0 = [phase_t0]

    def part_s():
        """Host seconds since the last call (or the phase's start)."""
        now = time.perf_counter()
        s, part_t0[0] = now - part_t0[0], now
        return s

    def sorted_inputs(grid, st):
        sts, aux = build_cells(grid, st)
        return sts, aux, torch.nonzero(aux.cell_count[:grid.n_cells]).squeeze(1)

    def problem(name, opts):
        prob = get_problem(name)(dict(opts))
        grid, state0 = prob.build()
        return prob, prob.fw.finalize(), grid, state0

    def sane(name, st, n0, dt):
        """Phase 4's checks and the JAX density-sum test's bars on the active
        rows of ``st``; returns the text."""
        act = st.active
        n1 = int(act.sum())
        finite = all(bool(torch.isfinite(t).all()) for t in (
            st.pos, st.vel, st.rho, st.extras["gamma"], st.extras["gradgamma"]))
        rho_max = float(st.rho[act].abs().max())
        gam = st.extras["gamma"][act]
        g_lo, g_hi = float(gam.min()), float(gam.max())
        if not (n1 == n0 and finite and dt > 1e-10 and rho_max < DS_RHO_MAX
                and g_lo >= 0.1 - 1e-6 and g_hi <= 1.0 + 1e-6):
            fail(f"{name}: n_active {n0} -> {n1}, finite {finite}, dt {dt}, max |rho| "
                 f"{rho_max}, gamma in [{g_lo}, {g_hi}]")
        return (f"n_active {n0} -> {n1}; finite {finite}; dt {dt:.6g}; max |rho| {rho_max:.6g} "
                f"(bar {DS_RHO_MAX}); gamma in [{g_lo:.6g}, {g_hi:.6g}] (bar [0.1, 1])")

    # --- StillWaterSA at its default ---------------------------------------------------
    t0 = time.perf_counter()
    prob, fw, grid, state0 = problem("StillWaterSA", DS_OPTS)
    build_s = time.perf_counter() - t0
    if not fw.dynamic_gamma:
        fail("StillWaterSA's default does not run density summation")
    dp, steps, K = fw.sp.deltap, fw.sp.buildneibsfreq, fw.sp.max_parts_per_cell
    n0 = int(state0.count_active())
    forces_kernel.launches = 0
    sim = Simulator(prob.fw, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = sim.run(state0, maxiter=steps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    chunk = make_sim_chunk(fw, grid)
    f32 = dict(dtype=torch.float32, device=dev)
    args = (warm, torch.tensor(sim.dt, **f32), torch.tensor(sim.t, **f32), sim.iterations,
            sim.bodies)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = chunk(*args)
    end.record()
    torch.cuda.synchronize()
    chunk_ms = begin.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    launches = forces_kernel.launches
    st, dt1 = out[0], float(out[1])
    checks = sane("StillWaterSA", st, n0, dt1)
    fl = (st.active & is_fluid(st.info)).cpu().numpy()
    pos = st.pos.cpu().numpy()[fl]
    top = SA_H + 6 * dp
    outside = int(((pos[:, :2] < 0.0) | (pos[:, :2] > SA_SIDE)).any(1).sum()
                  + ((pos[:, 2] < 0.0) | (pos[:, 2] > top)).sum())
    press = eos.pressure(fw.pp, st.rho, fluid_num(st.info)).cpu().numpy()[fl]
    rho0, g = fw.pp.fluids[0].rho0, abs(fw.pp.gravity[2])
    ctr = (np.abs(pos[:, 0] - SA_SIDE / 2) < 0.08) & (np.abs(pos[:, 1] - SA_SIDE / 2) < 0.08)
    hydro = float(np.mean(np.abs(press[ctr] - rho0 * g * (SA_H - pos[ctr, 2])))
                  / (rho0 * g * SA_H))
    gib = 2.0 ** 30
    say(f"[12 density-sum] StillWaterSA (density summation, its default) at ppH "
        f"{round(SA_H / dp)}: {n0} particles (build {build_s:.3f} s, grid "
        f"{'x'.join(map(str, grid.ncells))}, K {K}); warm-up chunk through Simulator.run "
        f"(the quadrature's seeding included) {warm_s:.3f} s (host clock), timed chunk "
        f"{chunk_ms:.6g} ms (CUDA events) = {n0 * steps / chunk_ms * 1e3:.6g} "
        f"particle-steps/s; peak device memory in the timed chunk {peak / gib:.4f} GiB "
        f"({(peak - base_bytes) / gib:.4f} GiB above its inputs; bar {DS_PEAK_GIB} GiB); "
        f"forces-kernel launches {launches}; {checks}; t {float(out[2]):.6g}; fluid "
        f"particles outside the SA box: {outside}; hydrostatic error mean |p - rho g (H - "
        f"z)| / (rho g H) over {int(ctr.sum())} central particles {hydro:.6g} (a figure, not "
        f"a gate) [{card}]")
    if launches != 0:
        fail(f"StillWaterSA: the forces kernel launched {launches} times on the general path")
    if outside or peak >= DS_PEAK_GIB * gib:
        fail(f"StillWaterSA: {outside} fluid particles outside the box, peak memory "
             f"{peak / gib:.4f} GiB")

    # the new passes on the final state, 3 each (CUDA events)
    sts, aux, cells = sorted_inputs(grid, st)
    slots = int(cells.shape[0]) * K * 27 * K
    ds_kw = dict(cells=cells)
    moved = sts.pos + 1e-3 * dp  # an n+1 position for the timing
    new = sts.replace(pos=moved)
    ms = {
        "volumic_terms": cuda_ms(lambda: ds.volumic_terms(fw, grid, sts, moved, aux, **ds_kw),
                                 3, warmup=1),
        "gamma_boundary_terms": cuda_ms(
            lambda: ds.gamma_boundary_terms(fw, grid, sts, moved, aux, **ds_kw), 3, warmup=1),
        "apply_density_diffusion": cuda_ms(
            lambda: ds.apply_density_diffusion(fw, grid, sts, aux, out[1], **ds_kw), 3,
            warmup=1),
        "density_sum_update": cuda_ms(
            lambda: ds.density_sum_update(fw, grid, sts, new, aux, **ds_kw), 3, warmup=1),
    }
    fields = dict(**split_vec("pos", sts.pos), ptype=sts.info & 7)
    seg_pairs = int(neighbor_apply(grid, aux, fields, lambda c, n, g: {
        "n": (g.mask & (c["ptype"] == 0) & (n["ptype"] == 1)).float()},
        max_parts_per_cell=K, influenceradius=fw.sp.influenceradius + 0.5 * dp,
        cells=cells)["n"].sum())
    post_ms = ms["density_sum_update"] + ms["apply_density_diffusion"]
    say(f"[12 passes] StillWaterSA ppH {round(SA_H / dp)} final state, {int(cells.shape[0])} "
        f"occupied cells, {slots} pair slots per pass, {seg_pairs} fluid-segment pairs: "
        + ", ".join(f"{k} {v:.6g} ms ({v * 1e6 / slots:.4g} ns per slot)" for k, v in ms.items())
        + f"; density sum + diffusion {post_ms:.6g} ms after each Euler step x {2 * steps} "
        f"per chunk (CUDA events, 3 each) [{card}]")

    # the static identity on the seeded state, on the card
    seeded, s_aux, s_cells = sorted_inputs(grid, state0.to(dev))
    seeded = ds.init_dynamic_gamma(fw, grid, seeded, s_aux, cells=s_cells)
    same = ds.density_sum_update(fw, grid, seeded, seeded, s_aux, cells=s_cells)
    act = seeded.active
    rho_err = float((same.rho - seeded.rho)[act].abs().max())
    gam_err = float((same.extras["gamma"] - seeded.extras["gamma"])[act].abs().max())
    del warm, out, st, sts, aux, new, moved, seeded, same, sim
    torch.cuda.empty_cache()

    # gamma integrated over a rigid displacement against the quadrature
    prob_d, fw_d, grid_d, state_d = problem("StillWaterSA", {"ppH": DS_DRIFT_PPH})
    cur, d_aux, d_cells = sorted_inputs(grid_d, state_d.to(dev))
    cur = ds.init_dynamic_gamma(fw_d, grid_d, cur, d_aux, cells=d_cells)
    moving = (cur.active & is_fluid(cur.info))[:, None]
    nsub = 8
    step = torch.tensor([0.0, 0.0, -0.3 * fw_d.sp.deltap / nsub], **f32)
    for _ in range(nsub):
        nxt = cur.replace(pos=torch.where(moving, cur.pos + step, cur.pos))
        cur = ds.integrate_gamma(fw_d, grid_d, cur, nxt, d_aux, cells=d_cells)
    quad, _ = compute_gamma(fw_d, grid_d, cur, d_aux, cells=d_cells, with_grad=False)
    sel = moving[:, 0] & (quad < 0.999)
    drift = float((cur.extras["gamma"] - quad)[sel].abs().max())
    n_sel = int(sel.sum())
    say(f"[12 identity] on the card: the static density sum of StillWaterSA ppH "
        f"{round(SA_H / dp)}'s seeded state moves rho by {rho_err:.3g} (bar {DS_STATIC_RHO}) "
        f"and gamma by {gam_err:.3g} (bar {DS_STATIC_GAMMA}); at ppH {DS_DRIFT_PPH}, gamma "
        f"integrated over {nsub} steps of a rigid 0.3 dp displacement of the fluid towards "
        f"the floor against the quadrature at the displaced positions: max error "
        f"{drift:.3g} over {n_sel} fluid particles near a wall (bar {DS_DRIFT_ATOL}) [{card}]")
    if not (rho_err <= DS_STATIC_RHO and gam_err <= DS_STATIC_GAMMA and drift <= DS_DRIFT_ATOL
            and n_sel > 10):
        fail("StillWaterSA: the density sum misses the static identity or the integrated "
             "gamma leaves the quadrature")

    # --- card vs CPU at ppH 10 -------------------------------------------------------------
    prob_c, fw_c, grid_c, state_c = problem("StillWaterSA", {"ppH": DS_CPU_PPH})
    sa_, c_aux, c_cells = sorted_inputs(grid_c, state_c.to(dev))
    sa_ = ds.init_dynamic_gamma(fw_c, grid_c, sa_, c_aux, cells=c_cells)
    rng = np.random.default_rng(12)
    fluid = ((sa_.info & 7) == 0).cpu().numpy()
    nf = int(fluid.sum())
    rho = sa_.rho.cpu().numpy().copy()
    rho[fluid] += rng.normal(0.0, 1e-3, size=nf)
    new_pos = sa_.pos.cpu().numpy().copy()
    new_pos[fluid] += rng.uniform(-0.17, 0.17, size=(nf, 3)) * fw_c.sp.deltap
    sa_ = sa_.replace(rho=torch.as_tensor(rho, **f32))
    npa = torch.as_tensor(new_pos, **f32)
    sb, b_aux, b_cells = sorted_inputs(grid_c, sa_.to("cpu"))
    if not torch.equal(sa_.id.cpu(), sb.id):
        fail("StillWaterSA: the card and the CPU sort the particles differently")
    npb = npa.cpu()
    t0 = time.perf_counter()
    rows = {}
    rows["volumic sum"] = (ds.volumic_terms(fw_c, grid_c, sa_, npa, c_aux, cells=c_cells),
                           ds.volumic_terms(fw_c, grid_c, sb, npb, b_aux, cells=b_cells))
    ga = ds.gamma_boundary_terms(fw_c, grid_c, sa_, npa, c_aux, cells=c_cells)
    gb = ds.gamma_boundary_terms(fw_c, grid_c, sb, npb, b_aux, cells=b_cells)
    rows["gamma increment"] = (ga["ggdotr"], gb["ggdotr"])
    grad = lambda d: torch.stack([d[k] for k in ("ggx", "ggy", "ggz")], -1)  # noqa: E731
    rows["grad gamma"] = (grad(ga), grad(gb))
    # the same pass in f64 on the CPU
    f64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    s64 = sb.replace(pos=f64(sb.pos), extras={k: f64(v) for k, v in sb.extras.items()})
    exact = grad(ds.gamma_boundary_terms(fw_c, grid_c, s64, f64(npb), b_aux, cells=b_cells))
    g_scale = float(exact.abs().max())
    g_card, g_cpu = (float((grad(x).cpu().double() - exact).abs().max()) for x in (ga, gb))
    ua = ds.density_sum_update(fw_c, grid_c, sa_, sa_.replace(pos=npa), c_aux, cells=c_cells)
    ub = ds.density_sum_update(fw_c, grid_c, sb, sb.replace(pos=npb), b_aux, cells=b_cells)
    rows["summed rho"] = (ua.rho, ub.rho)
    rows["summed gamma"] = (ua.extras["gamma"], ub.extras["gamma"])
    # the diffusion pass from the card's summed state on both devices
    dt_c = torch.tensor(1e-3, **f32)
    da = ds.apply_density_diffusion(fw_c, grid_c, ua, c_aux, dt_c, cells=c_cells)
    db = ds.apply_density_diffusion(fw_c, grid_c, ua.to("cpu"), b_aux, dt_c.cpu(),
                                    cells=b_cells)
    rows["diffusion change"] = (da.rho - ua.rho, db.rho - ua.rho.cpu())
    both_s = time.perf_counter() - t0
    report, ok = [], True
    for k, (x, y) in rows.items():
        rtol, frac, floor = DS_CARD_CPU[k]
        good, err, scale = held(x.cpu().numpy(), y.numpy(), rtol, frac, floor)
        ok &= good and scale > 0
        report.append(f"{k} {err:.3g} of {scale:.3g}{'' if good else ' MISMATCH'}")
    ok &= max(g_card, g_cpu) <= DS_GRAD_F64 * g_scale
    say(f"[12 card-cpu] StillWaterSA ppH {DS_CPU_PPH} ({int(sa_.count_active())} particles, "
        f"the fluid displaced by up to 0.3 dp): card vs CPU max abs diff "
        f"{', '.join(report)} (tolerances {json.dumps(DS_CARD_CPU)} as rtol, atol x max, "
        f"atol floor); grad gamma against the CPU's f64 pass: card {g_card:.3g}, CPU "
        f"{g_cpu:.3g} of {g_scale:.3g} (bar {DS_GRAD_F64} x max); the passes took "
        f"{both_s:.3f} s; StillWaterSA took {part_s():.1f} s [{card}]")
    if not ok:
        fail("StillWaterSA: the density-sum passes on the card disagree with the CPU")
    del sa_, ua, da, ga

    # --- BiFluidPoiseuilleSA: periodic SA plates -------------------------------------------
    prob, fw, grid, state0 = problem("BiFluidPoiseuilleSA", {})
    n0 = int(state0.count_active())
    sts, aux, cells = sorted_inputs(grid, state0.to(dev))
    sts = ds.init_dynamic_gamma(fw, grid, sts, aux, cells=cells)
    terms = ds.gamma_boundary_terms(fw, grid, sts, sts.pos, aux, cells=cells)
    _, quad_gg = compute_gamma(fw, grid, sts, aux, cells=cells)
    fl = (sts.info & 7) == 0
    mine = torch.stack([terms[k] for k in ("ggx", "ggy", "ggz")], -1)[fl]
    scale = float(quad_gg[fl].abs().max())
    per_err = float((mine - quad_gg[fl]).abs().max())
    inc = float(terms["ggdotr"].abs().max())
    forces_kernel.launches = 0
    sim = Simulator(prob.fw, grid)
    t0 = time.perf_counter()
    st = sim.run(state0, maxiter=fw.sp.buildneibsfreq)
    torch.cuda.synchronize()
    bi_s = time.perf_counter() - t0
    launches = forces_kernel.launches
    checks = sane("BiFluidPoiseuilleSA", st, n0, sim.dt)
    say(f"[12 periodic] BiFluidPoiseuilleSA (periodic {int(grid.periodic)}, grid "
        f"{'x'.join(map(str, grid.ncells))}, K {fw.sp.max_parts_per_cell}): {n0} particles; "
        f"with no motion the density sum's n+1 grad gamma against compute_gamma's, max abs "
        f"diff {per_err:.3g} of {scale:.4g} over {int(fl.sum())} fluid rows (bar "
        f"{DS_PERIODIC_FRAC} x max), gamma increment {inc:.3g}; one chunk through "
        f"Simulator.run {bi_s:.3f} s (host clock, seeding included), forces-kernel launches "
        f"{launches}; {checks}; took {part_s():.1f} s [{card}]")
    if not (per_err <= DS_PERIODIC_FRAC * scale and inc <= 1e-7 and launches == 0):
        fail("BiFluidPoiseuilleSA: the periodic n+1 grad gamma misses the quadrature, or "
             "the kernel launched")
    del sts, aux, terms, st, sim

    # --- LithostaticSA at dp 0.1: the cold EFFPRES solve in the warm-up chunk -------------
    prob, fw, grid, state0 = problem("LithostaticSA", LITHOSTATIC_SA)
    n0 = int(state0.count_active())
    forces_kernel.launches = 0
    sim = Simulator(prob.fw, grid)
    t0 = time.perf_counter()
    st = sim.run(state0, maxiter=fw.sp.buildneibsfreq)
    torch.cuda.synchronize()
    lith_s = time.perf_counter() - t0
    launches = forces_kernel.launches
    checks = sane("LithostaticSA", st, n0, sim.dt)
    ep = st.extras["effpres"]
    if float(ep.max()) > float(ep.min()):
        slope, r2, n_fit, want = effpres_slope(fw, st.pos, ep, st.info)
        fit = (f"effpres falls {slope:.6g} Pa/m with depth over {n_fit} interior sediment "
               f"particles (R^2 {r2:.6f}), {slope / want:.4f} of (rho_sed - rho_w) g = "
               f"{want:.6g}")
    else:
        fit = f"effpres is {float(ep.max()):.6g} everywhere"
    say(f"[12 lithostatic] LithostaticSA {LITHOSTATIC_SA}: {n0} particles (grid "
        f"{'x'.join(map(str, grid.ncells))}, K {fw.sp.max_parts_per_cell}); a warm-up chunk "
        f"through Simulator.run (its cold EFFPRES solve) {lith_s:.3f} s (host clock), "
        f"forces-kernel launches {launches}; {checks}; {fit} (a figure, not a gate); took "
        f"{part_s():.1f} s [{card}]")
    if launches != 0:
        fail(f"LithostaticSA: the forces kernel launched {launches} times")
    del st, sim
    torch.cuda.empty_cache()

    # --- StillWaterRepackSA through the CLI --------------------------------------------------
    forces_kernel.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repack_sa_") as tmp:
        argv = REPACK_SA_ARGV + ["--dir", tmp]
        text = run_cli(argv)
        if not os.path.exists(os.path.join(tmp, "repack.npz")):
            fail("StillWaterRepackSA: --repack wrote no repack.npz")
    ends = [ln for ln in text.splitlines() if ln.startswith("Simulation end")]
    if not ends or " 10 iterations" not in ends[-1] or "device cuda" not in text:
        fail(f"StillWaterRepackSA: the CLI did not run 10 iterations on the card: {ends}")
    if forces_kernel.launches != 0:
        fail(f"StillWaterRepackSA: the forces kernel launched {forces_kernel.launches} times")
    say(f"[12 repack] python -m gpusph_tpu_torch {' '.join(REPACK_SA_ARGV)}: repacked, then "
        f"10 iterations on the card, forces-kernel launches {forces_kernel.launches}; took "
        f"{part_s():.1f} s; phase 12 took {time.perf_counter() - phase_t0:.1f} s (host clock) "
        f"[{card}]")


def main() -> int:
    import torch

    script_t0 = SCRIPT_T0
    phase_s = []  # (phase, host seconds)

    def phase_done(label):
        """Print and record the host seconds since the previous phase ended."""
        now = time.perf_counter()
        s = now - (script_t0 + sum(t for _, t in phase_s))
        phase_s.append((label, s))
        say(f"[time] phase {label}: {s:.1f} s (host clock)")

    # --- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"
    say(f"[1 device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, ROOT)
    from gpusph_tpu_torch import _build
    from gpusph_tpu_torch.integrator import Simulator
    from gpusph_tpu_torch.convert import state_from_numpy
    from gpusph_tpu_torch.ops import forces_kernel
    from gpusph_tpu_torch.ops.block_plan import GROUP, build_block_plan
    from gpusph_tpu_torch.ops.neighbors import build_cells, make_grid
    from gpusph_tpu_torch.problems.base import get_problem

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    say(f"[2 build] {os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    for ln in _build.ptxas_report().splitlines():
        say(f"  {ln.strip()}")
    say("kernels: forces (cuda, gpusph_tpu_torch/csrc/forces.cu)")

    phase_done("1-2")

    # --- 3. kernel vs plain version -------------------------------------------
    dp_small, configs = small_configs()
    for name, fw in configs.items():
        rng = np.random.default_rng(1234)
        state = state_from_numpy(random_scene(rng, dp_small), device=dev)
        grid = make_grid((0, 0, 0), (0.3, 0.3, 0.3), fw.influenceradius)
        ok, _, rep = compare_kernel(fw, grid, state)
        say(f"[3 parity] {name}: {'ok' if ok else 'MISMATCH'} {json.dumps(rep)}")
        if not ok:
            fail(f"kernel disagrees with the plain version on {name}")

    Dam = get_problem("DamBreak3D")
    prob = Dam({"deltap": 0.012})
    grid, state0 = prob.build()
    sim = Simulator(prob.fw, grid, bodies_specs=prob.body_specs(), device="cuda")
    st2 = sim.run(state0, maxiter=20)
    torch.cuda.synchronize()
    dam_fw, dam_grid = sim.fw, grid  # phase 9 holds the general path to the kernel here
    ok, dam_err, rep = compare_kernel(sim.fw, grid, st2)
    say(f"[3 parity] DamBreak3D dp 0.012 after 2 chunks, "
        f"{int(st2.count_active())} active: {'ok' if ok else 'MISMATCH'} {json.dumps(rep)}")
    if not ok:
        fail("kernel disagrees with the plain version on DamBreak3D dp 0.012")
    sts, aux = build_cells(grid, st2)
    plan = build_block_plan(sim.fw, grid, sts, aux)
    P = forces_kernel.prop_table(sim.fw, sts)
    first = forces_kernel.pair_forces(sim.fw, grid, P, plan)
    same = torch.equal(first, forces_kernel.pair_forces(sim.fw, grid, P, plan))
    say(f"[3 determinism] DamBreak3D dp 0.012: two launches on the same inputs are "
        f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("two launches of the forces kernel on the same inputs differ")

    phase_done("3")

    # --- 4. main path at full size --------------------------------------------
    prob = Dam({"deltap": 0.012})
    grid, state0 = prob.build()
    sim = Simulator(prob.fw, grid, bodies_specs=prob.body_specs(), device="cuda")
    n0 = int(state0.count_active())
    forces_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim.run(state0, maxiter=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = forces_kernel.launches
    n1 = int(st.count_active())
    if launches != 100:
        fail(f"forces kernel launched {launches} times in 50 iterations, expected 100")
    if n1 != n0:
        fail(f"n_active changed: {n0} -> {n1}")
    finite = all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel, st.rho))
    if not finite:
        fail("non-finite state after 50 iterations")
    if not sim.dt > 1e-10:
        fail(f"dt underflow: {sim.dt}")
    psps = n0 * 50 / wall
    say(f"[4 main path] DamBreak3D dp 0.012: {n0} particles, 50 iterations in "
        f"{wall:.3f} s = {psps:.6g} particle-steps/s (host clock to synchronize, "
        f"first chunk included); launches {launches}; dt {sim.dt:.6g}; t {sim.t:.6g} "
        f"[{card}]")

    # kernel timing at the main path's shapes (this run's final state)
    fw = sim.fw
    sts, aux = build_cells(grid, st)
    plan = build_block_plan(fw, grid, sts, aux)
    P = forces_kernel.prop_table(fw, sts)
    kernel_ms = cuda_ms(lambda: forces_kernel.pair_forces(fw, grid, P, plan), 50, warmup=3)
    plain_ms = cuda_ms(lambda: forces_kernel.pair_forces_reference(fw, grid, P, plan), 3,
                       warmup=1)
    t_used = int(plan.tile_off[-1])
    kept_groups = int((plan.flat_groups[: t_used * 8] < P.shape[0] // GROUP - 1).sum())
    work = pair_stats(P, plan, sts.capacity, fw.sp.influenceradius ** 2)
    candidates, in_range = work["candidates"], work["in_range"]
    flops = candidates * CANDIDATE_FLOPS + in_range * IN_RANGE_FLOPS_DAMBREAK3D
    N = sts.capacity
    nbytes = (N + 1) * 64 + N * 32
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    # per-layer split of one chunk at the same state (CUDA events)
    from gpusph_tpu_torch.integrator import make_sim_chunk

    chunk = make_sim_chunk(fw, grid, bodies_specs=prob.body_specs())
    dt_t = torch.tensor(sim.dt, dtype=torch.float32, device=dev)
    t_t = torch.tensor(sim.t, dtype=torch.float32, device=dev)
    chunk_ms = cuda_ms(lambda: chunk(st, dt_t, t_t, 0, sim.bodies), 3, warmup=1)
    rebuild_ms = cuda_ms(lambda: build_block_plan(fw, grid, *build_cells(grid, st)), 10)
    steps = fw.sp.buildneibsfreq
    rest_ms = chunk_ms - rebuild_ms - 2 * steps * kernel_ms
    say(f"[4 layers] one chunk ({steps} steps) {chunk_ms:.6g} ms: rebuild (sort + plan) "
        f"{rebuild_ms:.6g} ms, forces kernel {2 * steps} x {kernel_ms:.6g} ms = "
        f"{2 * steps * kernel_ms:.6g} ms, rest of the steps (property table, finalize, "
        f"Euler, bodies, dt) {rest_ms:.6g} ms; {sts.capacity * steps / chunk_ms * 1e3:.6g} "
        f"particle-steps/s in steady state [{card}]")
    # device busy share and the largest device consumers over one chunk
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk(st, dt_t, t_t, 0, sim.bodies)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (a CPU op reports its kernels' time again)
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:6]
    say(f"[4 trace] one chunk under torch.profiler: wall {prof_wall_ms:.6g} ms, device busy "
        f"{busy_ms:.6g} ms (share {busy_ms / prof_wall_ms:.4f}); top device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.4g} ms x{e.count}"
                    for e in top) + f" [{card}]")
    say(f"[4 kernel] forces: {kernel_ms:.6g} ms/launch (CUDA events, 50 launches), "
        f"plain version {plain_ms:.6g} ms; tiles {t_used}, kept groups {kept_groups}, "
        f"candidate pairs {candidates} x {CANDIDATE_FLOPS} flop + in-range pairs "
        f"{in_range} x {IN_RANGE_FLOPS_DAMBREAK3D} flop = {flops:.6g} flop = "
        f"{t_ops:.6g} ms at 67 TFLOP/s; "
        f"{nbytes} B = {t_bytes:.6g} ms at 3.35 TB/s; bound {bound_ms:.6g} ms ({bound_by}); "
        f"roofline share {bound_ms / kernel_ms:.4f} [{card}]")
    comp = compaction(work)
    say(f"[4 compaction] {work['warp_tiles']} (warp, tile) pairs of live warps: mean "
        f"popcount {comp['mean_popcount']:.6g}, mean max popcount "
        f"{comp['mean_max_popcount']:.6g}, useful share of the body iterations "
        f"{comp['useful_share']:.4f}; body iterations {work['body_compacted']} compacted "
        f"against {work['body_slotwise']} slot by slot "
        f"({comp['slotwise_per_warp_tile']:.6g} per (warp, tile))")

    phase_done("4")

    # --- 5. golden fingerprint --------------------------------------------------
    drift, limit, dt_ref, dt_now = golden_drift("DamBreak3D", {"deltap": 0.04, "max_ppc": 64},
                                                100)
    say(f"[5 golden] DamBreak3D dp 0.04, 100 iterations: max drift pos {drift['pos']:.6g} "
        f"(limit {limit:.6g}), vel {drift['vel']:.6g}, rho {drift['rho']:.6g}; "
        f"dt_ref {dt_ref:.6g} dt_now {dt_now:.6g} [{card}]")
    if not drift["pos"] <= limit:
        fail("golden: pos drift above 1e-3 x max|pos|")

    phase_done("5")

    # --- 6. output path --------------------------------------------------------
    output_phase(dev, card)
    phase_done("6")

    # --- 7. the catalog ----------------------------------------------------------
    catalog_phase(card)
    phase_done("7")

    # --- 8. body motion, filters, effective viscosity ----------------------------
    slice_phase(dev, card)
    phase_done("8")

    # --- 9. the general pair path --------------------------------------------------
    general_phase(dev, card, (dam_fw, dam_grid, st2))
    phase_done("9")

    # --- 10. granular Jacobi solver, DEM terrain, OilJet, Generic ---------------------
    granular_phase(dev, card)
    phase_done("10")

    # --- 11. SA walls on the gamma-quadrature path -----------------------------------
    sa_phase(dev, card)
    phase_done("11")

    # --- 12. density summation and the dynamic gamma on SA walls ---------------------
    density_sum_phase(dev, card)
    phase_done("12")
    say("[time] " + ", ".join(f"phase {k} {t:.1f} s" for k, t in phase_s)
        + f"; total {time.perf_counter() - script_t0:.1f} s (host clock, nvcc included) "
        f"[{card}]")

    say(json.dumps({"kernels": [{
        "name": "forces",
        "route": "cuda",
        "source": "gpusph_tpu_torch/csrc/forces.cu",
        "replaces": "gpusph_tpu/ops/forces_pallas.py:855",
        "launches": launches,
        "max_abs_err": dam_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
