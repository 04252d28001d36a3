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
   DamBreak3D at dp 0.012 after two chunks, on every active particle;
4. main path at full size: ``Simulator.run`` on DamBreak3D at dp 0.012 for
   5 chunks (50 iterations); the forces kernel must have launched exactly
   twice per step; particle-steps/s, kernel and plain-version ms and the
   kernel's bound;
5. golden fingerprint: DamBreak3D at dp 0.04 (max_ppc 64), 100 iterations,
   against ``tests/references/DamBreak3D_100.npz``.

Then one JSON line describing each kernel, and last the ``ok`` line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

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


def count_pairs(fw, P, plan, capacity, chunk=256):
    """(candidate, in-range) pairs of one forces pass over ``plan``: real
    centrals x slots of the groups the plan kept, and those of them with
    0 < r^2 < rad^2, the pairs whose physics the kernel evaluates.  No
    minimum image: DamBreak3D has no periodic axis."""
    import torch

    from gpusph_tpu_torch.ops.block_plan import B, GPT, GROUP, TS

    nb = plan.n_blocks
    n_groups = P.shape[0] // GROUP - 1  # group n_groups is the pad sentinel
    pos = P[:, :3]
    rad2 = torch.tensor(fw.sp.influenceradius ** 2, dtype=torch.float32, device=P.device)
    t_used = int(plan.tile_off[-1])
    tb = plan.tile_block[:t_used].long()
    cen = plan.cen_idx[: nb * B].long().reshape(nb, B)
    fg = plan.flat_groups[: t_used * GPT].long().reshape(t_used, GPT)
    real_centrals = (cen < capacity).sum(dim=1)
    kept_slots = (fg < n_groups).sum(dim=1) * GROUP
    candidates = int((real_centrals[tb] * kept_slots).sum())
    lane = torch.arange(GROUP, device=P.device)
    in_range = 0
    for s in range(0, t_used, chunk):
        e = min(s + chunk, t_used)
        c = pos[cen[tb[s:e]]]  # [tiles, B, 3]
        w = pos[(fg[s:e, :, None] * GROUP + lane).reshape(e - s, TS)]  # [tiles, TS, 3]
        d = c[:, :, None, :] - w[:, None, :, :]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        in_range += int(((r2 > 0) & (r2 < rad2)).sum())
    return candidates, in_range


def compare_kernel(fw, grid, state):
    """Kernel vs plain version on the card for one sorted state.  Returns
    (ok, max |DvDt| error, report dict)."""
    import torch

    from gpusph_tpu_torch import SimFlags
    from gpusph_tpu_torch.ops.block_plan import build_block_plan
    from gpusph_tpu_torch.ops.forces_kernel import (finalize_forces, pair_forces,
                                                    pair_forces_reference,
                                                    prop_table)
    from gpusph_tpu_torch.ops.neighbors import build_cells

    st, aux = build_cells(grid, state)
    plan = build_block_plan(fw, grid, st, aux)
    P = prop_table(fw, st)
    got = finalize_forces(fw, st, plan, pair_forces(fw, grid, P, plan))
    ref = finalize_forces(fw, st, plan, pair_forces_reference(fw, grid, P, plan))
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


def main() -> int:
    import torch

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
    ok, dam_err, rep = compare_kernel(sim.fw, grid, st2)
    say(f"[3 parity] DamBreak3D dp 0.012 after 2 chunks, "
        f"{int(st2.count_active())} active: {'ok' if ok else 'MISMATCH'} {json.dumps(rep)}")
    if not ok:
        fail("kernel disagrees with the plain version on DamBreak3D dp 0.012")

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
    candidates, in_range = count_pairs(fw, P, plan, sts.capacity)
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

    # --- 5. golden fingerprint --------------------------------------------------
    prob = Dam({"deltap": 0.04, "max_ppc": 64})
    grid, state0 = prob.build()
    sim = Simulator(prob.fw, grid, bodies_specs=prob.body_specs(), device="cuda")
    st = sim.run(state0, tend=0.0, maxiter=100)
    ref = np.load(os.path.join(ROOT, "tests", "references", "DamBreak3D_100.npz"))
    act = st.active.cpu().numpy()
    ids = st.id.cpu().numpy().view(np.uint32)[act]
    order = np.argsort(ids)
    if not np.array_equal(ids[order], ref["ids"]):
        fail("golden: particle ids differ")
    drift = {}
    for key in ("pos", "vel", "rho"):
        cur = getattr(st, key).cpu().numpy()[act][order]
        drift[key] = float(np.abs(cur - ref[key]).max())
    pos_scale = float(np.abs(ref["pos"]).max())
    say(f"[5 golden] DamBreak3D dp 0.04, 100 iterations: max drift pos {drift['pos']:.6g} "
        f"(limit {1e-3 * pos_scale:.6g}), vel {drift['vel']:.6g}, rho {drift['rho']:.6g}; "
        f"dt_ref {float(ref['dt']):.6g} dt_now {sim.dt:.6g} [{card}]")
    if not drift["pos"] <= 1e-3 * pos_scale:
        fail("golden: pos drift above 1e-3 x max|pos|")

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
