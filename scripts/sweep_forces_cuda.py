#!/usr/bin/env python3
"""Time variants of the port's CUDA forces kernel on one card.

    python scripts/sweep_forces_cuda.py

Each variant is a copy of ``gpusph_tpu_torch/csrc/forces.cu`` with one text
patch, built by nvcc with the port's flags into
``gpusph_tpu_torch/_build/sweep/`` (one nvcc per variant, all started
together) and loaded with ctypes beside the port's own build (``k4``):

* ``k2`` .. ``k6``: ``__launch_bounds__(256, k)``, the register budget that
  lets k blocks share an SM (65,536 / (256 k) registers a thread);
* ``copies``: no range test and no pair body, so the tile loop keeps only
  its window copies, transposes and barriers;
* ``cheap``: the copies and the cheap part (offset, r^2, range masks), no
  pair body.

The inputs are the main path's: DamBreak3D at dp 0.012 after 50
iterations.  Each variant is timed with CUDA events over 50 launches, in two
rounds (in order, then reversed), and the output of each whole-kernel
variant is compared bit for bit with the port's ``pair_forces``.  Prints the
card, each build's ``-Xptxas -v`` registers, spills and shared memory per
instantiation, the times, and one JSON line last.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCHES = 50

BOUND = "constexpr int MIN_BLOCKS = 4;"
VARIANTS = {
    **{f"k{k}": [(BOUND, f"constexpr int MIN_BLOCKS = {k};")] for k in (2, 3, 5, 6)},
    "copies": [("if (live) m = range_mask<PERIODIC>(p, stage, lane, kept, cx, cy, cz);",
                "")],
    "cheap": [("    __syncthreads();  // s_col holds tile t\n",
               "    __syncthreads();  // s_col holds tile t\n"
               "    acc[0] += static_cast<float>(__popc(m));  // keeps the cheap part\n"
               "    m = 0;\n")],
}
WHOLE = ("k2", "k3", "k4", "k5", "k6")


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel instantiation: <periodic, lean>, registers,
    spills, shared memory."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            t = re.search(r"ILb(\d)ELb(\d)E", m.group(1))
            name = f"<periodic {t.group(1)}, lean {t.group(2)}>" if t else m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        elif m := re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln):
            out.append(f"{name}: {m.group(1)} registers, {spill}, {m.group(2)} B smem")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    from gpusph_tpu_torch import _build
    from gpusph_tpu_torch.integrator import Simulator
    from gpusph_tpu_torch.ops import forces_kernel
    from gpusph_tpu_torch.ops.block_plan import B, build_block_plan, group_count
    from gpusph_tpu_torch.ops.neighbors import build_cells
    from gpusph_tpu_torch.problems.base import get_problem

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    print(card, flush=True)

    src = (_build.CSRC_DIR / "forces.cu").read_text()
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch target is not in forces.cu once: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"forces_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _build.load_library()  # builds the port's own library meanwhile
    logs = {"k4": _build.library_path().with_suffix(".log").read_text()}
    libs = {"k4": port}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        lib = ctypes.CDLL(str(out_dir / f"forces_{name}.so"))
        for fn in ("gpusph_forces_launch", "gpusph_error_string"):
            getattr(lib, fn).argtypes = getattr(port, fn).argtypes
            getattr(lib, fn).restype = getattr(port, fn).restype
        libs[name] = lib
    names = ["k4", *VARIANTS]
    for name in names:
        for ln in ptxas_lines(logs[name]):
            print(f"{name} {ln}", flush=True)

    prob = get_problem("DamBreak3D")({"deltap": 0.012})
    grid, state0 = prob.build()
    sim = Simulator(prob.fw, grid, bodies_specs=prob.body_specs(), device="cuda")
    st = sim.run(state0, maxiter=50)
    fw = sim.fw
    sts, aux = build_cells(grid, st)
    plan = build_block_plan(fw, grid, sts, aux)
    P = forces_kernel.prop_table(fw, sts)
    want = forces_kernel.pair_forces(fw, grid, P, plan)
    iarr, farr = forces_kernel._ctypes_params(fw, grid)
    nb, cap = plan.n_blocks, sts.capacity
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        out = torch.empty((forces_kernel.NOUT, nb * B), dtype=torch.float32, device=P.device)
        code = lib.gpusph_forces_launch(
            ctypes.addressof(iarr), ctypes.addressof(farr), P.data_ptr(),
            plan.flat_groups.data_ptr(), plan.tile_off.data_ptr(),
            plan.cen_idx.data_ptr(), out.data_ptr(), nb, group_count(cap), cap, stream)
        _build.check(lib, code, "forces kernel launch")
        return out

    times = {name: [] for name in names}
    identical = {}
    for order in (names, names[::-1]):
        for name in order:
            lib = libs[name]
            if name in WHOLE:
                identical[name] = bool(torch.equal(launch(lib), want))
            for _ in range(3):
                launch(lib)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LAUNCHES):
                launch(lib)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / LAUNCHES)
    for name in names:
        same = (f"; output bit-identical to pair_forces: {identical[name]}"
                if name in identical else "")
        print(f"{name}: " + ", ".join(f"{t:.6g}" for t in times[name])
              + f" ms/launch{same}", flush=True)
    print(json.dumps({"card": card, "ms_per_launch": times, "identical": identical}),
          flush=True)
    return 0 if all(identical.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
