#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of two trees in turn on one card: A, B, B, A.

    python scripts/ab_chip_smoke.py PARENT_DIR CHANGE_DIR --out LOG_DIR

Each directory holds a whole tree, for example one unpacked with
``git archive <commit> | tar -x -C DIR``.  The four runs go one after the
other in the order parent, change, change, parent, so that a drift of the
card's clocks over the call shows as a difference between a tree's two
runs.  Each run's whole output goes to ``LOG_DIR/smoke_<n>_<tree>.log``;
the card's line, each run's exit code and wall time (host clock, the
kernels' build included) and its build, main-path, kernel, golden and
output-cost lines are printed as they are.  Exits non-zero if any run
failed.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

KEEP = ("[2 build]", "[4 ", "[5 golden]", "[6 cost]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except FileNotFoundError:
        card = ""
    print(card or "nvidia-smi unavailable", flush=True)
    failed = 0
    for n, tree in enumerate(("parent", "change", "change", "parent"), start=1):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=getattr(args, tree),
                              capture_output=True, text=True)
        wall = time.perf_counter() - t0
        (args.out / f"smoke_{n}_{tree}.log").write_text(proc.stdout + proc.stderr)
        print(f"run {n} {tree} rc={proc.returncode} in {wall:.1f} s", flush=True)
        for ln in proc.stdout.splitlines():
            if ln.startswith(KEEP):
                print(ln, flush=True)
        failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
