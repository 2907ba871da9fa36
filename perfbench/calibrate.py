#!/usr/bin/env python3
"""Read the numbers the correctness check compares, on the card, over
many seeds in one process: of the program as it is (the lower readings
of the limits), of the control (``control.control_step`` in the
program's place; for a prefill cell on the prompts a run checks, with no
window) and of each fault of ``control.FAULTS`` (the upper
readings). The benchmark's own runs never run this. One JSON line a run:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --modes program,control,half_batch [--seconds 2]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.ROOT / "src"))
    import control
    kind = cell.mix["kind"]
    for mode in args.modes.split(","):
        if mode == "program":
            wrap = None
        elif mode == "control":
            wrap = lambda _step: control.control_step(cell)  # noqa: E731
        else:
            wrap = control.FAULTS[kind][mode]
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            if mode == "control" and kind == "prefill":
                drv = harness.driver(kind).Driver(cell, seed,
                                                  torch.device("cuda"))
                checks, metrics = control.prefill_control_numbers(drv), {}
                correct = all(v <= cell.limits[k] for k, v in checks.items())
            else:
                line = harness.run_cell(cell, seed, args.seconds, False,
                                        device="cuda", t0=t0,
                                        wrap_step=wrap)
                checks = {k: v["value"] for k, v in line["checks"].items()}
                metrics = {k: v["value"] for k, v in line["metrics"].items()}
                correct = line["correct"]
            print(json.dumps({
                "cell": cell.name, "mode": mode, "seed": seed,
                "correct": correct,
                "checks": checks, "metrics": metrics,
                "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
