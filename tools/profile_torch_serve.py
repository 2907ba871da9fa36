#!/usr/bin/env python3
"""Where the time goes in the port's GCN serving pass, on the card.

Serves a Table-I dataset once through ``repro_torch.launch.serve_pipeline``
(the cold pass that ``chip_smoke.py`` also makes), then

  * times ``--warm`` further passes of the same deployed pipeline with CUDA
    events (ms per pass of ``--micro`` requests, and inf/s);
  * profiles one more pass with ``torch.profiler``: device time per
    kernel name and per class (the row-wise CSR SpMM kernel, the
    blocked-ELL SpMM kernel, cuBLAS matrix products, the rest; kernels and
    copies on the device only), each SpMM wrapper's launches in that pass,
    the union of kernel intervals (device busy time) against the host wall
    time of the synchronised pass (busy and idle share), and the sum of
    kernel times over their union (how much the stage streams overlap).

The kernels are built before the cold pass, so it holds no ``nvcc`` time.

Run on a machine with the card (the script refuses to run without one):

    PYTHONPATH=src python3 tools/profile_torch_serve.py --dataset OA --micro 8

The last line is a JSON summary; ``--trace PATH`` also writes the Chrome
trace of the profiled pass.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "s16816", "s1688")


def kernel_class(name: str) -> str:
    if "spmm_csr_rows" in name:
        return "spmm_csr_rows kernel"
    if "spmm_blocked_ell" in name:
        return "spmm_blocked_ell kernel"
    if any(m in name.lower() for m in GEMM_MARKS):
        return "cuBLAS matmul"
    return "other"


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="OA")
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serve: needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, spmm_blocked_ell, spmm_csr_rows
    from repro_torch.launch.serve_pipeline import serve

    dev = torch.device("cuda", 0)
    _build.build_all()
    with torch.inference_mode():
        res = serve(args.dataset, args.micro, device=dev)
        ex, micro = res.executor, res.micro
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.warm):
            ex(micro)
        end.record()
        end.synchronize()
        warm_ms = start.elapsed_time(end) / args.warm

        torch.cuda.synchronize()
        launches = spmm_csr_rows.launches, spmm_blocked_ell.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex(micro)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = (spmm_csr_rows.launches - launches[0],
                    spmm_blocked_ell.launches - launches[1])

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _union_us(spans) / 1e3
    sum_ms = sum(b - a for a, b in spans) / 1e3
    print(f"[warm] {args.micro} requests: {warm_ms:.3f} ms a pass "
          f"({args.micro / warm_ms * 1e3:.3f} inf/s), mean of {args.warm}")
    print(f"[profile] pass wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}), kernel time "
          f"{sum_ms:.3f} ms over {len(kernels)} kernels "
          f"(overlap factor {sum_ms / max(busy_ms, 1e-9):.4f}); "
          f"spmm_csr_rows launches {launches[0]}, spmm_blocked_ell "
          f"launches {launches[1]}")
    per_name, per_class = {}, {}
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) / 1e3
        n, s = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (n + 1, s + t)
        c = kernel_class(e.name)
        n, s = per_class.get(c, (0, 0.0))
        per_class[c] = (n + 1, s + t)
    by_name = [{"name": k[:80], "count": n, "device_ms": t,
                "share": t / sum_ms}
               for k, (n, t) in sorted(per_name.items(),
                                       key=lambda kv: -kv[1][1])]
    by_class = [{"class": k, "count": n, "device_ms": t, "share": t / sum_ms}
                for k, (n, t) in sorted(per_class.items(),
                                        key=lambda kv: -kv[1][1])]
    for row in by_class:
        print(f"  {row['device_ms']:10.3f} ms  {row['share']:7.2%}  "
              f"x{row['count']:<4d} {row['class']}")
    for row in by_name:
        print(f"  {row['device_ms']:10.3f} ms  {row['share']:7.2%}  "
              f"x{row['count']:<4d} {row['name']}")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "dataset": args.dataset,
        "micro": args.micro, "cold_ms": res.seconds * 1e3,
        "warm_ms": warm_ms, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
        "idle_share": 1 - busy_ms / wall_ms, "kernel_sum_ms": sum_ms,
        "overlap_factor": sum_ms / max(busy_ms, 1e-9),
        "csr_launches": launches[0], "blocked_ell_launches": launches[1],
        "by_class": by_class, "by_name": by_name}))


if __name__ == "__main__":
    main()
