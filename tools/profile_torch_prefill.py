#!/usr/bin/env python3
"""Where the time goes in the port's prefill pass (SWA or SSD), on the card.

Runs ``repro_torch.launch.serve_prefill`` once (the cold pass that
``chip_smoke.py`` also makes; weights drawn on the card, kernels built
before it), then

  * times ``--warm`` further passes of the same prefill step on the same
    weights and tokens with CUDA events (ms a pass, tokens/s);
  * profiles one more pass with ``torch.profiler``: device time per kernel
    name and per class (the SWA kernel, each SSD kernel, cuBLAS matrix
    products, the rest),
    and the union of kernel intervals against the host wall time of the
    synchronised pass (device busy and idle share).

Run on a machine with the card (the script refuses to run without one):

    PYTHONPATH=src python3 tools/profile_torch_prefill.py \
        [--arch qwen3-4b] [--shape long_500k] [--batch 2] \
        [--prompt-len 16384] [--warm 2]

The mamba2 prefill: ``--arch mamba2-780m --shape prefill_32k --batch 4
--prompt-len 32768``.

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

from profile_torch_serve import GEMM_MARKS, _union_us


SSD_KERNELS = ("ssd_chunk_state", "ssd_state_scan", "ssd_chunk_out",
               "ssd_chunked")


def kernel_class(name: str) -> str:
    if "swa_attention" in name:
        return "swa_attention kernel"
    for k in SSD_KERNELS:
        if k in name:
            return f"{k} kernel"
    if any(m in name.lower() for m in GEMM_MARKS):
        return "cuBLAS matmul"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--shape", default="long_500k")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16384)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_prefill: needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ssd_chunked, swa_attention
    from repro_torch.launch.serve_prefill import serve_prefill
    from repro_torch.launch.steps import make_prefill_step

    dev = torch.device("cuda", 0)
    _build.build_all()
    res = serve_prefill(args.arch, shape=args.shape, batch=args.batch,
                        prompt_len=args.prompt_len, device=dev)
    step = make_prefill_step(res.cfg, device=dev)
    batch = res.batch
    with torch.inference_mode():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.warm):
            step(res.params, batch)
        end.record()
        end.synchronize()
        warm_ms = start.elapsed_time(end) / args.warm

        torch.cuda.synchronize()
        launches = swa_attention.launches, ssd_chunked.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(res.params, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = (swa_attention.launches - launches[0],
                    ssd_chunked.launches - launches[1])

    tokens = res.positions
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _union_us(spans) / 1e3
    sum_ms = sum(b - a for a, b in spans) / 1e3
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
    print(f"[warm] {tokens} tokens: {warm_ms:.3f} ms a pass "
          f"({tokens / warm_ms * 1e3:.3f} tok/s), mean of {args.warm}")
    print(f"[profile] pass wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}), kernel time "
          f"{sum_ms:.3f} ms over {len(kernels)} kernels; swa_attention "
          f"launches {launches[0]}, ssd_chunked launches {launches[1]}")
    for row in by_class:
        print(f"  {row['device_ms']:10.3f} ms  {row['share']:7.2%}  "
              f"x{row['count']:<5d} {row['class']}")
    for row in by_name[:15]:
        print(f"  {row['device_ms']:10.3f} ms  {row['share']:7.2%}  "
              f"x{row['count']:<5d} {row['name']}")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "arch": args.arch,
        "shape": args.shape, "batch": args.batch,
        "prompt_len": args.prompt_len, "family": res.cfg.family,
        "window": res.cfg.window, "layers": res.cfg.n_layers,
        "cold_ms": res.seconds * 1e3, "warm_ms": warm_ms,
        "warm_tok_per_s": tokens / warm_ms * 1e3,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "idle_share": 1 - busy_ms / wall_ms,
        "kernel_sum_ms": sum_ms, "swa_launches": launches[0],
        "ssd_launches": launches[1],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "by_class": by_class, "by_name": by_name[:30]}))


if __name__ == "__main__":
    main()
