#!/usr/bin/env python3
"""Where the time goes in the port's train step, on the card.

Builds the training run of ``repro_torch.launch.train`` (seeded weights on
the card, float32 AdamW state, the token stream), runs ``--warm`` steps,
with CUDA events around the three parts of each: the forward of
``lm_loss``, its backward (the remat recompute included) and
``adamw_update``. Then it profiles one more step with ``torch.profiler``.
It prints the last warm step's ms and its parts, the profiled step's
device time per kernel class (the B2 backward's launches, the B2 forward,
the B3 forward and backward, cuBLAS matrix products, the rest) and per kernel name, and the device's
busy share of that synchronised step. ``--arch mamba2-780m`` (or
zamba2-7b) splits an ssm (hybrid) step the same way, with the SSD chunk
scan's forward kernels and its backward kernel (``csrc/ssd_chunk_bwd.cu``)
as classes of their own.

``--layout select`` hands each layer ``t[i]`` views of the stacked leaves
in place of the forward's one ``unbind`` a leaf (``models/lm.py:_layers``),
so the two layouts' backward can be compared within one call.

Run on a machine with the card (the script refuses to run without one):

    PYTHONPATH=src python3 tools/profile_torch_train.py \
        [--arch qwen3-4b] [--shape long_500k] [--batch 2] [--seq 16384] \
        [--warm 2] [--layout unbind|select]
    PYTHONPATH=src python3 tools/profile_torch_train.py \
        --arch mamba2-780m --batch 16 --seq 4096

The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from profile_torch_serve import GEMM_MARKS, _union_us


def kernel_class(name: str) -> str:
    if "swa_bwd_" in name:
        return "swa_attention_bwd kernels"
    if "swa_attention" in name:
        return "swa_attention forward kernel"
    if "ssd_bwd_" in name:
        return "ssd_chunk_bwd kernels"
    if any(k in name for k in ("ssd_chunk_state", "ssd_state_scan",
                               "ssd_chunk_out", "ssd_chunked_kernel")):
        return "ssd forward kernels"
    if any(m in name.lower() for m in GEMM_MARKS):
        return "cuBLAS matmul"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--shape", default="long_500k")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16384)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--layout", default="unbind", choices=("unbind",
                                                           "select"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.launch.train import SEED
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda", 0)
    _build.build_all()
    if args.layout == "select":
        def select_layers(tree):
            if tree is None:
                return []
            n = len(next(lm.tree_leaves(tree))[1])
            return [lm._layer(tree, i) for i in range(n)]
        lm._layers = select_layers
    cfg = steps.effective_config(get_config(args.arch), SHAPES[args.shape])
    params = init_params(lm.model_decls(cfg),
                         torch.Generator(device=dev).manual_seed(SEED), dev,
                         cfg.pdtype)
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    opt = adamw_init(params, ocfg)

    marks = []            # CUDA events: start, forward end, AdamW (2)
    lm_loss, adamw_update = lm.lm_loss, steps.adamw_update

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    def timed_loss(*a, **k):
        out = lm_loss(*a, **k)
        mark()
        return out

    def timed_adamw(*a, **k):
        mark()
        out = adamw_update(*a, **k)
        mark()
        return out

    lm.lm_loss, steps.adamw_update = timed_loss, timed_adamw
    step_fn = steps.make_train_step(cfg, ocfg, device=dev)
    stream = TokenStream(args.batch, args.seq, cfg.vocab_size,
                         device=dev).start(0)
    try:
        warm = []
        for s in range(args.warm):
            batch = stream.get(s)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks.clear()
            t0 = time.perf_counter()
            mark()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        start, fwd_end, opt_start, opt_end = marks
        parts = {"forward_ms": start.elapsed_time(fwd_end),
                 "backward_ms": fwd_end.elapsed_time(opt_start),
                 "adamw_ms": opt_start.elapsed_time(opt_end)}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        batch = stream.get(args.warm)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stream.stop()
    loss = float(m["loss"])
    del params, opt

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _union_us(spans) / 1e3
    sum_ms = sum(b - a for a, b in spans) / 1e3
    per_name, per_class = {}, {}
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) / 1e3
        for table, key in ((per_name, e.name), (per_class,
                                                kernel_class(e.name))):
            n, s = table.get(key, (0, 0.0))
            table[key] = (n + 1, s + t)

    def rows(table, label):
        return [{label: k[:80], "count": n, "device_ms": t,
                 "share": t / sum_ms}
                for k, (n, t) in sorted(table.items(),
                                        key=lambda kv: -kv[1][1])]

    by_class, by_name = rows(per_class, "class"), rows(per_name, "name")
    tokens = args.batch * args.seq
    print(f"[warm] layout {args.layout}: steps "
          f"{', '.join(f'{t:.1f}' for t in warm)} ms; the last "
          f"{tokens / warm[-1] * 1e3:.1f} tok/s: forward "
          f"{parts['forward_ms']:.3f}, backward {parts['backward_ms']:.3f}, "
          f"adamw {parts['adamw_ms']:.3f} ms; peak {peak:.2f} GiB")
    print(f"[profile] step wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.4f}); loss {loss:.4f}")
    for row in by_class:
        print(f"  {row['device_ms']:10.3f} ms  {row['share']:7.2%}  "
              f"x{row['count']:<6d} {row['class']}")
    for row in by_name[:15]:
        print(f"  {row['device_ms']:10.3f} ms  {row['share']:7.2%}  "
              f"x{row['count']:<6d} {row['name']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "arch": cfg.name, "shape": args.shape, "window": cfg.window,
        "layers": cfg.n_layers, "batch": args.batch, "seq": args.seq,
        "layout": args.layout, "warm_ms": warm,
        "tok_per_s": tokens / warm[-1] * 1e3, **parts,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
        "idle_share": 1 - busy_ms / wall_ms, "kernel_sum_ms": sum_ms,
        "peak_gib": peak, "loss": loss, "by_class": by_class,
        "by_name": by_name[:30]}))


if __name__ == "__main__":
    main()
