"""Serving launcher: streaming request routing (repro_torch.serving), the
port of ``repro/launch/serve.py --stream``.

Drive the signature-aware router with simulated traffic (the production
serving path; see src/repro_torch/serving/):

  PYTHONPATH=src python -m repro_torch.launch.serve --stream --duration 120 \\
      --peak-rate 10 --trough-rate 0.5 [--fail-at 40 --rejoin-at 80] \\
      [--backend analytic|torch] [--device cpu] [--max-cells 2] [--sync] \\
      [--calibrate-wall N] [--probation N] \\
      [--record-trace t.jsonl | --replay-trace t.jsonl | --trace-in c.jsonl] \\
      [--trace-out spans.jsonl] [--snapshot-every S]

``--backend torch`` runs every batch through ``TorchPipelineBackend``:
the schedule's stages as proxy stage functions on the card, the spmm
stages on the hand-written row-wise CSR SpMM kernel. ``--device cpu`` runs
the same stages on the CPU with the kernels' plain versions; without it
the torch backend needs a card.

Dispatch is asynchronous by default (non-blocking ``ExecutionBackend.
submit``; completions reaped in timestamp order with deferred reaping
across cycles, measured stage times fed to the straggler monitors);
``--sync`` restores blocking per-batch dispatch for comparison.

``--trace-out`` streams one span record per line — every request's
causal chain (arrival -> admit -> solve -> submit -> reap). Tracing is
derived output only.

``--trace-in`` replays a *converted real trace* whose compact rows
resolve workloads by catalog name — e.g.
``examples/traces/azure_llm_excerpt.jsonl``.

``--calibrate-wall N`` (any backend whose measurements are wall-clock,
i.e. torch) learns a per-(cell, stage) wall->sim scale over N reports
(after skipping the first, build-dominated one) and then feeds calibrated
measurements to the straggler monitors — real measurements can demote a
genuinely slow device instead of being telemetry-only.

Not ported yet: the decode mode (``--arch``) and the cluster, fleet,
energy, tenancy and dashboard flags of the reference's launcher.
"""
from __future__ import annotations

import argparse
import time


def run_stream(args):
    """Serve a simulated traffic stream through the serving subsystem;
    returns ``(router, sim, snapshot, wall seconds)``."""
    from ..core import DynamicScheduler, PerfModel, paper_system
    from ..obs import JsonlTraceSink, Tracer
    from ..runtime import ProbationTracker, WallClockCalibrator, make_backend
    from ..serving import (LoadWatermarkPolicy, PoolEvent, Router,
                           SignatureBatcher, TrafficSim)

    system = paper_system(args.interconnect)
    perf = PerfModel()
    dyn = DynamicScheduler(system, perf, mode="perf")
    if args.backend == "torch":
        backend = make_backend(args.backend, device=args.device)
    else:
        backend = make_backend(args.backend)
    # observability: one Tracer fans spans out to the JSONL file;
    # None = NULL_TRACER (publish sites cost one attribute check)
    tracer = Tracer(JsonlTraceSink(args.trace_out)) if args.trace_out \
        else None
    batcher = SignatureBatcher(max_batch=args.max_batch,
                               max_wait=args.max_wait)
    router = Router(
        dyn,
        batcher=batcher,
        policy=LoadWatermarkPolicy(low=args.low_watermark,
                                   high=args.high_watermark,
                                   window=args.policy_window,
                                   cooldown=args.mode_cooldown),
        backend=backend,
        max_cells=args.max_cells,
        async_mode=not args.sync,
        probation=(ProbationTracker(clean_epochs=args.probation)
                   if args.probation else None),
        calibrator=(WallClockCalibrator(warmup=args.calibrate_wall)
                    if args.calibrate_wall else None),
        tracer=tracer)
    events = []
    if args.fail_at is not None:
        events.append(PoolEvent(args.fail_at, "fail", args.fail_dev,
                                args.fail_count))
    if args.rejoin_at is not None:
        events.append(PoolEvent(args.rejoin_at, "join", args.fail_dev,
                                args.fail_count))
    snap_every = args.snapshot_every or None
    trace_path = args.replay_trace or args.trace_in
    if trace_path:
        sim = TrafficSim.from_jsonl(trace_path, seed=args.seed,
                                    peak_rate=args.peak_rate,
                                    events=tuple(events),
                                    snapshot_every=snap_every)
    else:
        sim = TrafficSim(seed=args.seed, duration=args.duration,
                         peak_rate=args.peak_rate,
                         trough_rate=args.trough_rate,
                         day=args.day, events=tuple(events),
                         snapshot_every=snap_every)
    t0 = time.time()
    snap = sim.run(router)
    wall = time.time() - t0
    print(f"[serve] backend={router.engine.backend.name} "
          f"max_cells={router.engine.max_cells} "
          f"dispatch={'sync' if args.sync else 'async'}")
    print(f"[serve] simulated {sim.duration:.0f}s of traffic in "
          f"{wall:.1f}s wall")
    print(f"[serve] completed={snap.completed} dropped={snap.dropped} "
          f"thp={snap.throughput:.2f} req/s")
    print(f"[serve] p50={snap.p50_latency*1e3:.1f}ms "
          f"p99={snap.p99_latency*1e3:.1f}ms "
          f"energy/req={snap.energy_per_req:.2f}J "
          f"deadline_miss={snap.deadline_miss_rate:.1%}")
    print(f"[serve] reschedules={snap.reschedules} "
          f"mode_switches={snap.mode_switches}")
    print(f"[serve] overlap={snap.overlap_ratio:.3f}x "
          f"(busy/wall; >1 = concurrent cells) "
          f"measured_stage_s={snap.measured_stage_s:.3f}")
    served = max(snap.completed + snap.dropped, 1)
    print(f"[serve] scheduler: dp_solves={dyn.dp_solves} "
          f"dp_per_1k_req={1e3 * dyn.dp_solves / served:.2f} "
          f"({snap.placements} decisions)")
    print(f"[serve] placement wall: p50={snap.place_ms_p50:.3f}ms "
          f"p99={snap.place_ms_p99:.3f}ms")
    print(f"[serve] schedules used: "
          f"{sorted(set(d.mnemonic for d in router.dispatches))}")
    print(f"[serve] engine: {router.engine.evictions} evictions, "
          f"{len(router.engine.cells)} resident cells at end")
    if snap.requeued:
        print(f"[serve] requeued={snap.requeued} requests after lost "
              f"batches (zero silently dropped)")
    if args.record_trace:
        sim.to_jsonl(args.record_trace)
        print(f"[serve] arrival trace -> {args.record_trace}")
    for line in router.log:
        print(f"[serve]   {line}")
    for line in router.engine.log:
        print(f"[serve]   engine: {line}")
    if sim.snapshots:
        print(f"[serve] {len(sim.snapshots)} metric snapshots "
              f"(every {args.snapshot_every:.0f}s)")
    if tracer is not None:
        tracer.flush(router.metrics.t_last)
        print(f"[serve] trace spans -> {args.trace_out}")
    return router, sim, snap, wall


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stream", action="store_true",
                    help="streaming traffic mode (repro_torch.serving); "
                         "the only mode ported so far")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--peak-rate", type=float, default=8.0)
    ap.add_argument("--trough-rate", type=float, default=0.5)
    ap.add_argument("--day", type=float, default=120.0)
    ap.add_argument("--interconnect", default="pcie4")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait", type=float, default=0.25)
    ap.add_argument("--low-watermark", type=float, default=0.3)
    ap.add_argument("--high-watermark", type=float, default=0.7)
    ap.add_argument("--policy-window", type=float, default=15.0)
    ap.add_argument("--fail-at", type=float)
    ap.add_argument("--rejoin-at", type=float)
    ap.add_argument("--fail-dev", default="FPGA")
    ap.add_argument("--fail-count", type=int, default=1)
    ap.add_argument("--backend", default="analytic",
                    choices=("analytic", "torch"),
                    help="execution backend behind the Engine")
    ap.add_argument("--device",
                    help="device of the torch backend (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--max-cells", type=int, default=2,
                    help="signature cells resident concurrently")
    ap.add_argument("--sync", action="store_true",
                    help="blocking per-batch dispatch instead of the "
                         "async submit/reap loop")
    ap.add_argument("--replay-trace", metavar="JSONL",
                    help="replay a recorded arrival trace instead of the "
                         "synthetic diurnal stream")
    ap.add_argument("--record-trace", metavar="JSONL",
                    help="write this run's arrival trace for later replay")
    ap.add_argument("--trace-in", metavar="JSONL",
                    help="serve a converted real trace (compact rows, "
                         "workloads resolved by catalog name — e.g. "
                         "examples/traces/azure_llm_excerpt.jsonl)")
    ap.add_argument("--probation", type=int, default=0, metavar="N",
                    help="re-admit straggler-demoted devices after N "
                         "clean epochs at reduced weight (0 = off)")
    ap.add_argument("--mode-cooldown", type=float, default=0.0,
                    metavar="S",
                    help="minimum seconds between perf/energy mode "
                         "flips (bounds flapping; 0 = watermark "
                         "hysteresis only)")
    ap.add_argument("--calibrate-wall", type=int, default=0, metavar="N",
                    help="calibrate wall-clock measured stage times onto "
                         "the simulated clock over N reports so they can "
                         "drive straggler demotion (0 = telemetry only)")
    ap.add_argument("--trace-out", metavar="JSONL",
                    help="stream request spans to this JSONL file")
    ap.add_argument("--snapshot-every", type=float, default=0.0,
                    metavar="S",
                    help="append a cumulative MetricsSnapshot every S sim "
                         "seconds (0 = final snapshot only)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if not args.stream:
        ap.error("only --stream is ported; the decode mode is not yet")
    if args.replay_trace and args.trace_in:
        ap.error("--replay-trace and --trace-in are mutually exclusive "
                 "(both replay an arrival JSONL)")
    if args.device is not None and args.backend != "torch":
        ap.error("--device applies to --backend torch only")
    run_stream(args)


if __name__ == "__main__":
    main()
