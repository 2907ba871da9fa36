"""Serving launcher: streaming request routing (repro_torch.serving) and
batched greedy decode for one architecture, the port of
``repro/launch/serve.py``.

Decode mode — one architecture's LM served token by token against its
caches (KV caches, the SWA ring buffer, the SSM conv and state caches):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      [--smoke] [--batch 4] [--prompt-len 32] [--gen 32] [--int8] \
      [--device cpu]

The prompt (numpy ``default_rng(0)``) is fed one token a step
(teacher-forced), then ``--gen`` tokens are generated greedily; it prints
tok/s and a sample. Weights are drawn from a seeded ``torch.Generator``
(``jax.random`` cannot be reproduced, so the sample differs from the
reference's). ``--int8`` serves the big projection matrices as int8
(``models/quant.py``), dequantized on each use. The full config runs on
one card (the reference runs it on a production mesh); ``--device cpu``
runs on the CPU. Every family is served: the moe family (deepseek)
through the absorbed MLA decode against its latent cache, the encdec
family (seamless) cross-attending to an encoder output of ones (the
reference's stand-in), the vlm family (paligemma) on its text tokens.

Streaming mode — drive the signature-aware router with simulated traffic
(the production serving path; see src/repro_torch/serving/):

  PYTHONPATH=src python -m repro_torch.launch.serve --stream --duration 120 \\
      --peak-rate 10 --trough-rate 0.5 [--fail-at 40 --rejoin-at 80] \\
      [--backend analytic|torch] [--device cpu] [--max-cells 2] [--sync] \\
      [--calibrate-wall N] [--probation N] \\
      [--record-trace t.jsonl | --replay-trace t.jsonl | --trace-in c.jsonl] \\
      [--tenants gold:0:1:2.5,bronze:2:3 [--no-preempt] [--starve-after S]] \\
      [--cluster N [--kill-worker T]] \\
      [--host-profiles w1=4 | w1=4:0.5,w2=2] [--steal] [--host-oblivious] \\
      [--true-host-profiles w1=60 --learn-profiles] [--autoscale] \\
      [--forecast-horizon S] [--replicate-hot N] [--migrate] \\
      [--governor [--power-cap-w W] [--energy-slo-j J]] \\
      [--record-cluster-events e.jsonl | --replay-cluster-events e.jsonl] \\
      [--trace-out spans.jsonl] [--dashboard] [--dashboard-every S] \\
      [--dashboard-html d.html] [--dashboard-port P] [--snapshot-every S]

``--backend torch`` runs every batch through ``TorchPipelineBackend``:
the schedule's stages as proxy stage functions on the card, the spmm
stages on the hand-written row-wise CSR SpMM kernel. ``--device cpu`` runs
the same stages on the CPU with the kernels' plain versions; without it
the torch backend needs a card.

Dispatch is asynchronous by default (non-blocking ``ExecutionBackend.
submit``; completions reaped in timestamp order with deferred reaping
across cycles, measured stage times fed to the straggler monitors);
``--sync`` restores blocking per-batch dispatch for comparison.

Observability (repro_torch.obs): ``--trace-out`` streams one span
record per line — every request's causal chain (arrival -> admit ->
solve -> submit -> [steal/requeue] -> reap) plus the control-plane story
(heartbeats, deploys, worker loss) — which ``obs.schema.validate``
checks. ``--dashboard`` renders a terminal frame every
``--dashboard-every`` sim seconds (per-worker occupancy, stragglers,
probation, mode, p50/p99); ``--dashboard-html`` writes a single-file
HTML replay of those frames, and ``--dashboard-port`` serves them live
over SSE until interrupted. Tracing is derived-output only: a traced
cluster run replays its event log byte-identically. On the torch backend
a worker's occupancy in a frame is read from its measured stage seconds,
which are real seconds on the device.

Multi-tenant serving (repro_torch.tenancy): ``--tenants`` declares
priority classes as ``name:priority[:share[:slo[:jcap]]]`` entries —
strict priority bands with weighted fair queueing inside each band,
tenant-pure batches, priority admission (a full queue displaces the
youngest lower-class request), and preemption: when a higher-priority
group is ready but blocked only by occupied capacity, the lowest-class
in-flight batch is drained and requeued (never dropped). ``--no-preempt``
keeps the bands ordering-only; ``--starve-after S`` bounds the lowest
class's wait (aged groups are promoted for dispatch ordering). A batch
preempted on the local torch backend was already enqueued on the device:
that work runs to its end and its report is never read.

``--trace-in`` replays a *converted real trace* whose compact rows
resolve workloads by catalog name — e.g.
``examples/traces/azure_llm_excerpt.jsonl``.

``--calibrate-wall N`` (any backend whose measurements are wall-clock,
i.e. torch) learns a per-(cell, stage) wall->sim scale over N reports
(after skipping the first, build-dominated one) and then feeds calibrated
measurements to the straggler monitors — real measurements can demote a
genuinely slow device instead of being telemetry-only.

``--cluster N`` serves through the multi-host control plane
(repro_torch.cluster): N in-process workers split the device pool, each
running its own ``--backend`` instance (with ``--backend torch``, each a
``TorchPipelineBackend`` on ``--device``, the card by default), with
heartbeat failure detection. ``--kill-worker T`` crashes the last worker
at simulated time T: heartbeat miss -> per-pool failures -> reschedule
onto the survivors, the dead worker's in-flight batches re-queued (zero
lost requests). The cluster event log records and replays through the
``--*-cluster-events`` flags. A cluster worker runs each batch to its
end before it answers (``WorkerCore`` calls the blocking ``execute``).

Heterogeneous fleets: ``--host-profiles w1=4,w2=2:0.5`` declares
per-worker ``HostProfile``s as ``wid=COMPUTE[:BW]`` pairs (w1 4x slower;
w2 2x slower with half the bandwidth). The control plane is host-aware
by default (cells place by effective throughput, each cell's DP re-solves
for its host); ``--steal`` migrates pending batches from slow to
dry-and-faster workers; ``--host-oblivious`` keeps device-count placement
while the profiled hosts still run slow.

Fleet management (repro_torch.fleet): ``--true-host-profiles w1=60``
injects ground-truth physics the control plane cannot see, and
``--learn-profiles`` learns each host's profile from measured-vs-
expected stage times (on the torch backend, card seconds that reach it
through ``--calibrate-wall``'s calibrator) and publishes it once
confident. ``--forecast-horizon S`` drives the perf/energy policy from a
Holt arrival forecast S seconds out; ``--autoscale`` pre-warms hot cells
and parks/unparks workers; ``--replicate-hot N`` serves the hottest cell
from up to N replicas and ``--migrate`` moves cells off a host learned
slow. All decisions are derived cluster events, so recorded runs replay
byte for byte.

Energy governance (repro_torch.energy): ``--governor`` walks each
signature's DP Pareto frontier against the arrival forecast (it needs
``--forecast-horizon`` or ``--autoscale``); ``--power-cap-w W`` caps the
fleet's modeled draw and ``--energy-slo-j J`` filters the frontier. Those
watts and joules are the DyPe energy model's for the scheduled FPGA + GPU
system, not the card's: nothing here reads the card's power.

One CPU command for each (``--backend torch --device cpu`` prints what
``--backend analytic`` prints, but for the lines with "wall" and the
backend's name):

  --stream --duration 120 --day 120 --peak-rate 10 --trough-rate 0.5 \\
      --calibrate-wall 4 --backend torch --device cpu and then one of
    --cluster 2 --kill-worker 40 --record-cluster-events e.jsonl
    --cluster 2 --host-profiles w1=60 --steal
    --cluster 2 --replicate-hot 2 --forecast-horizon 5 --migrate
    --cluster 2 --peak-rate 24 --true-host-profiles w1=60 --learn-profiles \\
        --steal
    --cluster 2 --autoscale --forecast-horizon 5 --mode-cooldown 5
    --duration 60 --cluster 2 --governor --forecast-horizon 5 \\
        --power-cap-w 700 --energy-slo-j 30
    --duration 60 --cluster 2 --host-profiles w1=60 --steal \\
        --peak-rate 24 --trace-out s.jsonl --dashboard \\
        --dashboard-every 5 --dashboard-html d.html
  and for tenancy:
  --stream --trace-in examples/traces/azure_llm_excerpt.jsonl \\
      --tenants gold:0:1,bronze:2:3 --backend torch --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def parse_host_profiles(spec: str) -> dict:
    """``w1=4,w2=2:0.5`` -> {wid: HostProfile} (COMPUTE[:BW] per worker).
    Raises ValueError with the offending entry on malformed input (the
    CLI surfaces it as an argparse error at startup, not a traceback
    mid-stream)."""
    from ..core import HostProfile

    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        wid, eq, factors = part.partition("=")
        comp, _, bw = factors.partition(":")
        try:
            if not eq or not wid.strip():
                raise ValueError("missing wid= prefix")
            compute, bw_scale = float(comp), float(bw) if bw else 1.0
            if compute <= 0 or bw_scale <= 0:
                raise ValueError("factors must be > 0")
        except ValueError as e:
            raise ValueError(
                f"bad --host-profiles entry {part!r} "
                f"(want wid=COMPUTE[:BW], factors > 0): {e}") from e
        out[wid.strip()] = HostProfile(f"{wid.strip()}-x{comp}",
                                       compute_scale=compute,
                                       bw_scale=bw_scale)
    return out


def run_stream(args):
    """Serve a simulated traffic stream through the serving subsystem;
    returns ``(router, sim, snapshot, wall seconds)``."""
    from ..core import DynamicScheduler, PerfModel, paper_system
    from ..obs import (DashboardServer, FleetView, JsonlTraceSink, Tracer,
                       build_frame, dashboard_html, render_frame)
    from ..runtime import ProbationTracker, WallClockCalibrator, make_backend
    from ..serving import (LoadWatermarkPolicy, PoolEvent, Router,
                           SignatureBatcher, TrafficSim)

    system = paper_system(args.interconnect)
    perf = PerfModel()
    dyn = DynamicScheduler(system, perf, mode="perf")
    # the torch backend's device goes to every worker of a cluster too;
    # None is the card, which raises without one
    backend_kw = {"device": args.device} if args.backend == "torch" else {}
    cluster = None
    if args.cluster:
        from ..cluster import (ClusterEvent, ClusterEventLog, LocalCluster,
                               split_pool)
        script = []
        if args.replay_cluster_events:
            script = list(
                ClusterEventLog.from_jsonl(args.replay_cluster_events)
                .script())
        if args.kill_worker is not None:
            # split_pool drops empty sub-pools, so with more workers
            # requested than devices the fleet is smaller than N — target
            # the last worker that actually exists
            n_actual = len(split_pool(system, args.cluster))
            if n_actual < 2:
                raise SystemExit(
                    "--kill-worker would empty the fleet: total cluster "
                    "loss is fatal (no capacity to reschedule onto); use "
                    "--cluster 2 or more")
            script.append(ClusterEvent(args.kill_worker, "kill",
                                       f"w{n_actual - 1}"))
        cluster = LocalCluster(system, args.cluster, backend=args.backend,
                               backend_kw=backend_kw,
                               script=tuple(script),
                               profiles=args.host_profiles or None,
                               truth_profiles=(args.true_host_profiles
                                               or None),
                               steal=args.steal,
                               host_aware=not args.host_oblivious,
                               replicate_hot=args.replicate_hot,
                               migrate=args.migrate,
                               perf=perf)
        backend = cluster.backend()
    else:
        backend = make_backend(args.backend, **backend_kw)
    # fleet management (repro_torch.fleet): learned host profiles, arrival
    # forecasting, predictive autoscaling
    estimator = forecaster = autoscaler = None
    if args.learn_profiles:
        from ..fleet import OnlineHostEstimator
        estimator = OnlineHostEstimator()
    if args.forecast_horizon > 0 or args.autoscale:
        from ..fleet import ArrivalForecaster
        forecaster = ArrivalForecaster(
            horizon=args.forecast_horizon or 5.0)
    if args.autoscale:
        from ..fleet import PredictiveAutoscaler
        autoscaler = PredictiveAutoscaler(
            forecaster, up=args.high_watermark, down=args.low_watermark)
    # energy governance (repro_torch.energy): continuous Pareto operating
    # points + fleet power cap + per-request energy SLO
    governor = None
    if args.governor:
        from ..energy import ParetoGovernor, PowerBudget
        budget = (PowerBudget(args.power_cap_w)
                  if args.power_cap_w is not None else None)
        governor = ParetoGovernor(budget=budget,
                                  energy_slo_j=args.energy_slo_j)
    # observability: one Tracer fans spans out to the JSONL file and/or
    # the in-memory FleetView the dashboard reads; None = NULL_TRACER
    # (publish sites cost one attribute check)
    sinks = []
    fleet = None
    want_dash = bool(args.dashboard or args.dashboard_html
                     or args.dashboard_port is not None)
    if args.trace_out:
        sinks.append(JsonlTraceSink(args.trace_out))
    if want_dash:
        fleet = FleetView()
        sinks.append(fleet)
    tracer = Tracer(*sinks) if sinks else None
    # multi-tenant serving (repro_torch.tenancy): priority bands + WFQ +
    # preemption; untenanted runs keep the plain signature batcher
    tenant_manager = None
    tenant_specs = ()
    if args.tenants:
        from ..tenancy import build_tenancy, parse_tenants
        tenant_specs = parse_tenants(args.tenants)
        tenant_manager, batcher = build_tenancy(
            tenant_specs, preempt=not args.no_preempt,
            starve_after=args.starve_after,
            max_batch=args.max_batch, max_wait=args.max_wait)
    else:
        batcher = SignatureBatcher(max_batch=args.max_batch,
                                   max_wait=args.max_wait)
    router = Router(
        dyn,
        batcher=batcher,
        policy=LoadWatermarkPolicy(low=args.low_watermark,
                                   high=args.high_watermark,
                                   window=args.policy_window,
                                   forecaster=forecaster,
                                   cooldown=args.mode_cooldown),
        backend=backend,
        max_cells=args.max_cells,
        async_mode=not args.sync,
        probation=(ProbationTracker(clean_epochs=args.probation)
                   if args.probation else None),
        calibrator=(WallClockCalibrator(warmup=args.calibrate_wall,
                                        estimator=estimator)
                    if args.calibrate_wall else None),
        tracer=tracer,
        tenancy=tenant_manager)
    if cluster is not None:
        cluster.attach(router)
        if estimator is not None:
            estimator.attach(router, cluster.controller)
        if autoscaler is not None:
            autoscaler.attach(router, cluster.controller)
    if governor is not None:
        governor.attach(router,
                        cluster.controller if cluster is not None else None)
    frames: list = []
    server = None
    if want_dash:
        if args.dashboard_port is not None:
            server = DashboardServer(port=args.dashboard_port)
            print(f"[serve] dashboard live at {server.url}")
        last_frame = [-args.dashboard_every]

        def dash_hook(now):
            if now - last_frame[0] >= args.dashboard_every:
                last_frame[0] = now
                frame = build_frame(now, router, fleet)
                frames.append(frame)
                if args.dashboard:
                    print(render_frame(frame))
                if server is not None:
                    server.push(frame)
            return None

        router.clock_hooks.append(dash_hook)
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
                         snapshot_every=snap_every,
                         tenants=tenant_specs)
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
    if snap.steals:
        print(f"[serve] steals={snap.steals} batches migrated to dry "
              f"workers (recorded in the event log)")
    if snap.preemptions:
        print(f"[serve] preemptions={snap.preemptions} in-flight batches "
              f"drained and requeued ({snap.preempted_requests} requests, "
              f"zero dropped by preemption)")
    for name, row in snap.tenants.items():
        print(f"[serve] tenant {name}: completed={row['completed']} "
              f"dropped={row['dropped']} preempted={row['preempted']} "
              f"p99={row['p99_latency']*1e3:.1f}ms "
              f"miss={row['deadline_miss_rate']:.1%} "
              f"J/req={row['joules_per_req']:.2f}")
    if cluster is not None:
        print(f"[serve] cluster: {len(cluster.controller.links)} workers, "
              f"cross-worker overlap="
              f"{cluster.cross_worker_overlap():.3f}x")
        for line in cluster.controller.describe():
            print(f"[serve]   {line}")
        for ev in cluster.events:
            print(f"[serve]   event t={ev.t:.2f} {ev.kind} {ev.worker} "
                  f"{ev.detail}")
        if args.record_cluster_events:
            cluster.events.to_jsonl(args.record_cluster_events)
            print(f"[serve] cluster events -> {args.record_cluster_events}")
    if estimator is not None:
        for wid in sorted(estimator.published):
            prof = estimator.published[wid]
            print(f"[serve] learned profile {wid}: "
                  f"compute x{prof.compute_scale:g} bw x{prof.bw_scale:g}")
        if not estimator.published:
            print("[serve] learned profiles: none published "
                  "(fleet matches belief)")
        if estimator.gated:
            print(f"[serve] estimator gated {estimator.gated} mismatched "
                  f"reports away from the straggler monitors")
    if forecaster is not None:
        print(f"[serve] forecast: level={forecaster.level or 0.0:.2f}/s "
              f"trend={forecaster.trend:+.3f}/s^2 "
              f"horizon={forecaster.horizon:.0f}s")
    if autoscaler is not None:
        kinds = [a[1] for a in autoscaler.actions]
        print(f"[serve] autoscaler: {kinds.count('prewarm')} prewarms, "
              f"{kinds.count('park')} parks, "
              f"{kinds.count('unpark')} unparks "
              f"(util={autoscaler.last_util:.2f} at end)")
    if governor is not None:
        cap_txt = (f"{governor.last_cap:.1f}W"
                   if governor.last_cap is not None else "none")
        print(f"[serve] governor: watts_mean={snap.watts_mean:.1f}W "
              f"watts_p95={snap.watts_p95:.1f}W cap={cap_txt} "
              f"joules/req={snap.joules_per_req:.2f}J "
              f"opoint_switches={snap.opoint_switches}")
        if cluster is None:
            # local mode: the governor's own log holds the derived
            # opoint/power events (cluster mode prints them above)
            for ev in governor.events:
                if ev.kind == "opoint":
                    print(f"[serve]   event t={ev.t:.2f} opoint "
                          f"{ev.detail}")
    if cluster is not None and (args.replicate_hot or args.migrate):
        ev_kinds = [e.kind for e in cluster.events]
        reps = {h: w for h, w in cluster.controller._replicas.items()
                if len(w) > 1}
        print(f"[serve] replication: {ev_kinds.count('replicate')} "
              f"promotions, {ev_kinds.count('migrate')} migrations, "
              f"{ev_kinds.count('retire')} retires "
              f"({len(reps)} cells replicated at end)")
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
    if want_dash:
        final = build_frame(router.metrics.t_last, router, fleet)
        frames.append(final)
        if args.dashboard:
            print(render_frame(final))
        if server is not None:
            server.push(final)
    if tracer is not None:
        tracer.flush(router.metrics.t_last)
        if args.trace_out:
            print(f"[serve] trace spans -> {args.trace_out}")
    if args.dashboard_html:
        with open(args.dashboard_html, "w") as f:
            f.write(dashboard_html(frames))
        print(f"[serve] dashboard html -> {args.dashboard_html}")
    if server is not None:
        print(f"[serve] holding dashboard at {server.url} "
              f"(ctrl-c to exit)")
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
    return router, sim, snap, wall


@dataclasses.dataclass
class DecodeResult:
    cfg: object                 # the served ModelConfig
    params: dict
    prompt: object              # (B, prompt_len) int32 numpy
    tokens: object              # (B, gen) int32 numpy, the greedy tokens
    seconds: float              # host clock around the synchronised loop
    steps: int                  # decode steps run (prompt_len + gen - 1)

    @property
    def tok_per_s(self) -> float:
        return self.tokens.size / self.seconds

    @property
    def ms_per_step(self) -> float:
        return self.seconds * 1e3 / self.steps


def decode(cfg, params, prompt, gen: int, device=None):
    """Batched greedy decode: the prompt (B, P) is fed one token a step
    (teacher-forced), then ``gen`` tokens are generated greedily, each
    step one ``make_serve_step`` against caches of P + gen positions.
    The encdec family cross-attends to an encoder output of ones, as the
    reference's decode mode does. Returns ((B, gen) int32 numpy tokens,
    seconds of the loop)."""
    import numpy as np
    import torch

    from ..device import resolve_device, synchronize
    from ..models.lm import init_cache
    from .steps import make_serve_step

    dev = resolve_device(device)
    B, P = prompt.shape
    L = P + gen
    serve = make_serve_step(cfg, device=dev)
    prompt_t = torch.as_tensor(np.asarray(prompt, np.int32)).to(dev)
    outs = []
    with torch.inference_mode():
        cache = init_cache(cfg, B, L, device=dev)
        if cfg.family == "encdec":
            cache["enc_out"].fill_(1)
        tok = prompt_t[:, :1]
        synchronize(dev)
        t0 = time.perf_counter()
        for pos in range(L - 1):
            nxt, cache = serve(params, tok, pos, cache)
            if pos + 1 < P:
                tok = prompt_t[:, pos + 1:pos + 2]
            else:
                tok = nxt
                outs.append(nxt)
        synchronize(dev)
        dt = time.perf_counter() - t0
    return torch.cat(outs, dim=1).cpu().numpy(), dt


def run_decode(args) -> DecodeResult:
    """Batched greedy decode for one assigned architecture."""
    import numpy as np
    import torch

    from ..configs import get_config, get_smoke
    from ..device import resolve_device
    from ..models import init_params, model_decls

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    decls = model_decls(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(decls, gen, dev, cfg.pdtype)
    if args.int8:
        from ..models.quant import quantize_params
        params = quantize_params(params)
        print("[serve] int8 serving weights enabled")

    B = args.batch
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, args.prompt_len), dtype=np.int32)
    tokens, dt = decode(cfg, params, prompt, args.gen, device=dev)
    print(f"[serve] {B} seqs x {tokens.shape[1]} tokens in {dt:.1f}s "
          f"({B * tokens.shape[1] / dt:.1f} tok/s)")
    print("[serve] sample:", tokens[0][:16].tolist())
    return DecodeResult(cfg, params, prompt, tokens, dt,
                        args.prompt_len + args.gen - 1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stream", action="store_true",
                    help="streaming traffic mode (repro_torch.serving)")
    # decode-mode args
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--int8", action="store_true")
    # stream-mode args
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
                    help="device of the decode mode and of the torch "
                         "backend (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
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
    ap.add_argument("--tenants", metavar="SPEC",
                    help="multi-tenant priority classes as "
                         "name:priority[:share[:slo[:jcap]]] entries, "
                         "e.g. 'gold:0:1:2.5,bronze:2:3' (priority 0 = "
                         "highest; share = WFQ weight and arrival share; "
                         "slo = per-request deadline slack in s; jcap = "
                         "J/request accounting ceiling) — docs/tenancy.md")
    ap.add_argument("--no-preempt", action="store_true",
                    help="keep priority bands ordering-only: never drain "
                         "a lower-class in-flight batch for blocked "
                         "higher-priority work (requires --tenants)")
    ap.add_argument("--starve-after", type=float, default=4.0,
                    metavar="S",
                    help="starvation bound: promote a tenant group to "
                         "top-band dispatch ordering once its head has "
                         "waited S seconds (default 4; ordering only — "
                         "promoted groups gain no preemption rights)")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="serve through the multi-host control plane with "
                         "N in-process workers splitting the device pool")
    ap.add_argument("--kill-worker", type=float, metavar="T",
                    help="crash the last cluster worker at sim time T "
                         "(heartbeat-miss -> reschedule on survivors)")
    ap.add_argument("--probation", type=int, default=0, metavar="N",
                    help="re-admit straggler-demoted devices after N "
                         "clean epochs at reduced weight (0 = off)")
    ap.add_argument("--host-profiles", metavar="SPEC",
                    help="per-worker heterogeneity as wid=COMPUTE[:BW] "
                         "pairs, e.g. 'w1=4' (w1 is 4x slower) or "
                         "'w1=4:0.5,w2=2' (docs/heterogeneity.md)")
    ap.add_argument("--steal", action="store_true",
                    help="controller-side work stealing: migrate pending "
                         "batches from slow to dry-and-faster workers")
    ap.add_argument("--host-oblivious", action="store_true",
                    help="legacy device-count placement that ignores host "
                         "profiles (the hosts still run slow) — the "
                         "baseline the heterogeneity layer beats")
    ap.add_argument("--true-host-profiles", metavar="SPEC",
                    help="ground-truth host physics the control plane "
                         "cannot see (same wid=COMPUTE[:BW] syntax as "
                         "--host-profiles): the workers run at these "
                         "speeds while the controller still believes its "
                         "declared profiles — the undeclared-slow-host "
                         "scenario --learn-profiles discovers")
    ap.add_argument("--learn-profiles", action="store_true",
                    help="learn per-host profiles online from measured "
                         "vs expected stage times (OnlineHostEstimator) "
                         "and publish them into placement/DP/steal once "
                         "confident — no --host-profiles needed")
    ap.add_argument("--autoscale", action="store_true",
                    help="predictive autoscaling off the arrival "
                         "forecast: pre-warm hot signature cells before "
                         "peaks and park/unpark workers via the elastic "
                         "join/leave path")
    ap.add_argument("--replicate-hot", type=int, default=0, metavar="N",
                    help="serve the forecaster's hottest signature cell "
                         "from up to N replicas on distinct workers; "
                         "dispatch routes each batch to the replica with "
                         "the lowest estimated wait (needs a forecaster: "
                         "--forecast-horizon or --autoscale)")
    ap.add_argument("--migrate", action="store_true",
                    help="live-migrate cells off a host when its learned "
                         "profile shows it slow: drain to a replica on a "
                         "faster worker, then retire — replaces the "
                         "epoch-bump invalidation (zero dropped batches)")
    ap.add_argument("--forecast-horizon", type=float, default=0.0,
                    metavar="S",
                    help="drive the perf/energy policy from a Holt "
                         "arrival forecast S seconds ahead instead of "
                         "the trailing-window rate (0 = reactive; "
                         "--autoscale defaults this to 5)")
    ap.add_argument("--governor", action="store_true",
                    help="continuous Pareto operating-point governance "
                         "(repro_torch.energy): pin each signature to the "
                         "lowest-energy frontier point that clears its "
                         "forecast demand, instead of the binary "
                         "perf/energy watermark flip (needs a "
                         "forecaster: --forecast-horizon or --autoscale)")
    ap.add_argument("--power-cap-w", type=float, metavar="W",
                    help="fleet power budget in watts: the governor "
                         "force-downshifts the coldest cells while the "
                         "modeled draw exceeds the cap (requires "
                         "--governor)")
    ap.add_argument("--energy-slo-j", type=float, metavar="J",
                    help="energy SLO in joules per request: restrict "
                         "operating points to those at or under J "
                         "(requires --governor)")
    ap.add_argument("--mode-cooldown", type=float, default=0.0,
                    metavar="S",
                    help="minimum seconds between perf/energy mode "
                         "flips (bounds flapping; 0 = watermark "
                         "hysteresis only)")
    ap.add_argument("--calibrate-wall", type=int, default=0, metavar="N",
                    help="calibrate wall-clock measured stage times onto "
                         "the simulated clock over N reports so they can "
                         "drive straggler demotion (0 = telemetry only)")
    ap.add_argument("--record-cluster-events", metavar="JSONL",
                    help="write the cluster event log for later replay")
    ap.add_argument("--replay-cluster-events", metavar="JSONL",
                    help="replay the input events (kill/join/latency) of "
                         "a recorded cluster event log")
    ap.add_argument("--trace-out", metavar="JSONL",
                    help="stream request/control-plane spans to this "
                         "JSONL file (validate: obs.schema.validate)")
    ap.add_argument("--dashboard", action="store_true",
                    help="render a live terminal dashboard frame every "
                         "--dashboard-every sim seconds")
    ap.add_argument("--dashboard-every", type=float, default=5.0,
                    metavar="S", help="dashboard frame cadence in "
                                      "simulated seconds (default 5)")
    ap.add_argument("--dashboard-html", metavar="HTML",
                    help="write a single-file HTML dashboard replaying "
                         "every frame of this run")
    ap.add_argument("--dashboard-port", type=int, metavar="P",
                    help="serve the dashboard live over SSE on this port "
                         "(0 = ephemeral); holds the process after the "
                         "run until ctrl-c")
    ap.add_argument("--snapshot-every", type=float, default=0.0,
                    metavar="S",
                    help="append a cumulative MetricsSnapshot every S sim "
                         "seconds (0 = final snapshot only)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check the launcher's arguments, as ``main`` runs them:
    the host-profile specs come back parsed into ``{wid: HostProfile}``."""
    ap = parser()
    args = ap.parse_args(argv)
    if not args.stream and not args.arch:
        ap.error("--arch is required unless --stream is given")
    if args.no_preempt and not args.tenants:
        ap.error("--no-preempt requires --tenants")
    if args.replay_trace and args.trace_in:
        ap.error("--replay-trace and --trace-in are mutually exclusive "
                 "(both replay an arrival JSONL)")
    if args.tenants:
        try:
            from ..tenancy import parse_tenants
            parse_tenants(args.tenants)
        except ValueError as e:
            ap.error(str(e))
    if args.stream and args.device is not None and args.backend != "torch":
        ap.error("--device applies to the decode mode and --backend torch "
                 "only")
    if (args.kill_worker is not None or args.record_cluster_events
            or args.replay_cluster_events) and not args.cluster:
        ap.error("--kill-worker/--*-cluster-events require --cluster N")
    if (args.host_profiles or args.steal
            or args.host_oblivious) and not args.cluster:
        ap.error("--host-profiles/--steal/--host-oblivious require "
                 "--cluster N")
    if (args.true_host_profiles or args.learn_profiles
            or args.autoscale) and not args.cluster:
        ap.error("--true-host-profiles/--learn-profiles/--autoscale "
                 "require --cluster N")
    if (args.replicate_hot or args.migrate) and not args.cluster:
        ap.error("--replicate-hot/--migrate require --cluster N")
    if args.replicate_hot and not (args.forecast_horizon > 0
                                   or args.autoscale):
        ap.error("--replicate-hot needs an arrival forecaster: add "
                 "--forecast-horizon S or --autoscale")
    if args.governor and not (args.forecast_horizon > 0 or args.autoscale):
        ap.error("--governor needs an arrival forecaster: add "
                 "--forecast-horizon S or --autoscale")
    if ((args.power_cap_w is not None or args.energy_slo_j is not None)
            and not args.governor):
        ap.error("--power-cap-w/--energy-slo-j require --governor")
    if args.power_cap_w is not None and args.power_cap_w <= 0:
        ap.error("--power-cap-w must be > 0")
    try:
        # parse once at startup (malformed specs die as argparse errors,
        # not mid-stream tracebacks); run_stream consumes the dict
        args.host_profiles = (parse_host_profiles(args.host_profiles)
                              if args.host_profiles else {})
        args.true_host_profiles = (
            parse_host_profiles(args.true_host_profiles)
            if args.true_host_profiles else {})
    except ValueError as e:
        ap.error(str(e))
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.stream:
        run_stream(args)
    else:
        run_decode(args)


if __name__ == "__main__":
    main()
