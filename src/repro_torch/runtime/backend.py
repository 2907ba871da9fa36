"""ExecutionBackend — the seam between the DYPE schedule and what actually
runs it.

The DP scheduler produces a ``ScheduleResult``; *executing* it is a separate
concern with several legitimate substrates (HTS's point: the scheduler/
executor split must be a first-class interface so substrates plug in behind
one dispatch API). Every substrate implements three calls:

    prepare(schedule, workload) -> PipelineHandle
        Deploy the schedule: build whatever resident state execution needs
        (compiled pipeline, trace cursor, nothing at all) and stamp the
        scheduler epoch so stale handles are detectable.

    submit(handle, batch, t0) -> BackendFuture
        Non-blocking dispatch of a batch of ``len(batch)`` requests starting
        at simulated time ``t0``. The future's *simulated* completion times
        are available immediately (they come from the schedule model or a
        trace, never from the device), so callers can advance busy clocks
        and keep admitting/batching while the substrate executes;
        ``result()`` blocks until real work finishes and yields the full
        ``CompletionReport`` including measured wall/stage seconds.

    execute(handle, batch, t0) -> CompletionReport
        Blocking convenience: ``submit(...).result()``. The base class
        provides the inverse default (``submit`` wrapping a synchronous
        ``execute``), so a backend implements whichever is natural.

Three implementations ship:

  * ``AnalyticBackend`` — the GPipe fill+period arithmetic the Router used
    to inline: request i of a batch finishes at t0 + fill + i*period.
  * ``TorchPipelineBackend`` — runs the schedule's stages as a chain of
    proxy stage functions on one device (the card, or the CPU when the
    caller asks for it), or over the slots of a mesh, one stage group a
    slot, and actually computes the microbatches; the spmm stages
    multiply by a ring graph through the row-wise CSR SpMM kernel.
    Completion *times* still come from the schedule model so the
    simulated clock stays consistent, which is also what makes analytic
    vs torch completion ordering bit-identical (the parity tests).
  * ``ReplayBackend`` — deterministic timings from recorded traces
    (``TraceRecorder`` wraps any backend and captures them), for replaying
    production behavior in tests and what-if studies.

Behind any of them, ``ClusterBackend`` routes handles to the workers of
a ``repro_torch.cluster`` controller, each running its own local backend
(analytic or torch); entry points build it through ``cluster.LocalCluster``.

All simulated times are seconds; ``CompletionReport.wall`` carries real
elapsed wall-clock for backends that execute actual compute.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from ..core.scheduler import ScheduleResult
from ..core.workload import Workload
from ..device import resolve_device
from ..kernels.ops import CsrOperand
from ..launch.mesh import make_mesh
from .pipeline_exec import GroupedPipelineExecutor


class WorkerLost(Exception):
    """The peer executing a batch died before delivering its report. The
    Engine's reap converts this into a lost-batch delivery (report None)
    so the Router can re-queue the batch's requests — at-least-once
    semantics instead of stranded work."""


def pipeline_fill(res: ScheduleResult) -> float:
    """Latency of the first request through the pipeline (sum of stage
    in+exec+out times); subsequent requests stream at the period."""
    return sum(s.total for s in res.pipeline.stages)


def batch_size(batch) -> int:
    """Backends accept either a sized batch object or a bare int."""
    return batch if isinstance(batch, int) else len(batch)


@dataclasses.dataclass
class PipelineHandle:
    """A deployed schedule: everything a backend needs to run batches under
    it. ``epoch`` is the DynamicScheduler epoch at prepare time — a resize
    or objective flip bumps the scheduler's epoch, invalidating the handle
    (holders compare and re-prepare)."""
    schedule: ScheduleResult
    workload: Workload
    epoch: int = 0
    backend: str = ""
    payload: object = None         # backend-specific resident state

    def stale(self, current_epoch: int) -> bool:
        return self.epoch != current_epoch


@dataclasses.dataclass
class CompletionReport:
    """Per-batch execution outcome. All times are seconds.

    ``finishes[i]`` is the *simulated-clock* completion time of the batch's
    i-th request (batch order); ``stage_times`` are the schedule model's
    per-stage estimates for this batch. ``measured_stage_times`` are the
    per-stage seconds the substrate actually observed — this is what feeds
    the straggler monitors (measurements, not DP estimates).
    Backends without real compute synthesize them (analytic: the estimates
    themselves; replay: the recorded trace), so the feedback path is
    uniform across substrates. ``wall`` is real elapsed wall-clock.

    ``worker`` is the id of the host that *executed* the batch — stamped
    by ``WorkerCore`` on cluster runs ("" on single-host backends). With
    work stealing a batch may run on a different host than its cell's
    owner, so measured-time consumers (``WallClockCalibrator``) key on
    the executing worker, not the placement.

    ``stage_expected`` is the control plane's *belief* about this batch:
    per-stage ``(device name, exec seconds, transfer seconds)`` from the
    schedule the controller deployed to the executing worker (stamped by
    ``WorkerCore``; empty on single-host backends). Measured-vs-expected
    per stage is the signal ``repro.fleet.OnlineHostEstimator`` solves
    host scales from — carried in the report so a *stolen* batch's
    expectation is the thief's deployed schedule, not the owner's."""
    t0: float
    finishes: tuple
    energy_per_req: float
    stage_times: tuple             # schedule-model per-stage seconds
    wall: float = 0.0              # real wall-clock spent executing (s)
    measured_stage_times: tuple = ()   # observed per-stage seconds
    worker: str = ""               # executing host id (cluster runs)
    stage_expected: tuple = ()     # belief (dev, exec_s, xfer_s) per stage

    @property
    def finish(self) -> float:
        return max(self.finishes) if self.finishes else self.t0

    @property
    def measured(self) -> tuple:
        """Backend-measured per-stage seconds, falling back to the schedule
        estimates for reports that predate the measurement path."""
        return self.measured_stage_times or self.stage_times


class BackendFuture:
    """Handle to one in-flight batch dispatched via ``submit``.

    Two-phase by design: the *simulated* completion times (``t0``,
    ``finishes``, seconds on the shared simulated clock) are fixed at
    submission — every backend derives them from the schedule model or a
    recorded trace, never from the device — so the Engine can advance busy
    clocks and keep admitting without blocking. ``result()`` blocks until
    the substrate's real work completes and returns the full
    ``CompletionReport`` (measured wall/stage seconds filled in).

    Futures are single-threaded objects: ``result()`` is expected to be
    called from the same control loop that called ``submit`` (reap phase);
    there is no cross-thread signalling."""

    def __init__(self, t0: float, finishes: tuple, resolve):
        self.t0 = t0
        self.finishes = finishes
        self._resolve = resolve            # () -> CompletionReport
        self._report: CompletionReport | None = None

    @property
    def finish(self) -> float:
        """Simulated completion time of the batch's last request."""
        return max(self.finishes) if self.finishes else self.t0

    def done(self) -> bool:
        """True once ``result()`` has materialized the report."""
        return self._report is not None

    def ready(self) -> bool:
        """True when ``result()`` can deliver without waiting on an
        unresponsive peer. Local substrates are always ready (a torch
        ``result()`` blocks, but only on finite device work); the cluster
        future reports False until its worker answers or is declared
        lost — the Engine's reap defers not-ready batches to a later
        cycle instead of hanging the control loop on a dead host."""
        return True

    def result(self) -> CompletionReport:
        """Block until execution finishes; idempotent."""
        if self._report is None:
            self._report = self._resolve()
        return self._report

    @classmethod
    def resolved(cls, report: CompletionReport) -> "BackendFuture":
        """An already-completed future (the sync-execute adapter)."""
        fut = cls(report.t0, report.finishes, lambda: report)
        fut._report = report
        return fut


class ExecutionBackend:
    """Protocol base. Subclasses override ``prepare`` plus either
    ``execute`` (synchronous substrates — ``submit`` wraps it in a resolved
    future) or both ``submit``/``execute`` (substrates with genuinely
    asynchronous dispatch, e.g. the torch backend's device-async path).

    Threading model: backends are driven by one host control loop;
    ``submit`` and ``result`` are never called concurrently from different
    threads. All simulated times are seconds.

    ``measured_sim_clock`` declares which clock the backend's
    ``measured_stage_times`` live on. True (analytic, replay): simulated
    seconds, directly comparable to the schedule's stage estimates — safe
    to judge against a StragglerMonitor baselined on them. False (torch):
    real wall seconds, on a different scale from the model baselines *and*
    — on the async submit path — contaminated by whatever host work ran
    between submit and reap; consumers must not feed them RAW to model-
    baselined monitors (they remain useful as telemetry, and a
    ``WallClockCalibrator`` makes them monitor-grade)."""
    name = "abstract"
    measured_sim_clock = True

    def prepare(self, schedule: ScheduleResult, workload: Workload, *,
                epoch: int = 0) -> PipelineHandle:
        raise NotImplementedError

    def execute(self, handle: PipelineHandle, batch,
                t0: float) -> CompletionReport:
        raise NotImplementedError

    def submit(self, handle: PipelineHandle, batch,
               t0: float) -> BackendFuture:
        """Non-blocking dispatch; default adapter runs the synchronous
        ``execute`` eagerly and returns an already-resolved future."""
        return BackendFuture.resolved(self.execute(handle, batch, t0))


def _analytic_report(schedule: ScheduleResult, n: int, t0: float,
                     *, wall: float = 0.0) -> CompletionReport:
    stages = schedule.pipeline.stages
    fill = pipeline_fill(schedule)
    period = schedule.pipeline.period
    finishes = tuple(t0 + fill + i * period for i in range(n))
    est = tuple(s.total for s in stages)
    return CompletionReport(t0, finishes, schedule.energy, est, wall=wall,
                            measured_stage_times=est)


class AnalyticBackend(ExecutionBackend):
    """Closed-form pipeline model: no resident state, instant 'execution'.
    Measured stage times are synthesized as the schedule estimates (a
    healthy pipeline by construction — the straggler monitors see exactly
    their baselines)."""
    name = "analytic"

    def prepare(self, schedule, workload, *, epoch: int = 0) -> PipelineHandle:
        return PipelineHandle(schedule, workload, epoch=epoch,
                              backend=self.name)

    def execute(self, handle, batch, t0: float) -> CompletionReport:
        return _analytic_report(handle.schedule, batch_size(batch), t0)


# ---------------------------------------------------------------------------
# real execution: the stage chain on one device, or over a mesh
# ---------------------------------------------------------------------------
def ring_operand(act_batch: int, max_micro: int, *, device=None) -> CsrOperand:
    """The spmm proxy's graph: a ring over the ``act_batch`` rows of each
    microbatch, block-diagonal over ``max_micro`` microbatches. Row i holds
    one entry of 0.5 at column (i - 1) mod act_batch of its own block, so
    ``ring @ x`` is ``0.5 * roll(x, 1)`` along each microbatch's rows, and
    exactly so: one product by 0.5 per row, on the kernel and on the plain
    version alike."""
    rows = np.arange(act_batch * max_micro, dtype=np.int64)
    cols = rows - rows % act_batch + (rows - 1) % act_batch
    n = len(rows)
    return CsrOperand.from_numpy(np.arange(n + 1), cols,
                                 np.full(n, 0.5, np.float32), (n, n),
                                 device=device)


def ring_rows(ring: CsrOperand, n: int) -> CsrOperand:
    """The leading (n, n) block of ``ring_operand``'s graph: its first n
    rows reach only the first n columns when n is a multiple of the
    block, and each row holds one entry, so this is a view, not a copy."""
    return CsrOperand(ring.indptr[:n + 1], ring.indices[:n],
                      ring.values[:n], (n, n))


def proxy_stage(kinds, w: torch.Tensor, ring: CsrOperand,
                x: torch.Tensor) -> torch.Tensor:
    """One schedule stage's proxy of its kernel group on ``x`` of shape
    (..., act_batch, act_dim): spmm -> neighbor aggregation (a row shift
    through the SpMM kernel, one launch over every row of ``x``) + feature
    mix, win_attn -> windowed mix along the features + matmul, gemm ->
    matmul, each followed by tanh. ``ring`` must have at least as many
    rows as ``x``."""
    for kind in kinds:
        if kind == "spmm":
            flat = x.reshape(-1, x.shape[-1])
            x = (flat @ w + ring_rows(ring, flat.shape[0]) @ flat) \
                .reshape(x.shape)
        elif kind == "win_attn":
            # windowed mixing proxy along the feature axis
            x = x @ w + 0.5 * torch.roll(x, 1, dims=-1)
        else:                      # gemm
            x = x @ w
        x = torch.tanh(x)          # bounded through deep chains
    return x


@dataclasses.dataclass(frozen=True)
class StageChain:
    """A prepared payload: the schedule's stages as a chain of proxy stage
    functions over one (m, act_batch, act_dim) float32 activation.
    ``kinds[s]`` are stage s's kernel kinds, ``ws[s]`` its weight and
    ``ring`` the spmm proxy's graph, all on one device."""
    kinds: tuple
    ws: torch.Tensor               # (n_stages, act_dim, act_dim)
    ring: CsrOperand               # ring_operand(act_batch, max_micro)

    def stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        return proxy_stage(self.kinds[s], self.ws[s], self.ring, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for s in range(len(self.kinds)):
            x = self.stage(s, x)
        return x


def _mesh_stage(kinds, ring_shape):
    def fn(p, x):
        ring = CsrOperand(p["indptr"], p["indices"], p["values"], ring_shape)
        return proxy_stage(kinds, p["w"], ring, x)
    return fn


class TorchPipelineBackend(ExecutionBackend):
    """Runs batches through the schedule's stages on one device, or over
    the slots of a mesh.

    Each schedule stage becomes one stage function applying a proxy of its
    kernel group (spmm -> neighbor-aggregate + matmul, gemm -> matmul,
    win_attn -> windowed mix + matmul) on a shape-homogeneous
    (act_batch, act_dim) activation per microbatch. The spmm stage's
    neighbor aggregation multiplies by ``ring_operand``'s graph through
    ``kernels.spmm.spmm_csr_rows``: the hand-written kernel on the card,
    its plain version on the CPU. gemm is ``torch.matmul`` (float32, TF32
    off).

    ``mode``:
      * "chain" — run the stage chain in order on the one device
      * "mesh"  — one slot per DP stage slot, ``sum(group_sizes)`` of them:
        a ``GroupedPipelineExecutor`` with the DP's ``Stage.n`` as group
        sizes, each stage on its group head's card, the activation copied
        card to card; the slots are the first cards, or the first slots
        of ``mesh=`` (a ``launch.mesh.Mesh``, whose slots may repeat a
        device). Without ``mesh=``, ``prepare`` raises when fewer cards
        are visible than the schedule has slots
      * "auto"  — the reference's rule: "mesh" when the device is a card,
        the schedule has more than one stage and ``sum(group_sizes)``
        cards are visible, else "chain"

    ``device=None`` means the card and raises without one; the CPU runs
    only when the caller passes ``device="cpu"``.

    Measured stage times are real seconds (``measured_sim_clock`` is
    False): CUDA event intervals on the card, ``time.perf_counter`` around
    each stage on the CPU. They are NOT comparable to the schedule's
    simulated-seconds baselines, so raw they feed ServingMetrics telemetry
    only. With a ``WallClockCalibrator`` (``Router(calibrator=...)``) the
    Router rescales them per (cell, stage) onto the simulated clock and
    they drive straggler demotion too.
    """
    name = "torch"
    measured_sim_clock = False

    def __init__(self, *, act_batch: int = 8, act_dim: int = 16,
                 max_micro: int = 8, mode: str = "auto", device=None,
                 mesh=None):
        if mode not in ("auto", "chain", "mesh"):
            raise ValueError(f"mode {mode!r}: choose auto, chain or mesh")
        self.device = resolve_device(device)
        self.mesh = mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        self.act_batch = act_batch
        self.act_dim = act_dim
        self.max_micro = max_micro
        self.mode = mode
        # prepared payloads are pure functions of the stage-kind structure,
        # so cell evictions/readmissions don't rebuild them
        self._payload_cache: dict = {}

    def prepare(self, schedule, workload, *, epoch: int = 0) -> PipelineHandle:
        stages = schedule.pipeline.stages
        group_sizes = tuple(s.n for s in stages)   # the DP's device counts
        stage_kinds = tuple(tuple(workload[i].kind
                                  for i in range(s.i0, s.i1))
                            for s in stages)
        cache_key = (stage_kinds, group_sizes)
        payload = self._payload_cache.get(cache_key)
        if payload is None:
            # per-stage weight: scaled identity + deterministic off-diagonal
            # so stage order matters (parity/permutations are observable)
            eye = torch.eye(self.act_dim, dtype=torch.float32,
                            device=self.device)
            ws = torch.stack([
                (0.8 + 0.02 * s) * eye
                + 0.01 * torch.roll(eye, s + 1, dims=1)
                for s in range(len(stages))])
            n_dev = sum(group_sizes)
            use_mesh = self.mode == "mesh" or (
                self.mode == "auto" and self.device.type == "cuda"
                and len(stages) > 1 and torch.cuda.device_count() >= n_dev)
            if use_mesh:
                payload = self._mesh_payload(stage_kinds, group_sizes, ws)
            else:
                payload = StageChain(stage_kinds, ws, ring_operand(
                    self.act_batch, self.max_micro, device=self.device))
            self._payload_cache[cache_key] = payload
        return PipelineHandle(schedule, workload, epoch=epoch,
                              backend=self.name, payload=payload)

    def _mesh_payload(self, stage_kinds, group_sizes,
                      ws) -> GroupedPipelineExecutor:
        """A prepared mesh payload: the proxy stages over a
        ``GroupedPipelineExecutor`` whose group sizes are the DP's
        ``Stage.n``, on ``sum(group_sizes)`` slots (the first cards, or the
        first slots of the backend's ``mesh``), one (act_batch, act_dim)
        microbatch a round; each stage's weight and its ring graph
        (``ring_operand(act_batch, 1)``) live on its group head's
        device."""
        n_dev, n = sum(group_sizes), len(stage_kinds)
        slots = (None if self.mesh is None
                 else list(self.mesh.devices.flat))
        mesh = make_mesh((n_dev,), ("stage",), devices=slots)
        ring = ring_operand(self.act_batch, 1, device=self.device)
        params = {"w": ws, **{k: getattr(ring, k).expand(n, -1) for k in
                              ("indptr", "indices", "values")}}
        fns = [_mesh_stage(kinds, ring.shape) for kinds in stage_kinds]
        return GroupedPipelineExecutor(
            fns, params, (self.act_batch, self.act_dim), group_sizes,
            mesh=mesh, axis="stage")

    def _micro(self, n_micro: int) -> torch.Tensor:
        """Deterministic microbatch content (replayable, seedless)."""
        m = max(1, min(n_micro, self.max_micro))
        return torch.from_numpy(
            np.linspace(-1.0, 1.0,
                        m * self.act_batch * self.act_dim,
                        dtype=np.float32)
            .reshape(m, self.act_batch, self.act_dim)).to(self.device)

    def submit(self, handle, batch, t0: float) -> BackendFuture:
        """Enqueue the batch's stages on the device WITHOUT blocking (CUDA
        launches are asynchronous) and return a future. Completion *times*
        still come from the schedule model — the simulated clock is shared
        with every other backend (and with admission control), which is
        exactly what makes analytic/torch ordering parity hold — so they
        are available immediately; ``result()`` waits for the device and
        fills in the measured wall/stage seconds.

        On the card a CUDA event is recorded before stage 0 and after each
        stage on the current stream; stage s's measured time is the
        interval between its two events, which holds device time only (the
        host time between submit and reap is not in it). On the CPU the
        stages run as they are enqueued, each timed by ``perf_counter``.
        In mesh mode the stages overlap across the rounds, so, as the
        reference does, the measured wall is shared over the stages by the
        schedule's stage weights: the total is measured, the split is
        modeled. ``wall`` is ``perf_counter`` from just before the first
        stage is enqueued to the moment the last one is known done."""
        n = batch_size(batch)
        base = _analytic_report(handle.schedule, n, t0)
        chain = handle.payload
        micro = self._micro(n)             # host-side input build: not timed
        w0 = time.perf_counter()
        x = micro
        if isinstance(chain, GroupedPipelineExecutor):
            dev = chain.device
            chain(micro.to(dev))           # async on the card
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))

            def resolve():
                if done is not None:
                    done.synchronize()
                wall = time.perf_counter() - w0
                est = base.stage_times
                tot = sum(est) or 1.0
                return dataclasses.replace(
                    base, wall=wall,
                    measured_stage_times=tuple(wall * e / tot for e in est))
        elif self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            marks = [torch.cuda.Event(enable_timing=True)]
            marks[0].record(stream)
            for s in range(len(chain.kinds)):    # async per-stage dispatch
                x = chain.stage(s, x)
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record(stream)

            def resolve():
                marks[-1].synchronize()
                wall = time.perf_counter() - w0
                meas = tuple(a.elapsed_time(b) / 1e3
                             for a, b in zip(marks, marks[1:]))
                return dataclasses.replace(base, wall=wall,
                                           measured_stage_times=meas)
        else:
            meas, prev = [], w0
            for s in range(len(chain.kinds)):
                x = chain.stage(s, x)
                now = time.perf_counter()
                meas.append(now - prev)
                prev = now

            def resolve():
                return dataclasses.replace(
                    base, wall=time.perf_counter() - w0,
                    measured_stage_times=tuple(meas))
        return BackendFuture(t0, base.finishes, resolve)

    def execute(self, handle, batch, t0: float) -> CompletionReport:
        return self.submit(handle, batch, t0).result()


# ---------------------------------------------------------------------------
# trace capture + replay
# ---------------------------------------------------------------------------
def _trace_key(schedule: ScheduleResult) -> str:
    """Identity of a schedule for trace purposes. The mnemonic alone is NOT
    enough — two schedules can share one (e.g. "1G1G") with very different
    stage baselines — so the key also pins the kernel spans and the period."""
    spans = ",".join(f"{s.i0}-{s.i1}x{s.n}{s.dev.name[0]}"
                     for s in schedule.pipeline.stages)
    return (f"{schedule.mnemonic}|{schedule.mode}|{spans}"
            f"|{schedule.pipeline.period:.9e}")


class TraceRecorder(ExecutionBackend):
    """Wraps any backend; records per-schedule timing traces suitable for
    ``ReplayBackend``. One trace per distinct (mnemonic, mode, n_stages).
    ``stage_times`` in the trace are the inner backend's *measured*
    per-stage seconds (``CompletionReport.measured``) when those live on
    the simulated clock, so replaying reproduces the observed stage
    behavior — including any straggling stage — not the DP estimates.
    For a wall-clock inner backend (torch) the schedule-model stage times
    are recorded instead: its measurements are on the wrong scale for a
    trace whose fill/period are simulated seconds, and the first report
    per schedule includes the kernels' first-use build — replaying either would inject
    phantom stragglers."""

    def __init__(self, inner: ExecutionBackend):
        self.inner = inner
        self.name = f"record({inner.name})"
        self.traces: dict[str, dict] = {}

    @property
    def measured_sim_clock(self) -> bool:
        return self.inner.measured_sim_clock

    def prepare(self, schedule, workload, *, epoch: int = 0) -> PipelineHandle:
        return self.inner.prepare(schedule, workload, epoch=epoch)

    def _record(self, handle, rep: CompletionReport) -> CompletionReport:
        key = _trace_key(handle.schedule)
        if key not in self.traces:
            period = (rep.finishes[1] - rep.finishes[0]
                      if len(rep.finishes) > 1
                      else handle.schedule.pipeline.period)
            self.traces[key] = {
                "fill": rep.finishes[0] - rep.t0 if rep.finishes else 0.0,
                "period": period,
                "energy": rep.energy_per_req,
                "stage_times": list(rep.measured if self.measured_sim_clock
                                    else rep.stage_times),
            }
        return rep

    def submit(self, handle, batch, t0: float) -> BackendFuture:
        fut = self.inner.submit(handle, batch, t0)
        return BackendFuture(fut.t0, fut.finishes,
                             lambda: self._record(handle, fut.result()))

    def execute(self, handle, batch, t0: float) -> CompletionReport:
        return self.submit(handle, batch, t0).result()

    def to_replay(self) -> "ReplayBackend":
        return ReplayBackend(dict(self.traces))

    def to_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for key, tr in sorted(self.traces.items()):
                f.write(json.dumps({"key": key, **tr}) + "\n")


class ReplayBackend(ExecutionBackend):
    """Deterministic execution timings from recorded traces: each schedule's
    fill/period/energy/stage-times come from the trace instead of the model.
    Trace ``stage_times`` are replayed as the report's *measured* per-stage
    seconds, so a trace recorded on straggling hardware (or edited to
    inject a slow stage) drives the straggler monitors exactly like a live
    measurement. Missing schedules fall back to the analytic model when
    ``strict`` is False (default), else raise KeyError."""
    name = "replay"

    def __init__(self, traces: dict, *, strict: bool = False):
        self.traces = traces
        self.strict = strict

    @classmethod
    def from_jsonl(cls, path, *, strict: bool = False) -> "ReplayBackend":
        traces = {}
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                traces[rec.pop("key")] = rec
        return cls(traces, strict=strict)

    def prepare(self, schedule, workload, *, epoch: int = 0) -> PipelineHandle:
        return PipelineHandle(schedule, workload, epoch=epoch,
                              backend=self.name,
                              payload=self.traces.get(_trace_key(schedule)))

    def execute(self, handle, batch, t0: float) -> CompletionReport:
        n = batch_size(batch)
        tr = handle.payload
        if tr is None:
            if self.strict:
                raise KeyError(f"no trace for {_trace_key(handle.schedule)}")
            return _analytic_report(handle.schedule, n, t0)
        finishes = tuple(t0 + tr["fill"] + i * tr["period"] for i in range(n))
        recorded = tuple(tr["stage_times"])
        return CompletionReport(t0, finishes, tr["energy"], recorded,
                                measured_stage_times=recorded)


# ---------------------------------------------------------------------------
# multi-host execution: route handles to cluster workers
# ---------------------------------------------------------------------------
class _ClusterFuture(BackendFuture):
    """Future for a batch executing on a remote worker. ``ready`` gates
    the Engine's reap: False while the submission is unanswered and its
    worker not yet declared lost — the failure detector (heartbeat
    timeout, or an RPC fallback on the blocking path) decides its fate,
    never a hang in the reap loop."""

    def __init__(self, controller, sid: int, t0: float, finishes: tuple):
        super().__init__(t0, finishes, lambda: controller.resolve(sid))
        self._controller = controller
        self._sid = sid

    def ready(self) -> bool:
        return self.done() or self._controller.ready(self._sid, self.finish)


class ClusterBackend(ExecutionBackend):
    """Executes every batch on a ``repro_torch.cluster`` worker peer.

    ``prepare`` asks the controller to *place* the cell — pick an owning
    worker (sub-pool-fit first, then deterministic round-robin) — and the
    worker prepares its local backend's handle; the returned
    ``PipelineHandle.payload`` is just ``(worker_id, remote_handle_id)``.
    ``submit`` routes the batch to that worker and returns a future whose
    simulated finishes come from the worker's report (the same schedule
    model every backend uses, which is what makes cluster-vs-local
    completion ordering identical). A worker death surfaces as
    ``WorkerLost`` at resolution — see ``cluster/controller.py`` for the
    detection story.

    Not in ``BACKENDS``: it needs a live controller, so entry points build
    it via ``cluster.LocalCluster`` rather than ``make_backend``."""
    name = "cluster"

    def __init__(self, controller):
        self.controller = controller

    @property
    def measured_sim_clock(self) -> bool:
        return self.controller.measured_sim_clock

    def prepare(self, schedule, workload, *, epoch: int = 0) -> PipelineHandle:
        # the controller may deploy a *host-adjusted* schedule (the owning
        # worker's physics, possibly a different stage split) — the handle
        # carries that one, so the Engine's busy clocks and straggler
        # baselines see the same truth the worker will report against
        wid, hid, deployed = self.controller.prepare(schedule, workload,
                                                     epoch)
        return PipelineHandle(deployed, workload, epoch=epoch,
                              backend=self.name, payload=(wid, hid))

    def submit(self, handle, batch, t0: float) -> BackendFuture:
        wid, hid = handle.payload
        sid, finishes = self.controller.submit(wid, hid, handle.schedule,
                                               batch_size(batch), t0)
        fut = _ClusterFuture(self.controller, sid, t0, finishes)
        # the *executing* host — replica routing and stealing both
        # already applied; the Engine advances that replica's clock
        fut.worker = self.controller.worker_of(sid)
        return fut

    @property
    def handles_migration(self) -> bool:
        """True when a learned-profile publication is absorbed by live
        migration (drain-to-replica -> retire) — the Router then skips
        the engine-wide invalidation it would otherwise perform."""
        return bool(getattr(self.controller, "migrate", False))

    def cancel(self, future, now: float) -> bool:
        """Preemption hook (``Engine.preempt``): withdraw an in-flight
        submission from its worker before it reports. Refused (False)
        once the report already arrived or the worker died — the caller
        must then leave the batch alone and reap it normally."""
        if future.done():
            return False
        return self.controller.cancel(future._sid, now)

    def est_wait_bound(self, handle, now: float, est: float) -> float:
        """Steal-aware admission bound (Engine.est_wait hook): the wait
        behind this cell's busy owner collapses to zero when the
        controller would migrate the next pending batch to a dry,
        strictly-faster peer — judged on the *current* (declared or
        learned) host profiles."""
        wid, hid = handle.payload
        return self.controller.steal_wait_bound(wid, hid, now, est)

    def execute(self, handle, batch, t0: float) -> CompletionReport:
        return self.submit(handle, batch, t0).result()


BACKENDS = {
    "analytic": AnalyticBackend,
    "torch": TorchPipelineBackend,
}


def make_backend(name: str, **kw) -> ExecutionBackend:
    """Factory for CLI entry points (``--backend analytic|torch``)."""
    try:
        return BACKENDS[name](**kw)
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; choose from {sorted(BACKENDS)}")
