"""Span-based tracing: one ``TraceSink`` seam for the whole serving stack.

Every request carries a trace id (``"r<rid>"``) from arrival to reap;
Router, Engine, Controller, and WorkerCore all publish through one
``Tracer`` so a single JSONL file (or an in-memory ``FleetView``) sees the
full causal story: arrival -> admit -> batch -> solve -> submit ->
[steal] -> reap, plus the control-plane side (heartbeats, deploys,
worker loss) on ``"w:<wid>"`` traces and router/engine housekeeping on
the ``"router"`` / ``"engine"`` traces.

Span record (one JSON object per line in a ``JsonlTraceSink``):

    {"trace": "r17", "span": 42, "parent": 3, "name": "submit",
     "t0": <sim s>, "t1": <sim s>, "w0": <wall s>, "w1": <wall s>, ...attrs}

``t0``/``t1`` are **simulated-clock** seconds (the serving stack's shared
clock — what causal ordering is checked on); ``w0``/``w1`` are real
``time.perf_counter`` seconds (what overhead is measured on). A span with
``t0 == t1`` is an instant event. Root spans (``parent: null``, one per
trace) are emitted at close time, so children precede their parent in
file order — consumers resolve parents over the whole file
(``repro.obs.schema`` validates exactly that).

Determinism contract: spans are **derived outputs, never inputs** — no
control-flow decision anywhere reads tracer state, so a cluster run with
tracing enabled replays its event log byte-identically (asserted by
tests). Cost contract: every publish site guards on ``Tracer.enabled``,
so the disabled tracer (``NULL_TRACER``) costs one attribute check per
site and allocates nothing.
"""
from __future__ import annotations

import json
import time


class TraceSink:
    """Consumer protocol: ``emit`` receives each span record (a plain
    dict, already timestamped); ``close`` flushes whatever the sink
    buffers. Sinks must not mutate the record (it is shared across
    sinks)."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(TraceSink):
    """Keeps every span record in ``records`` — tests and overhead
    benchmarks (tracing cost without disk noise)."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


class JsonlTraceSink(TraceSink):
    """Streams span records to a JSONL file (``--trace-out``). The file
    handle's buffering amortizes the writes; ``close`` flushes and
    releases it."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "w")

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class Tracer:
    """The event bus. One root span per trace (opened at the trace's
    birth, emitted at close), any number of child/instant spans parented
    to it. All methods early-return when disabled, so instrumented code
    paths pay ~nothing without a sink.

    Times: callers pass simulated-clock seconds; the tracer stamps wall
    clock (``perf_counter``) itself at call time — an instant span's
    ``w0 == w1``, a root's wall span covers open..close."""

    def __init__(self, *sinks: TraceSink, enabled: bool | None = None):
        self.sinks = list(sinks)
        self.enabled = bool(sinks) if enabled is None else enabled
        self._next_span = 0
        # trace id -> (span id, name, t0 sim, w0 wall) of the open root
        self._open: dict[str, tuple] = {}

    # -- span emission --------------------------------------------------------
    def _emit(self, trace: str, span: int, parent: int | None, name: str,
              t0: float, t1: float, w0: float, w1: float,
              attrs: dict) -> None:
        rec = {"trace": trace, "span": span, "parent": parent, "name": name,
               "t0": round(t0, 9), "t1": round(t1, 9),
               "w0": w0, "w1": w1}
        rec.update(attrs)
        for s in self.sinks:
            s.emit(rec)

    def open_root(self, trace: str, name: str, t0: float) -> int | None:
        """Start a trace's root span (idempotent per trace); the record
        itself is emitted by ``close_root`` once the outcome is known."""
        if not self.enabled:
            return None
        got = self._open.get(trace)
        if got is not None:
            return got[0]
        sid = self._next_span
        self._next_span += 1
        self._open[trace] = (sid, name, t0, time.perf_counter())
        return sid

    def close_root(self, trace: str, t1: float, **attrs) -> None:
        """Emit the trace's root span with its final sim time and
        outcome attrs (``status=...``). No-op for unknown traces."""
        if not self.enabled:
            return
        got = self._open.pop(trace, None)
        if got is None:
            return
        sid, name, t0, w0 = got
        self._emit(trace, sid, None, name, t0, t1, w0,
                   time.perf_counter(), attrs)

    def child(self, trace: str, name: str, t0: float, t1: float,
              **attrs) -> None:
        """Emit a completed child span parented to the trace's open root
        (parent ``null`` for rootless traces like ``"router"``)."""
        if not self.enabled:
            return
        got = self._open.get(trace)
        parent = got[0] if got is not None else None
        sid = self._next_span
        self._next_span += 1
        w = time.perf_counter()
        self._emit(trace, sid, parent, name, t0, t1, w, w, attrs)

    def instant(self, trace: str, name: str, t: float, **attrs) -> None:
        """A zero-duration event on the trace (``t0 == t1``)."""
        self.child(trace, name, t, t, **attrs)

    # -- lifecycle ------------------------------------------------------------
    def flush(self, t_end: float | None = None) -> None:
        """Close any still-open roots as ``status="unfinished"`` (their
        request never reached a terminal state before the stream ended)
        and close every sink. Idempotent."""
        if self.enabled:
            for trace in sorted(self._open):
                sid, name, t0, w0 = self._open[trace]
                self._emit(trace, sid, None, name, t0,
                           t_end if t_end is not None else t0, w0,
                           time.perf_counter(), {"status": "unfinished"})
            self._open.clear()
        for s in self.sinks:
            s.close()


#: Shared disabled tracer: the default everywhere tracing is optional.
#: Publish sites guard on ``tracer.enabled``, so this costs one attribute
#: read per site and emits nothing.
NULL_TRACER = Tracer()
