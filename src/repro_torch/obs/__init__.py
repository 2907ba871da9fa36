"""repro_torch.obs — observability for the serving stack (the port's copy
of ``repro/obs``).

One seam, three consumers:

    Router / Engine / Controller / WorkerCore
        │  (publish spans through one Tracer; every request carries a
        │   trace id "r<rid>" from arrival to reap, workers "w:<wid>")
        ▼
      Tracer ──> JsonlTraceSink   (--trace-out: schema-validated JSONL;
        │                          ``schema.validate`` checks it)
        ├─────> FleetView         (ring-buffer scheduler self-metrics:
        │                          occupancy, steals, demotions, DP
        │                          cache hits, placement latency)
        └─────> MemorySink        (tests; overhead benchmarking)

    FleetView + Router ──> build_frame ──> render_frame (--dashboard)
                                       ├─> dashboard_html (HTML artifact)
                                       └─> DashboardServer (live SSE)

Spans are **derived, never inputs**: nothing in the control path reads
tracer state, so record/replay determinism is untouched. The disabled
``NULL_TRACER`` costs one attribute check per publish site. On the torch
backend the heartbeats' ``stage_s`` are real seconds on the device, so
the FleetView's occupancy of a torch worker is measured, not simulated.
"""
from .trace import (JsonlTraceSink, MemorySink, NULL_TRACER, Tracer,
                    TraceSink)
from .schema import REQUEST_CHAIN, REQUIRED_KEYS, read_jsonl, validate
from .fleet import FleetView
from .dashboard import (DashboardServer, build_frame, dashboard_html,
                        render_frame)

__all__ = [
    "JsonlTraceSink", "MemorySink", "NULL_TRACER", "Tracer", "TraceSink",
    "REQUEST_CHAIN", "REQUIRED_KEYS", "read_jsonl", "validate",
    "FleetView",
    "DashboardServer", "build_frame", "dashboard_html", "render_frame",
]
