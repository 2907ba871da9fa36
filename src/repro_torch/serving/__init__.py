"""repro_torch.serving — signature-aware streaming request router (the
port's copy of ``repro/serving``).

Turns the per-request ``DynamicScheduler`` into a streaming server:

    TrafficSim ──> RequestQueue ──> SignatureBatcher ──> Router ──> Engine
                   (admission)      (continuous batches   │          │
                                    per signature cell)   │     ExecutionBackend
                                                          │     (analytic |
                                                          │      torch |
                                                          │      replay)
                                              DynamicScheduler / policy /
                                              metrics / straggler monitors

Requests are grouped by quantized characteristic signature so every batch
runs under one cached DP schedule; the DP re-runs only on data drift,
device-pool resize, or a perf/energy objective flip from the load
watermarks (the paper's peak/off-peak example, §II). The Engine keeps hot
signature cells resident on disjoint device subsets (one PipelineHandle
each) and dispatches every batch through the ExecutionBackend protocol —
see ``runtime/backend.py``.
"""
from .request import AdmissionStats, Request, RequestQueue
from .batcher import Batch, SignatureBatcher
from .policy import LoadWatermarkPolicy
from .metrics import (MetricsSnapshot, ServingMetrics, percentile,
                      union_coverage)
from .engine import Cell, Engine, InFlight
from .router import DispatchRecord, Router, pipeline_fill
from .traffic import (Arrival, Burst, MixItem, PoolEvent, TimelinePoint,
                      TrafficSim, default_mix, named_workload)

__all__ = [
    "AdmissionStats", "Request", "RequestQueue",
    "Batch", "SignatureBatcher",
    "LoadWatermarkPolicy",
    "MetricsSnapshot", "ServingMetrics", "percentile", "union_coverage",
    "Cell", "Engine", "InFlight",
    "DispatchRecord", "Router", "pipeline_fill",
    "Arrival", "Burst", "MixItem", "PoolEvent", "TimelinePoint",
    "TrafficSim", "default_mix", "named_workload",
]
