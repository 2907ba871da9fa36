"""repro_torch.obs — span tracing for the serving stack (the port's copy of
``repro/obs/trace.py``; the fleet view, schema checks and dashboard are
not ported yet).

Router and Engine publish spans through one ``Tracer``; every request
carries a trace id ``"r<rid>"`` from arrival to reap. Spans are derived,
never inputs, and the disabled ``NULL_TRACER`` costs one attribute check
per publish site.
"""
from .trace import (JsonlTraceSink, MemorySink, NULL_TRACER, Tracer,
                    TraceSink)

__all__ = ["JsonlTraceSink", "MemorySink", "NULL_TRACER", "Tracer",
           "TraceSink"]
