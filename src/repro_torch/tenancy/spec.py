"""Tenant specifications: the per-class contract a multi-tenant serving
deployment enforces.

A ``TenantSpec`` names one request class and carries everything the stack
needs to treat it differently from its neighbors:

  * ``priority`` — the preemption/admission band (0 = highest). Bands are
    strict for *dispatch ordering and preemption rights*; within a band,
    weighted fair queueing by ``share`` decides who goes next.
  * ``share`` — the tenant's weighted-fair-queueing weight (and, in the
    traffic simulator, its share of the arrival stream). A share-4 tenant
    gets ~4x the service of a share-1 tenant in the same band.
  * ``slo`` — per-request deadline slack in simulated seconds: a request
    arriving at ``t`` must finish by ``t + slo``. None = best effort (the
    stream's default deadline slack, if any, still applies).
  * ``energy_cap`` — optional J/request ceiling; accounted per tenant in
    the metrics so an energy-SLO governor (repro_torch.energy) can gate
    on it.

Specs are frozen value objects so they can ride inside frozen ``Scenario``
configs and hash into replay-deterministic keys.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    name: str
    priority: int = 0              # 0 = highest band; larger = lower class
    share: float = 1.0             # WFQ weight within the band
    slo: float | None = None       # deadline slack (s) per request
    energy_cap: float | None = None  # J/request ceiling (accounting)


#: The implicit class of untenanted requests (``Request.tenant == ""``):
#: top band, unit share — single-tenant streams behave exactly as before.
DEFAULT_TENANT = TenantSpec("")


def parse_tenants(spec: str) -> tuple[TenantSpec, ...]:
    """Parse the ``--tenants`` CLI syntax: comma-separated
    ``name:priority[:share[:slo[:jcap]]]`` entries, e.g.

        gold:0:1:2.5,bronze:2:4

    declares a top-band 'gold' tenant (share 1, 2.5 s deadline slack) and
    a band-2 'bronze' tenant with 4x the arrival/service share. Empty
    trailing fields fall back to the ``TenantSpec`` defaults."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2 or not parts[0]:
            raise ValueError(
                f"bad tenant entry {entry!r}: want name:priority[:share"
                f"[:slo[:jcap]]]")
        name = parts[0]
        prio = int(parts[1])
        share = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
        slo = float(parts[3]) if len(parts) > 3 and parts[3] else None
        cap = float(parts[4]) if len(parts) > 4 and parts[4] else None
        out.append(TenantSpec(name, prio, share, slo, cap))
    if not out:
        raise ValueError(f"no tenants in spec {spec!r}")
    names = [t.name for t in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in {spec!r}")
    return tuple(out)
