"""repro_torch.tenancy — multi-tenant serving (the port's copy of
``repro/tenancy``): priority classes, WFQ, and preemption.

See docs/tenancy.md for the tenant spec -> admission -> preemption
walkthrough. The pieces:

  * :class:`TenantSpec` / :func:`parse_tenants` — the per-class contract
    (priority band, rate share, deadline SLO, J/req ceiling).
  * :class:`TenantManager` — shared WFQ virtual-time + preemption policy
    state (strict bands, starvation-bound promotion).
  * :class:`TenantBatcher` — tenant-pure batches ordered by
    (band, vtime, arrival); exposes the ``blocked_pressure`` preemption
    trigger the Router polls.
"""
from .batcher import TenantBatcher
from .spec import DEFAULT_TENANT, TenantSpec, parse_tenants
from .wfq import TenantManager


def build_tenancy(specs, *, preempt: bool = True, starve_after: float = 4.0,
                  max_batch: int = 16, max_wait: float = 0.25):
    """Wire a (manager, batcher) pair for ``Router(tenancy=manager,
    batcher=batcher)``. The two must share one manager so batch formation
    charges the same WFQ clocks preemption decisions read."""
    manager = TenantManager(tuple(specs), preempt=preempt,
                            starve_after=starve_after)
    batcher = TenantBatcher(manager, max_batch=max_batch, max_wait=max_wait)
    return manager, batcher


__all__ = [
    "DEFAULT_TENANT",
    "TenantSpec",
    "TenantManager",
    "TenantBatcher",
    "build_tenancy",
    "parse_tenants",
]
