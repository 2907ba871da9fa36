"""Signature-aware continuous batching.

The DP scheduler is cheap but not free (tens of ms for deep workloads);
re-running it per request would dominate serving time. Two requests whose
quantized characteristic signatures (``core.dynamic.signature``) match are
*by construction* served optimally by the same schedule — so the batcher
groups the queue by signature and emits batches that run back-to-back under
one cached schedule. Within a batch the pipeline streams requests at its
initiation interval (one period per request after the fill), which is the
continuous-batching win: period-bound steady state instead of
latency-bound request-at-a-time execution.

Dispatch policy (oldest-first fairness): each cycle picks the group whose
head request has waited longest, then fills the batch with up to
``max_batch`` signature-mates. A group also dispatches early when its head
exceeds ``max_wait`` even if underfull, bounding tail latency at low load.
"""
from __future__ import annotations

import dataclasses

from ..core.dynamic import signature
from .request import Request, RequestQueue


@dataclasses.dataclass
class Batch:
    sig: tuple                      # workload signature shared by members
    requests: list[Request]

    def __len__(self):
        return len(self.requests)

    @property
    def wl(self):
        """Representative workload (any member — same signature cell)."""
        return self.requests[0].wl


class SignatureBatcher:
    def __init__(self, max_batch: int = 16, max_wait: float = 0.25):
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._sig_cache: dict[int, tuple] = {}   # rid -> signature

    def _sig(self, req: Request) -> tuple:
        s = self._sig_cache.get(req.rid)
        if s is None:
            s = signature(req.wl)
            self._sig_cache[req.rid] = s
        return s

    def groups(self, queue: RequestQueue) -> dict[tuple, list[Request]]:
        by_sig: dict[tuple, list[Request]] = {}
        for r in queue:
            by_sig.setdefault(self._sig(r), []).append(r)
        return by_sig

    def next_batch(self, queue: RequestQueue, now: float,
                   ready=None) -> Batch | None:
        """Form one batch: the group with the oldest head, filled up to
        ``max_batch``. Returns None when the queue is empty or every group
        is underfull and younger than ``max_wait``.

        ``ready(sig, group) -> bool`` (optional) filters groups by executor
        availability — the Engine passes it so a group whose signature cell
        is busy is skipped in favor of the next-oldest dispatchable one
        (per-cell work conservation). Without ``ready`` only the single
        oldest group is considered, preserving strict oldest-first order."""
        by_sig = self.groups(queue)
        if not by_sig:
            return None
        for sig, grp in sorted(by_sig.items(),
                               key=lambda kv: kv[1][0].arrival):
            full = len(grp) >= self.max_batch
            aged = now - grp[0].arrival >= self.max_wait
            if not (full or aged):
                if ready is None:
                    return None
                continue
            if ready is not None and not ready(sig, grp):
                continue
            picked = grp[:self.max_batch]
            queue.take(picked)
            self.forget(picked)
            return Batch(sig, picked)
        return None

    def forget(self, reqs) -> None:
        """Evict signature-cache entries for requests leaving the queue
        (dispatched OR expired) — the cache must not outlive the backlog."""
        for r in reqs:
            self._sig_cache.pop(r.rid, None)

    def drain(self, queue: RequestQueue, now: float) -> list[Batch]:
        """All dispatchable batches this cycle (used when the executor is
        free and we want work conservation)."""
        out = []
        while True:
            b = self.next_batch(queue, now)
            if b is None:
                return out
            out.append(b)
