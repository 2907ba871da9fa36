"""What a dry run counts, at the calls that do the work: the hand-written
kernels' calls with their work, and the collectives with their bytes;
and the named spans of the model step that a profiler records.

Off by default: ``kernel`` and ``collective`` return at once unless a
``counting()`` block is open, so a real step pays one global read a
call. ``launch/dryrun.py`` opens one around a step on meta tensors.

  * A kernel entry point called on meta tensors (``kernels/swa.py``,
    ``kernels/ssd.py``), which runs its route's wrappers up to the launch,
    records one call under the name of the route it would take on the
    card, with the FLOPs and bytes of the same work formula that
    ``chip_smoke.py``'s bound reads.
  * ``launch/dist.py`` records each collective at its call: its kind, its
    operand bytes and its group. The bytes follow the reference dry run's
    convention (``src/repro/launch/dryrun.py:66-69``): an all-gather
    counts its input (the output over the group), a reduce-scatter its
    input (the output times the group), an all-reduce its operand.
  * ``span(name)`` marks a layer of the step (the pass, the forward, the
    backward and AdamW of a train step, a layer body, the parts of the
    Mamba2 mixer) as a named range while a profiler records, and is a
    shared no-op otherwise: no switch of its own turns it on. The ranges
    are CPU events on the profiler's clock, so a trace reduction can
    give each device operation the span that launched it
    (``perfbench/spans.py``); a layer body's range sits inside the
    callable that ``torch.utils.checkpoint`` runs, so remat's recompute
    enters it again, under the backward. A range is of an op's scope,
    as ``torch.profiler.record_function``'s user annotations are not: a
    kernel launched inside it with no ATen op around the launch (the
    ctypes entries of ``kernels/``) is linked to it, and the profiler
    draws no device-side copy of it, which a device trace would read as
    a device operation.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = "rt."
_NO_SPAN = contextlib.nullcontext()

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass
class Tally:
    # route name -> {"calls", "flops", "bytes"}
    kernels: dict = dataclasses.field(default_factory=dict)
    # (kind, group) -> {"count", "bytes", "group_size"}
    collectives: dict = dataclasses.field(default_factory=dict)

    def kernel_totals(self, key: str) -> dict:
        return {name: v[key] for name, v in sorted(self.kernels.items())}

    def by_kind(self) -> dict:
        """Count and bytes of each of the five kinds, over every group."""
        out = {k: {"count": 0, "bytes": 0} for k in KINDS}
        for (kind, _), v in self.collectives.items():
            out[kind]["count"] += v["count"]
            out[kind]["bytes"] += v["bytes"]
        return out


_active: Tally | None = None


@contextlib.contextmanager
def counting():
    """Count kernels and collectives inside the block; yields the Tally.
    Blocks do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a tally is already counting")
    _active = Tally()
    try:
        yield _active
    finally:
        _active = None


def active() -> bool:
    return _active is not None


def kernel(name: str, flops: float, nbytes: float) -> None:
    if _active is None:
        return
    e = _active.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0})
    e["calls"] += 1
    e["flops"] += float(flops)
    e["bytes"] += float(nbytes)


def collective(kind: str, nbytes: int, group, group_size: int) -> None:
    if _active is None:
        return
    e = _active.collectives.setdefault(
        (kind, group), {"count": 0, "bytes": 0, "group_size": group_size})
    e["count"] += 1
    e["bytes"] += int(nbytes)


def span(name: str):
    """A range named ``name`` (which starts with ``SPAN_PREFIX``) while a
    profiler records; the shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _NO_SPAN
