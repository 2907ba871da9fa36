"""The traced run's reduction: the device operations of the window from
``torch.profiler``, their busy time (the union of their intervals), the
idle gaps labelled by the benchmark's own host ranges, and the kernel
classes the per-layer metrics read.

The harness holds ``record_function`` ranges named ``perfbench.<what>``
around its own calls into the program (``perfbench.window`` around the
whole window, ``perfbench.batch``, ``perfbench.step``, ``perfbench.sync``
inside it); a gap in the device's work is labelled by the innermost such
range that holds its start. Kernel classes: an SSD kernel has ``ssd`` in
its name (every kernel of the program's SSD route does), a cuBLAS or
CUTLASS product one of ``GEMM_MARKS``; the rest is everything else.
"""
from __future__ import annotations

import dataclasses

PREFIX = "perfbench."
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "s16816", "s1688")


def is_ssd(name: str) -> bool:
    return "ssd" in name.lower()


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in GEMM_MARKS)


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def merged(intervals):
    """The union of intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Trace:
    """The window's device operations (name, start, end), microseconds on
    the profiler's clock, and the benchmark's host ranges."""
    ops: list
    ranges: list
    window: tuple

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((a, b) for _, a, b in self.ops) / 1e6

    def seconds(self, pick) -> float:
        """Device seconds of the operations whose name ``pick`` accepts."""
        return sum(b - a for n, a, b in self.ops if pick(n)) / 1e6

    def top_ops(self, k: int = 10):
        tot = {}
        for n, a, b in self.ops:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """Idle seconds of the window by the host range that held each
        gap's start, the largest first."""
        busy = merged((a, b) for _, a, b in self.ops)
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        by = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                label = self.label_at(a)
                by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def label_at(self, t) -> str:
        best = None
        for n, a, b in self.ranges:
            if a <= t < b and (best is None or b - a < best[2] - best[1]):
                best = (n, a, b)
        return "host outside the window" if best is None else \
            best[0][len(PREFIX):]


def from_events(events) -> Trace:
    """A ``Trace`` from ``torch.profiler``'s events: device operations are
    the CUDA events other than the benchmark's own ranges, clipped to the
    ``perfbench.window`` range."""
    from torch.autograd import DeviceType
    ops, ranges = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(PREFIX):
            if e.device_type == DeviceType.CPU:
                ranges.append((e.name, a, b))
        elif e.device_type == DeviceType.CUDA:
            ops.append((e.name, a, b))
    win = [r for r in ranges if r[0] == PREFIX + "window"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window ranges")
    w0, w1 = win[0][1], win[0][2]
    ops = [(n, max(a, w0), min(b, w1)) for n, a, b in ops
           if b > w0 and a < w1]
    return Trace(ops, ranges, (w0, w1))
