"""The traced window's device operations by the program's spans.

While a profiler records, the program enters named ranges at its layer
boundaries (``repro_torch/tally.py:span``, names ``rt.<layer>``): the
pass or the train step's forward, backward and AdamW, a layer body, the
parts of the Mamba2 mixer. The ranges are CPU events on the profiler's
clock, so each device operation is given the span that launched it:

- its launching CPU op is the parent of the CUDA runtime call that
  launched it (the CPU event named ``cu...`` with the operation's
  correlation id as its id, which the profiler puts on the launching
  op's thread); the walk goes up its ``cpu_parent`` chain to the
  nearest ``autograd::engine::evaluate_function`` event, if any;
- with no such event the operation is the forward's: its label is the
  innermost ``rt.`` range of the chain;
- with one, an ``rt.`` range below it is remat's recompute, which
  re-enters the layer body's spans inside the backward: ``<span>:remat``;
- with none below it the operation is the backward's, ``<span>:bwd``:
  the span of the forward op with the evaluate event's ``sequence_nr`` on
  its forward thread (the last such op to start, which made the node; a
  node made beside its op's own, as ``CopySlices`` is after an in-place
  op on a view, takes the op with the nearest lower number), or, for a
  node with no number (``AccumulateGrad``), the innermost ``rt.`` range
  on any thread that holds the launching op's start;
- an operation with no span is ``unspanned``.

Each operation counts once, under one label; inclusive times add an
operation to every span of its chain. Idle gaps of the device are
labelled by the innermost ``rt.`` or ``perfbench.`` range, on any
thread, that holds the gap's start.
"""
from __future__ import annotations

import bisect
import dataclasses

import devtrace

PREFIX = "rt."
BENCH = "perfbench."
EVAL = "autograd::engine::evaluate_function"
UNSPANNED = "unspanned"
PHASES = ("", ":remat", ":bwd")


@dataclasses.dataclass
class Spans:
    """Device seconds of the window by label (``<span><phase>`` or
    ``unspanned``): ``self_s`` counts each operation under its label,
    ``incl_s`` under every span of its chain in its phase; ``ops`` is the
    number of operations under each label, ``entered`` the times each
    span was entered and ``idle`` the idle seconds by host range."""
    self_s: dict
    incl_s: dict
    ops: dict
    entered: dict
    idle: dict
    total_s: float

    def seconds(self, span: str, *, inclusive: bool = False,
                phases=PHASES) -> float:
        """Device seconds of ``span`` over ``phases``."""
        by = self.incl_s if inclusive else self.self_s
        return sum(by.get(span + p, 0.0) for p in phases)

    def phase_s(self, phase: str) -> float:
        """Device seconds of every operation of ``phase``."""
        return sum(s for k, s in self.self_s.items()
                   if k != UNSPANNED and _phase(k) == phase)

    def top(self, k: int = 20):
        """[label, seconds, operations] of the ``k`` largest labels."""
        return [[n, s, self.ops[n]] for n, s in
                sorted(self.self_s.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_span(self, k: int = 10):
        return [[n, s] for n, s in
                sorted(self.idle.items(), key=lambda kv: -kv[1])[:k]]


def _phase(label: str) -> str:
    i = label.find(":")
    return "" if i < 0 else label[i:]


class _Stab:
    """The innermost of a set of CPU events that holds an instant, over
    every thread: each thread's events nest, so from the last event to
    start before the instant the walk goes up its enclosing events."""

    def __init__(self, events):
        self.threads = []
        by = {}
        for e in events:
            by.setdefault(e.thread, []).append(e)
        for es in by.values():
            es.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
            parent, open_ = [], []
            for i, e in enumerate(es):
                while open_ and es[open_[-1]].time_range.end \
                        <= e.time_range.start:
                    open_.pop()
                parent.append(open_[-1] if open_ else -1)
                open_.append(i)
            self.threads.append((es, [e.time_range.start for e in es],
                                 parent))

    def at(self, t):
        best = None
        for es, starts, parent in self.threads:
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and es[i].time_range.end <= t:
                i = parent[i]
            if i >= 0 and (best is None or es[i].time_range.elapsed_us()
                           < best.time_range.elapsed_us()):
                best = es[i]
        return best


def _walk(ev, memo):
    """(the ``rt.`` names from ``ev`` up to its nearest evaluate event,
    innermost first; that event, or None), ``ev`` included."""
    path, e = [], ev
    while e is not None and id(e) not in memo:
        path.append(e)
        e = e.cpu_parent
    info = memo[id(e)] if e is not None else ((), None)
    for e in reversed(path):
        if e.name.startswith(EVAL):
            info = ((), e)
        elif e.name.startswith(PREFIX):
            info = ((e.name,) + info[0], info[1])
        memo[id(e)] = info
    return info


def device_ops(events):
    """(launching CPU op or None, start, end) of each device operation:
    the CUDA events other than the benchmark's ranges (``devtrace``'s
    set), each launched by the parent of the runtime call (``cuda...``,
    ``cu...``) that shares its correlation id."""
    from torch.autograd import DeviceType
    calls = {e.id: e for e in events if e.device_type == DeviceType.CPU
             and not e.is_async and e.name.startswith("cu")}
    out = []
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                (BENCH, PREFIX)):
            call = calls.get(e.id)
            out.append((None if call is None else call.cpu_parent,
                        e.time_range.start, e.time_range.end))
    return out


def attribute(events, ops, window) -> Spans:
    """``Spans`` of ``ops`` ((launcher, start, end), microseconds on the
    profiler's clock) clipped to ``window``, with the CPU ``events`` that
    hold the program's ranges and the autograd engine's."""
    from torch.autograd import DeviceType
    w0, w1 = window
    cpu = [e for e in events
           if e.device_type == DeviceType.CPU and not e.is_async]
    memo = {}
    fwd = {}                 # thread -> {sequence_nr: the last forward op}
    rt_ranges, all_ranges = [], []
    entered = {}
    for e in cpu:
        a = e.time_range.start
        if e.name.startswith(PREFIX):
            rt_ranges.append(e)
            all_ranges.append(e)
            if w0 <= a < w1:
                entered[e.name] = entered.get(e.name, 0) + 1
        elif e.name.startswith(BENCH):
            all_ranges.append(e)
        if e.sequence_nr >= 0 and not e.name.startswith(EVAL):
            names, ev_fn = _walk(e, memo)
            th = fwd.setdefault(e.thread, {})
            if ev_fn is None and (e.sequence_nr not in th
                                  or a >= th[e.sequence_nr][0]):
                th[e.sequence_nr] = (a, names)
    numbers = {t: sorted(th) for t, th in fwd.items()}
    rt_stab = _Stab(rt_ranges)

    def forward_chain(ev_fn):
        th, n = fwd.get(ev_fn.fwd_thread, {}), ev_fn.sequence_nr
        i = bisect.bisect_right(numbers.get(ev_fn.fwd_thread, []), n) - 1
        if n < 0 or i < 0:
            return None
        return th[numbers[ev_fn.fwd_thread][i]][1]

    self_s, incl_s, n_ops = {}, {}, {}
    kept = []
    for launcher, a, b in ops:
        if b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        kept.append((a, b))
        chain, phase = (), ""
        if launcher is not None:
            chain, ev_fn = _walk(launcher, memo)
            if ev_fn is not None:
                phase = ":remat" if chain else ":bwd"
                if not chain:
                    chain = forward_chain(ev_fn)
                    if chain is None:
                        r = rt_stab.at(launcher.time_range.start)
                        chain = () if r is None else _walk(r, memo)[0]
        s = (b - a) / 1e6
        label = chain[0] + phase if chain else UNSPANNED
        self_s[label] = self_s.get(label, 0.0) + s
        n_ops[label] = n_ops.get(label, 0) + 1
        for name in dict.fromkeys(chain):
            incl_s[name + phase] = incl_s.get(name + phase, 0.0) + s
    idle = _idle(kept, window, _Stab(all_ranges))
    return Spans(self_s, incl_s, n_ops, entered, idle,
                 sum(self_s.values()))


def _idle(intervals, window, stab):
    busy = devtrace.merged(intervals)
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    by = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            r = stab.at(a)
            name = "host outside the window" if r is None else r.name
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return by


def of(run):
    """The ``Spans`` that a traced run keeps on its trace
    (``run.trace.spans``); None where it keeps none, or where its window
    ran no device operation."""
    sp = getattr(run.trace, "spans", None)
    return sp if sp is not None and sp.total_s > 0 else None


def from_events(events, window) -> Spans:
    """``Spans`` of a traced window: ``torch.profiler``'s events and the
    window's (start, end) on its clock (``devtrace.Trace.window``)."""
    return attribute(events, device_ops(events), window)
