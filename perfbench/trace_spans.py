#!/usr/bin/env python3
"""Run one cell once with ``--trace 1`` and split its device time by the
program's spans (``spans.py``):

    python3 perfbench/trace_spans.py --workload <cell> --seed <n> \\
        --seconds <s>

from the root of a checkout. The last line of standard output is the
traced run's result line as ``run.py --trace 1`` prints it, with the
metrics of ``span_metrics.json`` that list the cell and two more keys of
``breakdown``: ``spans``, the 20 labels with the most device seconds
(``[label, seconds, operations]``), and ``idle_by_span``, the idle
seconds by the innermost program or benchmark range that held each gap's
start. Standard error adds the traced window's tokens a second and each
span's entries.

The harness's traced run does not yet keep the spans (``harness.py``
would keep ``spans.from_events`` of the window's events on its trace);
this tool wraps ``devtrace.from_events`` for its one run to do so, so
the window, the check and every other number are the harness's own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

T0 = time.perf_counter()

import devtrace  # noqa: E402
import harness  # noqa: E402
import spans  # noqa: E402


def span_metrics(cell) -> list:
    """The entries of ``span_metrics.json`` that list ``cell`` and move one
    of its end-to-end metrics."""
    moved = {m["name"] for m in cell.end_to_end}
    return [m for m in json.loads((harness.HERE / "span_metrics.json")
                                  .read_text())
            if cell.name in m["workloads"] and m["moves"] in moved]


def run_traced(cell, seed: int, seconds: float, *, device, t0: float):
    """``harness.run_cell`` traced, with the spans kept on the trace and
    ``cell``'s span metrics read; returns (result line, Spans)."""
    kept = []

    def from_events(events):
        trace = wrapped(events)
        trace.spans = spans.from_events(events, trace.window)
        kept.append(trace.spans)
        return trace

    wrapped = devtrace.from_events
    cell = dataclasses.replace(
        cell, per_layer=cell.per_layer + span_metrics(cell))
    devtrace.from_events = from_events
    try:
        line = harness.run_cell(cell, seed, seconds, True, device=device,
                                t0=t0)
    finally:
        devtrace.from_events = wrapped
    sp = kept[0]
    checks = line.pop("checks")
    line["breakdown"]["spans"] = sp.top(20)
    line["breakdown"]["idle_by_span"] = sp.idle_by_span()
    line["checks"] = checks
    return line, sp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    sys.path.insert(0, str(harness.ROOT / "src"))
    harness.build_kernels()
    line, sp = run_traced(cell, args.seed, args.seconds, device="cuda",
                          t0=T0)
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    tokens = line["attempted"] * cell.mix["batch"] * cell.mix["seq_len"]
    rate = tokens / line["device"]["window_s"]
    print(f"trace_spans: traced window {rate:.1f} tokens/s; entered "
          f"{json.dumps(sp.entered)}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
