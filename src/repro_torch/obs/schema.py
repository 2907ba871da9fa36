"""Span schema + validation for trace JSONL files.

One place defines what a well-formed trace looks like; ``tools/
check_trace.py`` (CI) and the tests both call ``validate``. The schema
(docs/observability.md has the walkthrough):

  * every record carries ``REQUIRED_KEYS``; ``span`` ids are unique
    integers; ``t1 >= t0`` on the simulated clock;
  * ``parent`` is null or the id of another span **of the same trace**
    (roots are emitted at close, so children legitimately precede their
    parent in file order — integrity is resolved over the whole file);
  * request traces (``"r<rid>"``) have exactly one root named
    ``"request"`` whose ``status`` is one of ``STATUSES``;
  * a ``completed`` request covers the full causal chain — at least one
    ``admit``, ``solve``, ``submit``, and ``reap`` span — in
    non-decreasing simulated-clock order:

        arrival <= admit <= first solve <= first submit <= reap
        and reap >= every submit (requeue cycles resubmit later).

    Ordering is non-strict: admission happens within the arrival tick,
    so equal timestamps are legal; ``EPS`` absorbs float noise.

``validate`` returns ``(errors, stats)`` — an empty error list means the
trace is schema-valid; ``stats["coverage"]`` is the fraction of completed
requests whose trace covers the full chain (CI requires >= 0.99).
"""
from __future__ import annotations

import json

REQUIRED_KEYS = ("trace", "span", "parent", "name", "t0", "t1", "w0", "w1")
#: the causal chain every completed request must cover, in order
REQUEST_CHAIN = ("admit", "solve", "submit", "reap")
STATUSES = ("completed", "rejected", "expired", "unfinished")
EPS = 1e-9


def is_request_trace(trace: str) -> bool:
    """Request traces are ``"r<rid>"`` with an integer rid — distinct
    from the housekeeping traces (``"router"``, ``"engine"``,
    ``"w:<wid>"``)."""
    return trace.startswith("r") and trace[1:].isdigit()


def read_jsonl(path) -> list[dict]:
    """Parse one span record per non-empty line."""
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def _check_record(i: int, rec: dict, errors: list) -> bool:
    for k in REQUIRED_KEYS:
        if k not in rec:
            errors.append(f"record {i}: missing key {k!r}")
            return False
    if not isinstance(rec["span"], int):
        errors.append(f"record {i}: span id {rec['span']!r} not an int")
        return False
    if rec["parent"] is not None and not isinstance(rec["parent"], int):
        errors.append(f"record {i}: parent {rec['parent']!r} not int/null")
        return False
    if rec["t1"] < rec["t0"] - EPS:
        errors.append(f"record {i}: t1 < t0 ({rec['t1']} < {rec['t0']})")
        return False
    return True


def _check_request_trace(trace: str, spans: list[dict],
                         errors: list) -> str | None:
    """Validate one request trace; returns its status (None if broken)."""
    roots = [s for s in spans if s["parent"] is None]
    if len(roots) != 1 or roots[0]["name"] != "request":
        errors.append(f"trace {trace}: expected exactly one 'request' "
                      f"root, got {[r['name'] for r in roots]}")
        return None
    root = roots[0]
    status = root.get("status")
    if status not in STATUSES:
        errors.append(f"trace {trace}: root status {status!r} "
                      f"not in {STATUSES}")
        return None
    if status != "completed":
        return status
    arrival = root["t0"]
    times = {name: sorted(s["t0"] for s in spans if s["name"] == name)
             for name in REQUEST_CHAIN}
    if any(not times[name] for name in REQUEST_CHAIN):
        # counts against coverage (the >= 99% gate), not a hard error
        return "incomplete"
    order = [("arrival", arrival), ("admit", times["admit"][0]),
             ("solve", times["solve"][0]), ("submit", times["submit"][0]),
             ("reap", times["reap"][-1])]
    for (a, ta), (b, tb) in zip(order, order[1:]):
        if tb < ta - EPS:
            errors.append(f"trace {trace}: {b} at {tb} precedes "
                          f"{a} at {ta}")
            return "incomplete"
    if times["reap"][-1] < times["submit"][-1] - EPS:
        errors.append(f"trace {trace}: last submit at "
                      f"{times['submit'][-1]} after reap at "
                      f"{times['reap'][-1]}")
        return "incomplete"
    return status


def validate(records: list[dict]) -> tuple[list[str], dict]:
    """Validate a full span stream; returns ``(errors, stats)``."""
    errors: list[str] = []
    seen_ids: set[int] = set()
    by_trace: dict[str, list[dict]] = {}
    for i, rec in enumerate(records):
        if not _check_record(i, rec, errors):
            continue
        if rec["span"] in seen_ids:
            errors.append(f"record {i}: duplicate span id {rec['span']}")
        seen_ids.add(rec["span"])
        by_trace.setdefault(rec["trace"], []).append(rec)
    for trace, spans in by_trace.items():
        ids = {s["span"] for s in spans}
        for s in spans:
            if s["parent"] is not None and s["parent"] not in ids:
                errors.append(f"trace {trace}: span {s['span']} has "
                              f"unknown parent {s['parent']}")
    n_completed = n_covered = 0
    statuses: dict[str, int] = {}
    for trace in sorted(by_trace):
        if not is_request_trace(trace):
            continue
        status = _check_request_trace(trace, by_trace[trace], errors)
        if status is None:
            continue
        statuses[status] = statuses.get(status, 0) + 1
        if status == "completed":
            n_completed += 1
            n_covered += 1
        elif status == "incomplete":
            n_completed += 1
    names: dict[str, int] = {}
    for rec in records:
        n = rec.get("name")
        names[n] = names.get(n, 0) + 1
    stats = {
        "spans": len(records),
        "traces": len(by_trace),
        "request_statuses": statuses,
        "completed": n_completed,
        "coverage": (n_covered / n_completed) if n_completed else 1.0,
        "names": names,
    }
    return errors, stats
