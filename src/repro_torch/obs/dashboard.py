"""Live operator dashboard: terminal renderer + single-file HTML/SSE.

Modeled on dask-distributed's worker/status monitors, scaled down to
this stack's needs: per-worker occupancy bars, straggler/probation
state, the active objective mode, and p50/p99 latency — everything an
operator needs to see the *decisions* (steals, demotions, mode flips,
DP solves) as they happen, not just the end-of-run summary.

Three consumption modes, all driven by the same ``build_frame`` dicts:

  * ``render_frame`` — plain-text panel for ``serve.py --dashboard``
    (reprinted every ``--dashboard-every`` simulated seconds);
  * ``dashboard_html`` — one self-contained HTML file embedding every
    captured frame with a time scrubber (``--dashboard-html``; the CI
    artifact). No external assets, works from file://;
  * ``DashboardServer`` — a daemon-thread HTTP server pushing frames
    over Server-Sent Events (``--dashboard-port``); the same HTML page
    auto-subscribes to ``/events`` when it is served rather than opened
    from disk.

Frames are plain JSON-able dicts (the SSE wire format and the embedded
array are the same thing), so they also land nicely in the benchmark
artifacts. Reads router/fleet state only — never writes any of it.
"""
from __future__ import annotations

import http.server
import json
import threading
import time


def build_frame(now: float, router, fleet=None) -> dict:
    """Snapshot one dashboard frame from live router (+ FleetView)
    state. Pure read; safe to call from the control loop's clock hook."""
    from ..serving.metrics import percentile

    m = router.metrics
    total = m.completed + m.dropped
    solves = router.dyn.dp_solves
    frame = {
        "t": round(now, 3),
        "mode": router.dyn.mode,
        "completed": m.completed,
        "dropped": m.dropped,
        "queued": len(router.queue),
        "inflight": len(router.engine.inflight),
        "cells": len(router.engine.cells),
        "p50_ms": round(m.p50 * 1e3, 2),
        "p99_ms": round(m.p99 * 1e3, 2),
        "throughput": round(m.throughput, 3),
        "dp_solves": solves,
        "dp_per_1k_req": round(1e3 * solves / max(total, 1), 2),
        "place_ms_p50": round(percentile(m.place_s, 50) * 1e3, 3),
        "place_ms_p99": round(percentile(m.place_s, 99) * 1e3, 3),
        "steals": m.steals,
        "requeued": m.requeued,
        # multi-tenant serving (repro_torch.tenancy): preemption counters
        # and one row per tenant class seen so far
        "preemptions": m.preemptions,
        "preempted_requests": m.preempted_requests,
        "tenants": [
            {"name": name, "completed": acc["completed"],
             "dropped": acc["dropped"], "preempted": acc["preempted"],
             "p99_ms": round(percentile(acc["latencies"], 99) * 1e3, 2)}
            for name, acc in sorted(m.tenant_stats.items())],
        "mode_switches": (fleet.mode_switches if fleet is not None else 0),
        "demotions": (fleet.demotions if fleet is not None else 0),
        "stragglers": [
            {"cell": c.cid, "mnemonic": c.schedule.mnemonic,
             "stages": flagged}
            for c in router.engine.cells.values()
            if (flagged := c.monitor.flagged())],
        "probation": (sorted(router.probation.on_probation)
                      if router.probation is not None else []),
        "banned": (sorted(router.probation.banned)
                   if router.probation is not None else []),
        "workers": (fleet.worker_rows(now) if fleet is not None else []),
        # fleet management (repro_torch.fleet): learned host profiles + the
        # policy's look-ahead arrival forecast (None when reactive)
        "learned_profiles": (dict(sorted(
            (w, p.get("compute_scale")) for w, p in fleet.learned.items()))
            if fleet is not None else {}),
        "prewarms": (fleet.prewarms if fleet is not None else 0),
        "forecast_rate": _forecast_rate(router),
        # hot-cell replication + live migration (docs/cluster.md)
        "replicated_cells": (fleet.replicated_cells
                             if fleet is not None else 0),
        "migrations": (fleet.migrations if fleet is not None else 0),
        "retires": (fleet.retires if fleet is not None else 0),
    }
    frame.update(_power_tile(router, fleet))
    return frame


def _power_tile(router, fleet) -> dict:
    """Energy-governance fields: the governor's live state when one is
    attached (fleet watts vs cap, per-cell operating-point index), else
    the FleetView's power trace, else inert defaults. Pure read."""
    gov = getattr(router, "governor", None)
    if gov is not None:
        from ..energy.governor import sig_tag
        return {
            "watts": round(gov.last_watts, 3),
            "power_cap": (round(gov.last_cap, 3)
                          if gov.last_cap is not None else None),
            "opoints": {sig_tag(s): p.idx
                        for s, p in sorted(gov.points.items())},
            "opoint_switches": len(
                [e for e in gov.events if e.kind == "opoint"])
            if gov.ctrl is None else len(
                [e for e in gov.ctrl.events if e.kind == "opoint"]),
        }
    if fleet is not None and fleet.power:
        return {"watts": round(fleet.fleet_watts(), 3),
                "power_cap": fleet.power_cap(),
                "opoints": dict(sorted(fleet.opoints.items())),
                "opoint_switches": fleet.opoint_switches}
    return {"watts": 0.0, "power_cap": None, "opoints": {},
            "opoint_switches": 0}


def _forecast_rate(router) -> float | None:
    """The policy forecaster's current horizon-ahead rate, computed from
    its already-rolled level/trend (a pure read — no bucket advance from
    the dashboard; the policy itself rolls the forecaster each cycle)."""
    fc = getattr(router.policy, "forecaster", None)
    if fc is None or fc.level is None:
        return None
    return round(max(0.0, fc.level + fc.trend * fc.horizon), 3)


def _bar(frac: float, width: int = 20) -> str:
    full = int(round(max(0.0, min(1.0, frac)) * width))
    return "█" * full + "·" * (width - full)


def render_frame(frame: dict) -> str:
    """Terminal panel for one frame (``serve.py --dashboard``)."""
    out = [
        f"[dash] t={frame['t']:.1f}s mode={frame['mode']} "
        f"done={frame['completed']} drop={frame['dropped']} "
        f"queue={frame['queued']} inflight={frame['inflight']}",
        f"[dash] p50={frame['p50_ms']:.1f}ms p99={frame['p99_ms']:.1f}ms "
        f"thp={frame['throughput']:.2f}/s "
        f"dp/1k={frame['dp_per_1k_req']:.2f} "
        f"place p50={frame['place_ms_p50']:.2f}ms "
        f"p99={frame['place_ms_p99']:.2f}ms",
        f"[dash] steals={frame['steals']} requeued={frame['requeued']} "
        f"demotions={frame['demotions']} "
        f"mode_switches={frame['mode_switches']}",
    ]
    if frame.get("preemptions"):
        out.append(f"[dash] preemptions={frame['preemptions']} "
                   f"({frame['preempted_requests']} requests requeued)")
    for t in frame.get("tenants", []):
        out.append(f"[dash]   tenant {t['name']:>8s} "
                   f"done={t['completed']} drop={t['dropped']} "
                   f"preempted={t['preempted']} p99={t['p99_ms']:.1f}ms")
    if frame.get("forecast_rate") is not None:
        out.append(f"[dash] forecast={frame['forecast_rate']:.2f}/s "
                   f"prewarms={frame.get('prewarms', 0)}")
    if frame.get("replicated_cells") or frame.get("migrations"):
        out.append(f"[dash] replicated={frame['replicated_cells']} "
                   f"migrations={frame['migrations']} "
                   f"retires={frame.get('retires', 0)}")
    if frame.get("watts") or frame.get("power_cap") is not None:
        cap = frame.get("power_cap")
        cap_txt = f"{cap:.0f}W" if cap is not None else "none"
        ops = frame.get("opoints") or {}
        op_txt = (" ".join(f"{k}@{v}" for k, v in sorted(ops.items()))
                  or "-")
        out.append(f"[dash] power={frame['watts']:.0f}W cap={cap_txt} "
                   f"opoints: {op_txt} "
                   f"switches={frame.get('opoint_switches', 0)}")
    for w in frame["workers"]:
        state = ("parked" if w.get("parked")
                 else "alive " if w["alive"] else "LOST  ")
        learned = w.get("learned_scale")
        tag = f"  learned x{learned:g}" if learned is not None else ""
        if w.get("replicas"):
            tag += f"  replicas={w['replicas']}"
        if w.get("retiring"):
            tag += f"  retiring={w['retiring']}"
        out.append(f"[dash]   {w['wid']:>4s} [{state}] "
                   f"|{_bar(w['busy_frac'])}| "
                   f"{100 * w['busy_frac']:5.1f}% busy  "
                   f"backlog={w['backlog_s']:.2f}s done={w['done']}{tag}")
    for s in frame["stragglers"]:
        out.append(f"[dash]   straggler: cell {s['cell']} "
                   f"({s['mnemonic']}) stages {s['stages']}")
    if frame["probation"]:
        out.append(f"[dash]   probation: {frame['probation']}")
    if frame["banned"]:
        out.append(f"[dash]   banned: {frame['banned']}")
    return "\n".join(out)


# -- single-file HTML export -------------------------------------------------
_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>repro serving dashboard</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb; --page: #f9f9f7;
    --text-primary: #0b0b0b; --text-secondary: #52514e;
    --muted: #898781; --grid: #e1e0d9;
    --accent: #2a78d6; --track: #e1e0d9;
    --good: #0ca30c; --warning: #fab219; --critical: #d03b3b;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19; --page: #0d0d0d;
      --text-primary: #ffffff; --text-secondary: #c3c2b7;
      --muted: #898781; --grid: #2c2c2a;
      --accent: #3987e5; --track: #2c2c2a;
    }
  }
  body { margin: 0; background: var(--page); }
  .viz-root { font-family: system-ui, -apple-system, "Segoe UI",
              sans-serif; color: var(--text-primary);
              max-width: 880px; margin: 24px auto; padding: 0 16px; }
  h1 { font-size: 16px; font-weight: 600; }
  .tiles { display: flex; flex-wrap: wrap; gap: 8px; margin: 12px 0; }
  .tile { background: var(--surface-1); border: 1px solid var(--grid);
          border-radius: 6px; padding: 8px 12px; min-width: 96px; }
  .tile .v { font-size: 20px; font-weight: 600; }
  .tile .k { font-size: 11px; color: var(--text-secondary); }
  table { border-collapse: collapse; width: 100%;
          background: var(--surface-1); border: 1px solid var(--grid);
          border-radius: 6px; }
  th, td { text-align: left; font-size: 12px; padding: 6px 10px;
           border-top: 1px solid var(--grid);
           font-variant-numeric: tabular-nums; }
  th { color: var(--text-secondary); font-weight: 500; border-top: 0; }
  .meter { background: var(--track); border-radius: 3px; height: 8px;
           width: 160px; display: inline-block; vertical-align: middle; }
  .meter > div { background: var(--accent); border-radius: 3px;
                 height: 8px; }
  .state { font-size: 11px; }
  .state.alive { color: var(--good); }
  .state.lost { color: var(--critical); }
  .warn { color: var(--text-secondary); font-size: 12px; }
  input[type=range] { width: 100%; accent-color: var(--accent); }
  .sub { color: var(--muted); font-size: 11px; }
</style></head>
<body><div class="viz-root">
<h1>repro serving dashboard</h1>
<div class="sub" id="src"></div>
<input type="range" id="scrub" min="0" max="0" value="0">
<div class="tiles" id="tiles"></div>
<table id="workers"></table>
<div id="notes"></div>
<script>
const FRAMES = /*FRAMES*/[];
const scrub = document.getElementById('scrub');
function tile(k, v) {
  return '<div class="tile"><div class="v">' + v +
         '</div><div class="k">' + k + '</div></div>';
}
function esc(s) { return String(s).replace(/[<>&]/g,
  c => ({'<':'&lt;','>':'&gt;','&':'&amp;'}[c])); }
function show(i) {
  const f = FRAMES[i];
  if (!f) return;
  document.getElementById('tiles').innerHTML =
    tile('sim time', f.t.toFixed(1) + 's') +
    tile('mode', esc(f.mode)) +
    tile('completed', f.completed) + tile('dropped', f.dropped) +
    tile('queued', f.queued) +
    tile('p50', f.p50_ms.toFixed(1) + 'ms') +
    tile('p99', f.p99_ms.toFixed(1) + 'ms') +
    tile('DP / 1k req', f.dp_per_1k_req.toFixed(2)) +
    tile('place p99', f.place_ms_p99.toFixed(2) + 'ms') +
    tile('steals', f.steals) + tile('requeued', f.requeued) +
    tile('demotions', f.demotions) +
    (f.preemptions ? tile('preemptions', f.preemptions) : '') +
    (f.forecast_rate != null ?
      tile('forecast', f.forecast_rate.toFixed(2) + '/s') : '') +
    (f.replicated_cells || f.migrations ?
      tile('replicated', f.replicated_cells) +
      tile('migrations', f.migrations) : '') +
    (f.watts || f.power_cap != null ?
      tile('fleet power', f.watts.toFixed(0) + 'W' +
           (f.power_cap != null ? ' / ' + f.power_cap.toFixed(0) + 'W'
                                : '')) +
      tile('opoint switches', f.opoint_switches || 0) : '');
  let opnotes = '';
  for (const t of (f.tenants || []))
    opnotes += '<div class="sub">◆ tenant ' + esc(t.name) + ': done ' +
               t.completed + ', dropped ' + t.dropped + ', preempted ' +
               t.preempted + ', p99 ' + t.p99_ms.toFixed(1) + 'ms</div>';
  const ops = f.opoints || {};
  for (const k of Object.keys(ops).sort())
    opnotes += '<div class="sub">⚡ ' + esc(k) +
               ' @ frontier idx ' + ops[k] + '</div>';
  let rows = '<tr><th>worker</th><th>state</th><th>occupancy</th>' +
             '<th></th><th>backlog</th><th>done</th>' +
             '<th>learned</th></tr>';
  for (const w of f.workers) {
    const pct = (100 * w.busy_frac).toFixed(1) + '%';
    const st = w.parked ? '">◌ parked' :
      (w.alive ? 'alive">✓ alive' : 'lost">✗ LOST');
    rows += '<tr><td>' + esc(w.wid) + '</td><td><span class="state ' +
      st + '</span></td><td><span class="meter"><div style="width:' +
      pct + '"></div></span></td><td>' + pct + '</td><td>' +
      w.backlog_s.toFixed(2) + 's</td><td>' + w.done + '</td><td>' +
      (w.learned_scale != null ? 'x' + w.learned_scale.toFixed(2) : '—') +
      '</td></tr>';
  }
  document.getElementById('workers').innerHTML =
    f.workers.length ? rows : '';
  let notes = '';
  for (const s of f.stragglers)
    notes += '<div class="warn">⚠ straggler: cell ' + s.cell +
             ' (' + esc(s.mnemonic) + ') stages ' +
             esc(JSON.stringify(s.stages)) + '</div>';
  if (f.probation.length)
    notes += '<div class="warn">⚠ probation: ' +
             esc(f.probation.join(', ')) + '</div>';
  if (f.banned.length)
    notes += '<div class="warn">✗ banned: ' +
             esc(f.banned.join(', ')) + '</div>';
  document.getElementById('notes').innerHTML = opnotes + notes;
}
function sync() {
  scrub.max = Math.max(0, FRAMES.length - 1);
  scrub.value = scrub.max;
  show(FRAMES.length - 1);
}
scrub.addEventListener('input', () => show(+scrub.value));
document.getElementById('src').textContent =
  FRAMES.length + ' captured frame(s); drag to scrub';
sync();
try {   // live mode: the page is being served, not opened from disk
  const es = new EventSource('/events');
  es.onmessage = (e) => { FRAMES.push(JSON.parse(e.data)); sync(); };
} catch (err) {}
</script>
</div></body></html>
"""


def dashboard_html(frames: list[dict]) -> str:
    """Render every captured frame into one self-contained HTML page."""
    return _HTML.replace("/*FRAMES*/[]", json.dumps(frames))


# -- live SSE server ---------------------------------------------------------
class DashboardServer:
    """Daemon-thread HTTP server: ``/`` serves the dashboard page with
    the frames captured so far embedded; ``/events`` streams each new
    frame as a Server-Sent Event. ``push`` is called from the control
    loop's clock hook; handlers only ever read the shared frame list
    (append-only), so no locking is needed."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.frames: list[dict] = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):    # quiet; serve.py prints the URL
                pass

            def do_GET(self):
                if self.path == "/events":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    sent = 0
                    try:
                        while not outer._closing:
                            while sent < len(outer.frames):
                                data = json.dumps(outer.frames[sent])
                                self.wfile.write(
                                    f"data: {data}\n\n".encode())
                                sent += 1
                            self.wfile.flush()
                            time.sleep(0.2)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    return
                body = dashboard_html(outer.frames).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._closing = False
        self._srv = http.server.ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self.url = f"http://{host}:{self.port}/"
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def push(self, frame: dict) -> None:
        self.frames.append(frame)

    def close(self) -> None:
        self._closing = True
        self._srv.shutdown()
        self._srv.server_close()
