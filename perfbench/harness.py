"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

A cell names a configuration (``configs/<config>.json``: the published
sizes, and under ``as_run`` the numbers the program runs) and a traffic
mix (``traffic/<traffic>.json``: a ``kind`` and its parameters). The
kind's driver (``drivers/<kind>.py``) makes the weights and batches from
the seed, drives the program's step, and checks what the window
produced against the plain reference (``reference/``) with the cell's
limits (``limits/<cell>.json``). Each metric of the cell is read by
``metrics/<name>.py``, or ``metrics/<stem>.py`` for a name ``<stem>.<x>``.

A run: set-up (``setup_s``, from the process's start; the program's
CUDA kernels built first, their build timed apart on standard error),
then passes or steps dispatched back to back until ``--seconds`` have
passed on the host clock, then a synchronise that closes the window; the peak memory
is read, the program's state freed, and the check runs after. With
``--trace 1`` the window runs under ``torch.profiler`` and the line
holds the per-layer metrics, ``busy_s``, ``window_s`` and a breakdown.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    mix: dict               # the traffic file
    limits: dict            # number compared -> its limit
    end_to_end: list        # BENCHMARK.json's entries this cell reports
    per_layer: list

    @property
    def as_run(self) -> dict:
        return self.config["as_run"]


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take it."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0                  # passes or train steps in the window
    tokens: int = 0
    failed: int = 0
    peak_bytes: int = 0
    launches: dict = dataclasses.field(default_factory=dict)  # window's
    trace: object = None            # devtrace.Trace of a traced run


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = bench or json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    read = lambda p: json.loads((HERE / p).read_text())     # noqa: E731
    # a metric without a "workloads" list belongs to every cell, a
    # per-layer one to every cell that reports the metric it moves
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=w["chips"],
        config=read(f"configs/{w['config']}.json"),
        mix=read(f"traffic/{w['traffic']}.json"),
        limits=read(f"limits/{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])
                   and m["moves"] in moved])


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of ``metric``: metrics/<name>.py, else metrics/<stem>.py."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return _load_file(path, f"perfbench_metric_{stem}").read
    raise FileNotFoundError(f"no reader for metric {metric!r}")


def driver(kind: str):
    return _load_file(HERE / "drivers" / f"{kind}.py",
                      f"perfbench_driver_{kind}")


def build_kernels() -> tuple[float, int]:
    """Build every CUDA kernel of the program not yet built, into its
    ``build/`` inside the checkout (one ``nvcc`` a source, all at once):
    the build a checkout's first run pays, timed apart from the rest of
    set-up. Returns (seconds, sources compiled)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    return time.perf_counter() - t0, len(built)


def launch_counters() -> dict:
    """Every launch or call counter of the program's kernel entries (a
    ``.launches`` on a function of ``repro_torch.kernels``), by
    ``<module>.<entry>``."""
    import pkgutil

    import repro_torch.kernels as pkg
    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            n = getattr(obj, "launches", None)
            if callable(obj) and isinstance(n, int):
                out[f"{info.name}.{name}"] = n
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *,
             device, t0: float, wrap_step=None) -> dict:
    """One run of ``cell``; returns the result line's dict. ``wrap_step``
    (tests only) wraps the program's step, to break the timed path."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(cell)
    drv = driver(cell.mix["kind"]).Driver(cell, seed, dev, wrap_step)
    drv.setup()
    sync()
    run.setup_s = time.perf_counter() - t0

    calls0 = launch_counters()
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    with record_function("perfbench.window"):
        sync()
        start = time.perf_counter()
        while True:
            run.tokens += drv.step(run.steps)
            run.steps += 1
            if time.perf_counter() - start >= seconds:
                break
        with record_function("perfbench.sync"):
            sync()
        run.window_s = time.perf_counter() - start
    if prof is not None:
        prof.__exit__(None, None, None)
    run.launches = {k: n - calls0.get(k, 0)
                    for k, n in launch_counters().items()}
    run.peak_bytes = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0)
    if prof is not None:
        run.trace = devtrace.from_events(prof.events())
        del prof

    run.failed = drv.window_failures()
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check()
    print(f"perfbench: set-up {run.setup_s:.3f} s, window {run.window_s:.3f}"
          f" s of {run.steps} passes or steps, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = run.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in entries:                     # a reader that finds nothing to
        v = reader(m["name"])(run)        # read leaves its metric out
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    line = {"correct": bool(correct), "attempted": run.steps,
            "failed": run.failed, "metrics": metrics, "device": devinfo}
    if run.trace is not None:
        devinfo["busy_s"] = run.trace.busy_s
        devinfo["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = checks
    return line


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    sys.path.insert(0, str(ROOT / "src"))
    build_s, built = build_kernels()
    print(f"perfbench: kernel build {build_s:.3f} s, {built} sources "
          "compiled (inside setup_s)", file=sys.stderr)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    device="cuda", t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
