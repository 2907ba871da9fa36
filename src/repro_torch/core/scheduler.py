"""DYPE's dynamic-programming scheduler (paper Algorithm 1).

dp[i][f][g] = the best pipeline for kernels wl[0:i] using exactly f FPGAs and
g GPUs. Two tables are filled simultaneously and independently — dp_perf
(minimum pipeline period == maximum throughput) and dp_eng (minimum energy
per inference) — exactly as the pseudo-code's blue/orange paths.

Per transition we consider grouping kernels wl[i-j:i] into a new stage run by
n_f FPGAs (referencing dp[i-j][f-n_f][g]) or n_g GPUs (dp[i-j][f][g-n_g]).
The transfer between the previous stage and the new one is accounted on BOTH
ends (lines 17/21: destination-side cost added to the new stage, source-side
cost added to the previous pipeline's last stage).

The endpoint sweep over dp[|wl|][f][g] yields the Pareto candidates; the
mode selectors (perf-opt / energy-opt / balanced >=70% thp) pick the final
schedule (§II-A, §VI-A).

Generalization beyond the paper: the implementation is written against an
ordered list of device pools, so systems with more than two device types
(e.g. three kernel-implementation pools) reuse the same DP;
the public two-pool API mirrors the paper.
"""
from __future__ import annotations

import dataclasses
import itertools

from .comm_model import transfer_time
from .device import SystemSpec
from .energy_model import pipeline_energy
from .perf_model import PerfModel
from .workload import Workload

MEM_FRACTION = 0.9   # usable fraction of device memory for static data


# ---------------------------------------------------------------------------
# schedule data structures
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Stage:
    i0: int
    i1: int                      # kernels wl[i0:i1]
    dev: object                  # DeviceType
    n: int
    t_exec: float
    exec_parts: tuple            # ((kind, t), ...) for the energy model
    t_in: float = 0.0            # incoming transfer (destination side)
    t_out: float = 0.0           # outgoing transfer (source side)

    @property
    def total(self) -> float:
        return self.t_in + self.t_exec + self.t_out

    def with_out(self, t_out: float) -> "Stage":
        return dataclasses.replace(self, t_out=t_out)

    @property
    def mnemonic(self) -> str:
        return f"{self.n}{self.dev.name[0]}"


@dataclasses.dataclass(frozen=True)
class Pipeline:
    stages: tuple = ()
    period: float = 0.0          # max stage total == initiation interval
    inner: float = 0.0           # max stage total excluding the last stage
    # incremental energy bookkeeping: E = e_busy + n_static * period
    e_busy: float = 0.0          # sum n*(dyn exec + transfer comm) energy
    n_static: float = 0.0        # sum n * static_power over stages

    def extend(self, stage: Stage, t_src: float,
               stage_dyn: float | None = None) -> "Pipeline":
        """Append ``stage``; charge t_src to the current last stage.
        ``stage_dyn`` = precomputed sum(dyn(kind)*t) for the new stage."""
        if stage_dyn is None:
            stage_dyn = sum(stage.dev.dynamic(kind) * t
                            for kind, t in stage.exec_parts)
        e_new = stage.n * (stage_dyn
                           + stage.dev.transfer_power * stage.t_in)
        if not self.stages:
            return Pipeline((stage,), stage.total, 0.0,
                            self.e_busy + e_new,
                            self.n_static + stage.n * stage.dev.static_power)
        prev = self.stages[-1]
        last = prev.with_out(prev.t_out + t_src)
        inner = max(self.inner, last.total)
        period = max(inner, stage.total)
        e_busy = (self.e_busy + e_new
                  + prev.n * prev.dev.transfer_power * t_src)
        return Pipeline(self.stages[:-1] + (last, stage), period, inner,
                        e_busy, self.n_static + stage.n * stage.dev.static_power)

    @property
    def energy(self) -> float:
        """J per inference (identical to energy_model.pipeline_energy)."""
        return self.e_busy + self.n_static * self.period

    @property
    def throughput(self) -> float:
        return 1.0 / self.period if self.period > 0 else 0.0

    @property
    def mnemonic(self) -> str:
        return "".join(s.mnemonic for s in self.stages) or "-"

    def devices_used(self) -> dict:
        used = {}
        for s in self.stages:
            used[s.dev.name] = used.get(s.dev.name, 0) + s.n
        return used


@dataclasses.dataclass(frozen=True)
class ScheduleResult:
    pipeline: Pipeline
    throughput: float
    energy: float                # J per inference
    mode: str

    @property
    def energy_efficiency(self) -> float:
        """Inferences per joule; a non-positive energy (degenerate or
        defensive) maps to ``inf`` — never a ZeroDivisionError and never
        a negative efficiency (mirrors ``energy_model.energy_efficiency``)."""
        return 1.0 / self.energy if self.energy > 0 else float("inf")

    @property
    def power(self) -> float:
        """Watts at steady state: J/inference x inferences/second (see
        ``energy_model.pipeline_power`` for the unit conventions). Zero
        for a degenerate schedule — never negative."""
        return max(0.0, self.energy) * max(0.0, self.throughput)

    @property
    def mnemonic(self) -> str:
        return self.pipeline.mnemonic


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def static_bytes(k) -> float:
    """Per-kernel static (pre-loaded) data: graph structure / weights."""
    if k.kind == "spmm":
        return 8.0 * k.nnz + 4.0 * k.M        # CSR vals+cols, row ptr
    if k.kind == "gemm":
        return 4.0 * k.K * k.N                # weight matrix
    return 0.0


class Scheduler:
    """The DYPE scheduler. ``constraint(dev_name, kernel) -> bool`` restricts
    which device type may run a kernel (used to express FleetRec*).

    ``host`` (a ``device.HostProfile``) makes the solve *host-aware*: every
    kernel time is scaled by the host's per-device factor (via
    ``PerfModel.with_host``) and every inter-stage transfer by its
    bandwidth factor, so the DP's stage grouping and device assignment are
    optimized for the actual machine the pipeline will run on — a slow
    host may legitimately deserve a different split than the baseline.
    The resulting stage times ARE that host's physical times."""

    def __init__(self, system: SystemSpec, perf: PerfModel, *,
                 constraint=None, conflict_model: bool = True, host=None):
        self.sys = system
        self.host = host if (host is not None
                             and not host.is_uniform) else None
        self.perf = perf.with_host(host) if self.host is not None else perf
        self.constraint = constraint
        # conflicts only exist on PCIe/CXL root complexes
        self.conflict = conflict_model and system.interconnect.name.startswith(
            ("PCIe", "CXL"))
        self._cache = {}

    # -- stage building -----------------------------------------------------
    def _allowed(self, dev_name: str, kernels) -> bool:
        if self.constraint is None:
            return True
        return all(self.constraint(dev_name, k) for k in kernels)

    def _fits(self, kernels, dev, n: int) -> bool:
        static = sum(static_bytes(k) for k in kernels)
        dyn = max((k.bytes_in + k.bytes_out) for k in kernels)
        return (static / n + dyn / n) <= dev.mem_gb * 1e9 * MEM_FRACTION

    def _t_comm(self, wl, boundary: int, src_stage: Stage | None,
                dst_dev, n_dst: int) -> float:
        """Transfer of wl[boundary-1] output into the new stage."""
        if src_stage is None or boundary <= 0:
            return 0.0
        nbytes = wl[boundary - 1].bytes_out
        return transfer_time(nbytes, src_stage.dev, src_stage.n,
                             dst_dev, n_dst, self.sys.interconnect,
                             conflict=self.conflict
                             and src_stage.dev.name != dst_dev.name,
                             bw_scale=(self.host.bw_scale
                                       if self.host is not None else 1.0))

    def _dp_context(self, wl: Workload, pools):
        """Shared DP machinery for ``solve`` and ``solve_pools``: prefix
        tables, per-kernel times, the perf-pruning upper bound, and the
        memoized stage-prototype / inter-stage-comm helpers."""
        L = len(wl)
        pref = {dev.name: self.perf.prefix_table(wl, dev, cnt)
                for dev, cnt in pools if cnt > 0}
        ktime = {}
        for dev, cnt in pools:
            for n in range(1, cnt + 1):
                for i, k in enumerate(wl):
                    ktime[(dev.name, n, i)] = self.perf.kernel_time(k, dev, n)

        # perf-table pruning bound: the whole workload on the largest single
        # pool is a feasible one-stage pipeline, so the optimal period is
        # <= UB; any stage with t_exec >= UB can never join a perf-optimal
        # pipeline (its period >= t_exec). The energy table is NOT pruned
        # (energy-optimal pipelines may be arbitrarily slow).
        # x1.5 margin keeps near-optimal (sub-max-throughput) prefixes alive
        # for the balanced mode's >=70%-of-max sweep.
        UB = 1.5 * min((pref[dev.name][cnt][L]
                        for dev, cnt in pools if cnt > 0),
                       default=float("inf"))

        proto_cache = {}

        def proto(i0, i1, dev, n):
            """Memoized (Stage template, dyn-energy) for kernels wl[i0:i1]."""
            key = (i0, i1, dev.name, n)
            hit = proto_cache.get(key)
            if hit is not None:
                return hit
            t_exec = pref[dev.name][n][i1] - pref[dev.name][n][i0]
            parts = tuple((wl[i].kind, ktime[(dev.name, n, i)])
                          for i in range(i0, i1))
            st = Stage(i0, i1, dev, n, t_exec, parts)
            dyn = sum(dev.dynamic(kind) * t for kind, t in parts)
            proto_cache[key] = (st, dyn)
            return st, dyn

        # memoized inter-stage comm: (boundary, src_name, n_src, dst_name, n_dst)
        comm_cache = {}

        def comm(i0, src_stage, dev, n_d):
            if src_stage is None or i0 <= 0:
                return 0.0
            key = (i0, src_stage.dev.name, src_stage.n, dev.name, n_d)
            hit = comm_cache.get(key)
            if hit is None:
                hit = self._t_comm(wl, i0, src_stage, dev, n_d)
                comm_cache[key] = hit
            return hit

        return UB, proto, comm

    # -- the DP, generalized to N device pools -------------------------------
    def solve_pools(self, wl: Workload):
        """Algorithm 1 over an arbitrary ordered list of device pools.

        Same transitions as ``solve`` but the DP state is a per-pool count
        vector instead of the (f, g) pair, held in dicts keyed by that
        vector (the reachable-state set is sparse for small pools). Used
        whenever the system has more than the paper's two pools; the
        two-pool array version below stays the fast path."""
        pools = self.sys.pools
        L = len(wl)
        caps = tuple(cnt for _, cnt in pools)
        UB, proto, comm = self._dp_context(wl, pools)

        zero = tuple(0 for _ in pools)
        dp_perf = [dict() for _ in range(L + 1)]
        dp_eng = [dict() for _ in range(L + 1)]
        eng_val = [dict() for _ in range(L + 1)]
        dp_perf[0][zero] = Pipeline()
        dp_eng[0][zero] = Pipeline()
        eng_val[0][zero] = 0.0

        for i in range(1, L + 1):
            for j in range(1, i + 1):
                i0 = i - j
                kers = wl.kernels[i0:i]
                for p_idx, (dev, cnt) in enumerate(pools):
                    if cnt == 0 or not self._allowed(dev.name, kers):
                        continue
                    for n_d in range(1, cnt + 1):
                        if not self._fits(kers, dev, n_d):
                            continue
                        st0, dyn = proto(i0, i, dev, n_d)
                        if st0.t_exec < UB:
                            for counts, prev in dp_perf[i0].items():
                                if counts[p_idx] + n_d > caps[p_idx]:
                                    continue
                                nc = (counts[:p_idx]
                                      + (counts[p_idx] + n_d,)
                                      + counts[p_idx + 1:])
                                src = (prev.stages[-1] if prev.stages
                                       else None)
                                t_c = comm(i0, src, dev, n_d)
                                st = (dataclasses.replace(st0, t_in=t_c)
                                      if t_c else st0)
                                cand = prev.extend(st, t_c, dyn)
                                best = dp_perf[i].get(nc)
                                if best is None or cand.period < best.period:
                                    dp_perf[i][nc] = cand
                        for counts, prev_e in dp_eng[i0].items():
                            if counts[p_idx] + n_d > caps[p_idx]:
                                continue
                            nc = (counts[:p_idx]
                                  + (counts[p_idx] + n_d,)
                                  + counts[p_idx + 1:])
                            src = (prev_e.stages[-1] if prev_e.stages
                                   else None)
                            t_c = comm(i0, src, dev, n_d)
                            st = (dataclasses.replace(st0, t_in=t_c)
                                  if t_c else st0)
                            cand = prev_e.extend(st, t_c, dyn)
                            e = cand.energy
                            if e < eng_val[i].get(nc, float("inf")):
                                dp_eng[i][nc] = cand
                                eng_val[i][nc] = e
        return dp_perf, dp_eng

    # -- the DP (Algorithm 1, two-pool array fast path) ----------------------
    def solve(self, wl: Workload):
        sysm = self.sys
        pools = [(sysm.dev_a, sysm.n_a), (sysm.dev_b, sysm.n_b)]
        L = len(wl)
        nA, nB = sysm.n_a, sysm.n_b
        UB, proto, comm = self._dp_context(wl, pools)

        TOP = None
        dp_perf = [[[TOP] * (nB + 1) for _ in range(nA + 1)] for _ in range(L + 1)]
        dp_eng = [[[TOP] * (nB + 1) for _ in range(nA + 1)] for _ in range(L + 1)]
        eng_val = [[[float("inf")] * (nB + 1) for _ in range(nA + 1)]
                   for _ in range(L + 1)]
        dp_perf[0][0][0] = Pipeline()
        dp_eng[0][0][0] = Pipeline()
        eng_val[0][0][0] = 0.0

        for i in range(1, L + 1):
            for j in range(1, i + 1):
                i0 = i - j
                kers = wl.kernels[i0:i]
                prev_rows_p = dp_perf[i0]
                prev_rows_e = dp_eng[i0]
                for dev, cnt, pool_idx in ((pools[0][0], nA, 0),
                                           (pools[1][0], nB, 1)):
                    if cnt == 0 or not self._allowed(dev.name, kers):
                        continue
                    for n_d in range(1, cnt + 1):
                        if not self._fits(kers, dev, n_d):
                            continue
                        st0, dyn = proto(i0, i, dev, n_d)
                        perf_ok = st0.t_exec < UB
                        for pf in range(nA + 1):
                            f = pf + n_d if pool_idx == 0 else pf
                            if f > nA:
                                break
                            row_p, row_e = prev_rows_p[pf], prev_rows_e[pf]
                            dst_p, dst_e = dp_perf[i][f], dp_eng[i][f]
                            ev = eng_val[i][f]
                            for pg in range(nB + 1):
                                g = pg + n_d if pool_idx == 1 else pg
                                if g > nB:
                                    break
                                # ---- perf table ----
                                prev = row_p[pg] if perf_ok else None
                                if prev is not None:
                                    src = prev.stages[-1] if prev.stages else None
                                    t_c = comm(i0, src, dev, n_d)
                                    st = (dataclasses.replace(st0, t_in=t_c)
                                          if t_c else st0)
                                    cand = prev.extend(st, t_c, dyn)
                                    best = dst_p[g]
                                    if best is None or cand.period < best.period:
                                        dst_p[g] = cand
                                # ---- energy table ----
                                prev_e = row_e[pg]
                                if prev_e is not None:
                                    src = prev_e.stages[-1] if prev_e.stages else None
                                    t_c = comm(i0, src, dev, n_d)
                                    st = (dataclasses.replace(st0, t_in=t_c)
                                          if t_c else st0)
                                    cand = prev_e.extend(st, t_c, dyn)
                                    e = cand.energy
                                    if e < ev[g]:
                                        dst_e[g] = cand
                                        ev[g] = e
        return dp_perf, dp_eng

    # -- endpoint sweep + mode selection (§II-A) -----------------------------
    def endpoints(self, wl: Workload):
        """Pareto candidates as (counts, pipeline, table-tag) tuples, where
        ``counts`` is the per-pool device-count vector (2 entries for the
        paper system, more when SystemSpec.extra pools are present)."""
        pools = self.sys.pools
        key = (wl.name, len(wl),
               tuple((dev.name, cnt) for dev, cnt in pools),
               self.sys.interconnect.name, self.host)
        if key in self._cache:
            return self._cache[key]
        L = len(wl)
        out = []
        if len(pools) > 2:
            dp_perf, dp_eng = self.solve_pools(wl)
            for tbl, tag in ((dp_perf, "perf"), (dp_eng, "eng")):
                for counts, p in tbl[L].items():
                    if p is not None and p.stages:
                        out.append((counts, p, tag))
        else:
            dp_perf, dp_eng = self.solve(wl)
            for f in range(self.sys.n_a + 1):
                for g in range(self.sys.n_b + 1):
                    for tbl, tag in ((dp_perf, "perf"), (dp_eng, "eng")):
                        p = tbl[L][f][g]
                        if p is not None and p.stages:
                            out.append(((f, g), p, tag))
        self._cache[key] = out
        return out

    def schedule(self, wl: Workload, mode: str = "perf",
                 *, balanced_frac: float = 0.7) -> ScheduleResult:
        cands = self.endpoints(wl)
        if not cands:
            raise RuntimeError(f"no feasible schedule for {wl.name} on "
                               f"{self.sys.n_a}F/{self.sys.n_b}G")
        scored = [(p.throughput, p.energy, p) for counts, p, tag in cands]
        max_thp = max(s[0] for s in scored)
        if mode == "perf":
            thp, e, p = max(scored, key=lambda s: (s[0], -s[1]))
        elif mode == "energy":
            thp, e, p = min(scored, key=lambda s: (s[1], -s[0]))
        elif mode == "balanced":
            ok = [s for s in scored if s[0] >= balanced_frac * max_thp]
            thp, e, p = min(ok, key=lambda s: (s[1], -s[0]))
        else:
            raise ValueError(mode)
        return ScheduleResult(p, thp, e, mode)

    def pareto(self, wl: Workload):
        """Pareto-optimal (throughput, energy/inf, n_devices) candidates —
        the Fig. 9 design-space exploration, and the raw material
        ``repro.energy.frontier`` materializes into operating points.

        The front is *strictly* dominance-pruned: among equal-throughput
        candidates only the minimum-energy (then minimum-device) one
        survives, so walking the returned list is a monotone trade —
        throughput strictly decreases while energy strictly does not
        increase... in fact energy strictly decreases too, because a
        slower point that also costs >= energy would be dominated. The
        ordering is deterministic: descending throughput, then ascending
        energy, devices, and mnemonic as tie-breaks."""
        pts, seen = [], set()
        for counts, p, _ in self.endpoints(wl):
            e = p.energy
            key = (p.mnemonic, round(p.throughput, 9), round(e, 12))
            if key in seen:
                continue
            seen.add(key)
            pts.append({"f": counts[0], "g": counts[1], "counts": counts,
                        "mnemonic": p.mnemonic,
                        "throughput": p.throughput, "energy": e,
                        "devices": sum(counts), "pipeline": p})
        pts.sort(key=lambda d: (-d["throughput"], d["energy"],
                                d["devices"], d["mnemonic"]))
        front = []
        for a in pts:
            # sorted scan: every kept point has throughput >= a's, so a
            # survives iff it strictly improves the best energy seen so
            # far (ties in throughput keep only the first = cheapest;
            # equal-energy slower points are dominated)
            if front and front[-1]["energy"] <= a["energy"]:
                continue
            front.append(a)
        return front


# ---------------------------------------------------------------------------
# explicit-assignment evaluator (baselines + Table III ground-truth replay)
# ---------------------------------------------------------------------------
def evaluate_assignment(wl: Workload, assignment, system: SystemSpec,
                        perf: PerfModel) -> Pipeline:
    """``assignment`` = list of (i0, i1, dev_name, n). Builds the pipeline and
    evaluates it under ``perf`` (fitted models or oracle)."""
    devs = {dev.name: dev for dev, _ in system.pools}
    conflict = system.interconnect.name.startswith(("PCIe", "CXL"))
    pipe = Pipeline()
    prev = None
    for (i0, i1, dev_name, n) in assignment:
        dev = devs[dev_name]
        kers = wl.kernels[i0:i1]
        t_exec = perf.group_time(kers, dev, n)
        parts = tuple((k.kind, perf.kernel_time(k, dev, n)) for k in kers)
        if prev is None:
            t_in = t_src = 0.0
        else:
            nbytes = wl[i0 - 1].bytes_out
            t_in = t_src = transfer_time(
                nbytes, prev.dev, prev.n, dev, n, system.interconnect,
                conflict=conflict and prev.dev.name != dev_name)
        st = Stage(i0, i1, dev, n, t_exec, parts, t_in=t_in)
        pipe = pipe.extend(st, t_src)
        prev = st
    return pipe


def result_of(pipe: Pipeline, mode: str = "eval") -> ScheduleResult:
    e = pipeline_energy(pipe.stages, pipe.period)
    return ScheduleResult(pipe, pipe.throughput, e, mode)


# ---------------------------------------------------------------------------
# host-profile application (the cluster's physical-truth path)
# ---------------------------------------------------------------------------
def apply_profile(res: ScheduleResult, profile) -> ScheduleResult:
    """Rescale an already-solved schedule to one host's physics: each
    stage's exec time is multiplied by the host's per-device factor
    (``HostProfile.device_scale``), each transfer divided by its bandwidth
    factor, and period/energy are recomputed. The stage *split* is kept —
    this is what a host-oblivious control plane runs on a slow host (the
    baseline schedule, just slower), versus ``Scheduler(..., host=...)``
    which re-optimizes the split for that host. A uniform profile returns
    ``res`` unchanged (bit-identical homogeneous behavior)."""
    if profile is None or profile.is_uniform:
        return res
    stages = []
    for s in res.pipeline.stages:
        cs = profile.device_scale(s.dev.name)
        stages.append(dataclasses.replace(
            s, t_exec=s.t_exec * cs,
            exec_parts=tuple((kind, t * cs) for kind, t in s.exec_parts),
            t_in=s.t_in / profile.bw_scale,
            t_out=s.t_out / profile.bw_scale))
    stages = tuple(stages)
    period = max((s.total for s in stages), default=0.0)
    inner = max((s.total for s in stages[:-1]), default=0.0)
    e_busy = sum(
        s.n * (sum(s.dev.dynamic(kind) * t for kind, t in s.exec_parts)
               + s.dev.transfer_power * (s.t_in + s.t_out))
        for s in stages)
    n_static = sum(s.n * s.dev.static_power for s in stages)
    pipe = Pipeline(stages, period, inner, e_busy, n_static)
    return ScheduleResult(pipe, pipe.throughput, pipe.energy, res.mode)
