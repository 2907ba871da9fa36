"""The port's ExecutionBackend layer (``repro_torch/runtime/backend.py``,
``straggler.py``, ``elastic.py``) against the reference's own checks
(tests/test_backend.py, tests/test_async_engine.py), with the torch backend
in place of the Pallas one, plus parity with the reference:

* analytic vs torch completion ordering, ``finishes`` bit-identical;
* torch payload outputs vs the reference's ``PallasPipelineBackend``
  interpret payload on the same schedule and input, allclose at 1e-5
  (tests/test_torch_pipeline.py's tolerance);
* the spmm stage's ring graph times x equals ``0.5 * roll(x, 1)`` exactly,
  through the plain SpMM here and through the kernel on a card.

The torch backend runs on the CPU here (``device="cpu"``)."""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DATASETS, DynamicScheduler, PerfModel,
                              gcn_workload, paper_system,
                              swa_transformer_workload)
from repro_torch.kernels import spmm_csr_rows, spmm_csr_rows_plain
from repro_torch.runtime import (AnalyticBackend, BackendFuture,
                                 ElasticRuntime, ProbationTracker,
                                 ReplayBackend, StageChain,
                                 TorchPipelineBackend, TraceRecorder,
                                 WallClockCalibrator, make_backend,
                                 pipeline_fill)
from repro_torch.runtime.backend import ring_operand, ring_rows
from repro_torch.serving import (Engine, LoadWatermarkPolicy, Request,
                                 Router, SignatureBatcher, TrafficSim)

WL_A = gcn_workload(DATASETS["OA"])
WL_B = gcn_workload(DATASETS["OP"])
WL_L = swa_transformer_workload(1024, 512, layers=2)
PAYLOAD_TOL = 1e-5          # tests/test_torch_pipeline.py


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported here so that the ``cuda`` tests of this
    file also run on a machine that has a card and no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.core as core
    from repro.runtime import PallasPipelineBackend
    return types.SimpleNamespace(jnp=jnp, core=core,
                                 PallasPipelineBackend=PallasPipelineBackend)


def fresh_dyn(mode="perf"):
    return DynamicScheduler(paper_system("pcie4"), PerfModel(), mode=mode)


def torch_cpu(**kw):
    return TorchPipelineBackend(device="cpu", act_dim=4, act_batch=2, **kw)


def fresh_router(*, async_mode=True, backend=None, max_wait=0.0,
                 max_batch=4, max_cells=2, policy_window=10.0,
                 probation=None, calibrator=None):
    return Router(fresh_dyn(),
                  batcher=SignatureBatcher(max_batch=max_batch,
                                           max_wait=max_wait),
                  policy=LoadWatermarkPolicy(window=policy_window),
                  backend=backend, max_cells=max_cells,
                  async_mode=async_mode, probation=probation,
                  calibrator=calibrator)


class FakeBatch:
    def __init__(self, wl, n):
        self.wl = wl
        self.n = n

    def __len__(self):
        return self.n


# ---------------------------------------------------------------------------
# protocol basics
# ---------------------------------------------------------------------------
def test_analytic_report_matches_fill_period():
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = AnalyticBackend()
    h = be.prepare(res, WL_A, epoch=dyn.epoch)
    rep = be.execute(h, 4, 10.0)
    fill = pipeline_fill(res)
    per = res.pipeline.period
    assert rep.finishes == tuple(10.0 + fill + i * per for i in range(4))
    assert rep.finish == rep.finishes[-1]
    assert rep.energy_per_req == pytest.approx(res.energy)
    assert rep.stage_times == tuple(s.total for s in res.pipeline.stages)


def test_handle_staleness_tracks_epoch():
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    h = AnalyticBackend().prepare(res, WL_A, epoch=dyn.epoch)
    assert not h.stale(dyn.epoch)
    dyn.set_mode("energy")
    assert h.stale(dyn.epoch)


def test_make_backend_factory():
    assert isinstance(make_backend("analytic"), AnalyticBackend)
    be = make_backend("torch", device="cpu")
    assert isinstance(be, TorchPipelineBackend)
    assert be.device == torch.device("cpu") and be.name == "torch"
    with pytest.raises(ValueError):
        make_backend("quantum")
    with pytest.raises(ValueError):
        make_backend("pallas")


def test_torch_backend_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_backend("torch")
    with pytest.raises(RuntimeError, match="CUDA device"):
        TorchPipelineBackend()


def test_torch_backend_modes():
    assert torch_cpu(mode="auto").mode == "auto"
    assert torch_cpu(mode="chain").mode == "chain"
    # the mesh mode is built at prepare, over the schedule's slots
    # (tests/test_torch_mesh.py)
    assert torch_cpu(mode="mesh").mode == "mesh"
    with pytest.raises(ValueError):
        torch_cpu(mode="interpret")


def test_default_submit_wraps_execute():
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = AnalyticBackend()
    h = be.prepare(res, WL_A, epoch=dyn.epoch)
    fut = be.submit(h, 4, 2.0)
    assert isinstance(fut, BackendFuture) and fut.done()
    rep = be.execute(h, 4, 2.0)
    assert fut.finishes == rep.finishes
    assert fut.result().finishes == rep.finishes


def test_analytic_measured_synthesized_as_estimates():
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = AnalyticBackend()
    rep = be.execute(be.prepare(res, WL_A), 2, 0.0)
    assert rep.measured_stage_times == rep.stage_times
    assert rep.measured == tuple(s.total for s in res.pipeline.stages)


# ---------------------------------------------------------------------------
# the torch backend: execution, payload cache, two-phase future
# ---------------------------------------------------------------------------
def test_torch_backend_actually_executes():
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = torch_cpu()
    h = be.prepare(res, WL_A, epoch=dyn.epoch)
    assert isinstance(h.payload, StageChain)
    rep = be.execute(h, 3, 0.0)
    assert rep.wall > 0.0                    # real compute happened
    assert len(rep.finishes) == 3
    # prepared payloads are cached by stage structure
    h2 = be.prepare(res, WL_A, epoch=dyn.epoch)
    assert h2.payload is h.payload
    # a schedule of another structure gets its own payload
    h3 = be.prepare(dyn.submit(WL_L), WL_L, epoch=dyn.epoch)
    assert h3.payload is not h.payload
    assert len(be._payload_cache) == 2


def test_torch_future_is_two_phase():
    """Simulated finishes are known at submit; the measured wall and stage
    seconds only after result(). The stage intervals do not include the
    host time between the last stage and the reap, so they sum to at most
    the wall."""
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = torch_cpu()
    h = be.prepare(res, WL_A, epoch=dyn.epoch)
    fut = be.submit(h, 3, 5.0)
    assert not fut.done()
    assert len(fut.finishes) == 3 and fut.finishes[0] >= 5.0
    rep = fut.result()
    assert fut.done()
    assert rep.wall > 0.0
    n_stages = len(res.pipeline.stages)
    assert len(rep.measured) == n_stages
    assert all(t > 0.0 for t in rep.measured)
    assert sum(rep.measured) <= rep.wall
    assert rep.finishes == fut.finishes
    assert fut.result() is rep               # idempotent


# ---------------------------------------------------------------------------
# parity: analytic vs torch ordering, torch vs the reference's payload
# ---------------------------------------------------------------------------
def _stream_finishes(backend):
    """Run the same batch stream through ``backend``; returns the stream's
    (request-tag, finish-time) pairs sorted by completion."""
    dyn = fresh_dyn()
    out = []
    t0 = 0.0
    for tag, wl, n in (("a", WL_A, 3), ("l", WL_L, 2), ("b", WL_B, 4),
                       ("a2", WL_A, 1)):
        res = dyn.submit(wl)
        h = backend.prepare(res, wl, epoch=dyn.epoch)
        rep = backend.execute(h, n, t0)
        out.extend(((tag, i), f) for i, f in enumerate(rep.finishes))
        t0 = rep.finish
    order = [key for key, f in sorted(out, key=lambda kv: (kv[1], kv[0]))]
    return order, out


def test_analytic_torch_ordering_parity():
    order_a, fin_a = _stream_finishes(AnalyticBackend())
    order_t, fin_t = _stream_finishes(torch_cpu())
    assert order_a == order_t
    # times come from the same schedule model: bit-identical
    assert fin_a == fin_t


def _ref_payload_out(jref, wl_name, n):
    core = jref.core
    dyn = core.DynamicScheduler(core.paper_system("pcie4"), core.PerfModel(),
                                mode="perf")
    wl = {"gcn-OA": core.gcn_workload(core.DATASETS["OA"]),
          "gcn-OP": core.gcn_workload(core.DATASETS["OP"]),
          "swa-1k": core.swa_transformer_workload(1024, 512,
                                                  layers=2)}[wl_name]
    res = dyn.submit(wl)
    be = jref.PallasPipelineBackend(mode="interpret", act_dim=4, act_batch=2)
    h = be.prepare(res, wl, epoch=dyn.epoch)
    kind, stage_jits, params = h.payload
    assert kind == "interpret"
    x = be._micro(n)
    for s, sj in enumerate(stage_jits):
        x = sj(params["w"][s], x)
    kinds = [[wl[i].kind for i in range(s.i0, s.i1)]
             for s in res.pipeline.stages]
    return res.mnemonic, kinds, np.asarray(x)


@pytest.mark.parametrize("wl_name,wl", [("gcn-OA", WL_A), ("gcn-OP", WL_B),
                                        ("swa-1k", WL_L)])
@pytest.mark.parametrize("n", [1, 3, 8, 11])
def test_torch_payload_matches_reference_interpret_payload(jref, wl_name, wl,
                                                          n):
    dyn = fresh_dyn()
    res = dyn.submit(wl)
    be = torch_cpu()
    chain = be.prepare(res, wl, epoch=dyn.epoch).payload
    out = chain(be._micro(n)).numpy()
    mnemonic, kinds, ref = _ref_payload_out(jref, wl_name, n)
    assert res.mnemonic == mnemonic
    assert [list(k) for k in chain.kinds] == kinds
    assert out.shape == ref.shape == (min(n, 8), 2, 4)
    np.testing.assert_allclose(out, ref, atol=PAYLOAD_TOL, rtol=PAYLOAD_TOL)


def test_payload_stage_weights_and_input_match_reference(jref):
    """The stage weights and the microbatch input are the reference's
    exactly (the same float32 values)."""
    jnp = jref.jnp
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = TorchPipelineBackend(device="cpu")
    chain = be.prepare(res, WL_A).payload
    F = be.act_dim
    eye = jnp.eye(F, dtype=jnp.float32)
    ref_ws = np.stack([np.asarray((0.8 + 0.02 * s) * eye
                                  + 0.01 * jnp.roll(eye, s + 1, axis=1))
                       for s in range(len(res.pipeline.stages))])
    np.testing.assert_array_equal(chain.ws.numpy(), ref_ws)
    ref_be = jref.PallasPipelineBackend(mode="interpret")
    for n in (1, 5, 8, 20):
        np.testing.assert_array_equal(be._micro(n).numpy(),
                                      np.asarray(ref_be._micro(n)))


# ---------------------------------------------------------------------------
# the spmm stage's ring graph: exactly 0.5 * roll along the rows
# ---------------------------------------------------------------------------
def _ring_case(act_batch, m, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, act_batch, 16))
                         .astype(np.float32))
    want = (0.5 * torch.roll(x, 1, dims=1)).reshape(m * act_batch, 16)
    return x.reshape(m * act_batch, 16), want


@pytest.mark.parametrize("act_batch", [2, 8])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_ring_times_x_is_half_roll_exactly(act_batch, m):
    ring = ring_operand(act_batch, 8, device="cpu")
    assert ring.shape == (8 * act_batch, 8 * act_batch) and ring.nnz == \
        8 * act_batch
    op = ring_rows(ring, m * act_batch)
    x, want = _ring_case(act_batch, m)
    got = spmm_csr_rows_plain(op.indptr, op.indices, op.values, x)
    assert torch.equal(got, want)
    assert torch.equal(op @ x, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("act_batch", [2, 8])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_cuda_ring_times_x_is_half_roll_exactly(cuda, act_batch, m):
    ring = ring_operand(act_batch, 8, device=cuda)
    op = ring_rows(ring, m * act_batch)
    x, want = _ring_case(act_batch, m)
    n0 = spmm_csr_rows.launches
    got = op @ x.to(cuda)
    torch.cuda.synchronize()
    assert spmm_csr_rows.launches == n0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_torch_backend_runs_the_kernel_and_times_with_events(cuda):
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = TorchPipelineBackend(device=cuda)
    h = be.prepare(res, WL_A, epoch=dyn.epoch)
    n0 = spmm_csr_rows.launches
    rep = be.execute(h, 5, 0.0)
    assert spmm_csr_rows.launches > n0
    assert len(rep.measured) == len(res.pipeline.stages)
    assert all(t > 0.0 for t in rep.measured)
    assert sum(rep.measured) <= rep.wall
    an = AnalyticBackend()
    assert rep.finishes == an.execute(an.prepare(res, WL_A), 5, 0.0).finishes
    cpu = TorchPipelineBackend(device="cpu")
    want = cpu.prepare(res, WL_A).payload(cpu._micro(5))
    got = h.payload(be._micro(5)).cpu()
    torch.testing.assert_close(got, want, atol=PAYLOAD_TOL, rtol=PAYLOAD_TOL)


# ---------------------------------------------------------------------------
# trace record + replay
# ---------------------------------------------------------------------------
def test_trace_recorder_replay_roundtrip(tmp_path):
    dyn = fresh_dyn()
    rec = TraceRecorder(AnalyticBackend())
    reports = []
    for wl, n in ((WL_A, 3), (WL_B, 2)):
        res = dyn.submit(wl)
        h = rec.prepare(res, wl, epoch=dyn.epoch)
        reports.append((res, n, rec.execute(h, n, 1.0)))
    rep_be = rec.to_replay()
    for res, n, orig in reports:
        h = rep_be.prepare(res, WL_A, epoch=dyn.epoch)
        again = rep_be.execute(h, n, 1.0)
        assert again.finishes == pytest.approx(orig.finishes)
        assert again.energy_per_req == pytest.approx(orig.energy_per_req)
    path = tmp_path / "exec_traces.jsonl"
    rec.to_jsonl(path)
    loaded = ReplayBackend.from_jsonl(path, strict=True)
    res, n, orig = reports[0]
    h = loaded.prepare(res, WL_A, epoch=0)
    assert loaded.execute(h, n, 1.0).finishes == pytest.approx(orig.finishes)


def test_trace_key_distinguishes_shared_mnemonics():
    dyn = fresh_dyn()
    ra, rl = dyn.peek(WL_A), dyn.peek(WL_L)
    rec = TraceRecorder(AnalyticBackend())
    for res, wl in ((ra, WL_A), (rl, WL_L)):
        rec.execute(rec.prepare(res, wl, epoch=dyn.epoch), 2, 0.0)
    rep = rec.to_replay()
    fa = rep.execute(rep.prepare(ra, WL_A), 2, 0.0).finishes
    fl = rep.execute(rep.prepare(rl, WL_L), 2, 0.0).finishes
    an = AnalyticBackend()
    assert fa == pytest.approx(an.execute(an.prepare(ra, WL_A), 2,
                                          0.0).finishes)
    assert fl == pytest.approx(an.execute(an.prepare(rl, WL_L), 2,
                                          0.0).finishes)
    if ra.mnemonic == rl.mnemonic:
        assert fa != pytest.approx(fl)


def test_replay_backend_strict_raises_on_unknown():
    dyn = fresh_dyn()
    res = dyn.submit(WL_A)
    be = ReplayBackend({}, strict=True)
    h = be.prepare(res, WL_A)
    with pytest.raises(KeyError):
        be.execute(h, 1, 0.0)
    assert ReplayBackend({}).execute(h, 1, 0.0).finishes[0] > 0.0


def test_trace_recorder_on_wall_clock_backend_stays_sim_clock():
    """Recording a torch run must not bake wall-scale stage times into a
    trace whose fill/period are simulated seconds."""
    dyn = fresh_dyn()
    rec = TraceRecorder(torch_cpu())
    assert rec.measured_sim_clock is False
    res = dyn.submit(WL_A)
    h = rec.prepare(res, WL_A, epoch=dyn.epoch)
    rec.execute(h, 2, 0.0)
    tr = next(iter(rec.traces.values()))
    assert tr["stage_times"] == [s.total for s in res.pipeline.stages]


def test_trace_recorder_torch_replays_like_analytic(tmp_path):
    """A torch run recorded and replayed gives the analytic finishes."""
    dyn = fresh_dyn()
    rec = TraceRecorder(torch_cpu())
    res = dyn.submit(WL_B)
    orig = rec.execute(rec.prepare(res, WL_B, epoch=dyn.epoch), 4, 1.0)
    path = tmp_path / "t.jsonl"
    rec.to_jsonl(path)
    loaded = ReplayBackend.from_jsonl(path, strict=True)
    again = loaded.execute(loaded.prepare(res, WL_B), 4, 1.0)
    an = AnalyticBackend().execute(AnalyticBackend().prepare(res, WL_B), 4,
                                   1.0)
    assert again.finishes == pytest.approx(orig.finishes)
    assert orig.finishes == an.finishes


def test_trace_recorder_records_via_submit():
    dyn = fresh_dyn()
    rec = TraceRecorder(AnalyticBackend())
    res = dyn.submit(WL_A)
    h = rec.prepare(res, WL_A, epoch=dyn.epoch)
    fut = rec.submit(h, 2, 0.0)
    assert rec.traces == {}
    fut.result()
    assert len(rec.traces) == 1


# ---------------------------------------------------------------------------
# wall-clock measurements: telemetry only, unless calibrated
# ---------------------------------------------------------------------------
def test_wall_clock_measurements_never_feed_monitors():
    assert TorchPipelineBackend.measured_sim_clock is False
    assert AnalyticBackend.measured_sim_clock is True
    r = fresh_router(backend=torch_cpu())
    for i in range(4):
        r.submit(Request(i, WL_A, 0.0), 0.0)
    r.step(0.0)
    r.drain(0.0)
    cell = r.engine.last_cell
    assert all(s.n == 0 for s in cell.monitor.stats)   # nothing observed
    assert not any("straggler" in line for line in r.log)
    assert r.metrics.measured_stage_s > 0.0            # telemetry kept


def test_calibrator_accepts_torch_reports():
    """With a WallClockCalibrator the torch backend's measured seconds are
    taken as they are: after skip + warmup reports of one cell its
    per-stage scales lock, and later reports feed the monitors."""
    cal = WallClockCalibrator(warmup=2)
    r = fresh_router(backend=torch_cpu(), max_batch=2, policy_window=1e9,
                     calibrator=cal)
    t, rid = 0.0, 0
    for _ in range(5):
        for _ in range(2):
            r.submit(Request(rid, WL_B, t), t)
            rid += 1
        t += 30.0
        r.step(t)
    r.drain(t)
    locked = {k: st for k, st in cal._state.items()
              if st[0] >= cal.skip + cal.warmup}
    assert locked
    cell = r.engine.last_cell
    (n_seen, scales), = locked.values()
    assert len(scales) == len(cell.schedule.pipeline.stages)
    assert all(math.isfinite(s) and s > 0 for s in scales)
    assert all(s.n == n_seen - cal.skip - cal.warmup + 1
               for s in cell.monitor.stats)
    assert r.metrics.completed == rid


# ---------------------------------------------------------------------------
# sync/async parity, deferred reaping, overlap
# ---------------------------------------------------------------------------
def _drive(async_mode, backend=None):
    r = fresh_router(async_mode=async_mode, backend=backend)
    reqs = []
    for i in range(4):
        reqs.append(Request(i, WL_A, 0.0))
        reqs.append(Request(10 + i, WL_L, 0.0))
    for q in reqs:
        r.submit(q, 0.0)
    done = r.step(0.0) + r.drain(0.1)
    order = sorted(((q.finish, q.rid, q.start) for q in done))
    return r, order


@pytest.mark.parametrize("backend", ["analytic", "torch"])
def test_sync_async_identical_completion_ordering(backend):
    make = (lambda: torch_cpu()) if backend == "torch" else AnalyticBackend
    ra, oa = _drive(True, make())
    rs, os_ = _drive(False, make())
    assert oa == os_
    assert len(oa) == 8
    recs_a = [(d.t0, d.sig, d.cell, d.n, d.finish) for d in ra.dispatches]
    recs_s = [(d.t0, d.sig, d.cell, d.n, d.finish) for d in rs.dispatches]
    assert recs_a == recs_s


def test_deferred_reap_across_cycles():
    r = fresh_router(async_mode=True, backend=torch_cpu())
    for i in range(4):
        r.submit(Request(i, WL_A, 0.0), 0.0)
    assert r.step(0.0) == []
    assert len(r.engine.inflight) == 1
    assert len(r.step(100.0)) == 4
    assert r.engine.inflight == []
    assert r.drain(100.0) == []


def test_overlap_ratio_above_one_with_two_cells():
    r = fresh_router(async_mode=True, max_cells=2, backend=torch_cpu())
    for i in range(4):
        r.submit(Request(i, WL_A, 0.0), 0.0)
        r.submit(Request(10 + i, WL_L, 0.0), 0.0)
    r.step(0.0)
    r.drain(0.0)
    assert len({d.cell for d in r.dispatches}) == 2
    assert r.metrics.overlap_ratio > 1.0
    assert r.metrics.snapshot().measured_stage_s > 0.0


# ---------------------------------------------------------------------------
# Engine: residency, concurrency, eviction, invalidation
# ---------------------------------------------------------------------------
def test_engine_two_cells_disjoint_and_concurrent():
    dyn = fresh_dyn()
    eng = Engine(dyn, AnalyticBackend(), max_cells=2)
    ca, rep_a = eng.dispatch(FakeBatch(WL_A, 4), 0.0)
    cb, rep_b = eng.dispatch(FakeBatch(WL_L, 4), 0.0)
    assert ca is not cb and len(eng.cells) == 2
    used = eng.allocated()
    assert used.get("FPGA", 0) <= dyn.system.n_a
    assert used.get("GPU", 0) <= dyn.system.n_b
    assert rep_a.t0 == 0.0 and rep_b.t0 == 0.0
    cc, rep_c = eng.dispatch(FakeBatch(WL_B, 1), 0.0)
    assert rep_c.t0 >= min(rep_a.finish, rep_b.finish)


def test_engine_lru_eviction_and_capacity_accounting():
    dyn = fresh_dyn()
    eng = Engine(dyn, AnalyticBackend(), max_cells=1)
    c1, rep1 = eng.dispatch(FakeBatch(WL_A, 1), 0.0)
    c2, _ = eng.dispatch(FakeBatch(WL_L, 1), rep1.finish + 1.0)
    assert len(eng.cells) == 1 and eng.evictions == 1
    assert c2.key != c1.key
    fa, fb = eng.free()
    used = eng.allocated()
    assert fa + used.get("FPGA", 0) == dyn.system.n_a
    assert fb + used.get("GPU", 0) == dyn.system.n_b


def test_engine_epoch_invalidation_on_mode_flip_and_resize():
    dyn = fresh_dyn()
    eng = Engine(dyn, torch_cpu(), max_cells=2)
    c1, _ = eng.dispatch(FakeBatch(WL_A, 1), 0.0)
    dyn.set_mode("energy")
    c2, _ = eng.dispatch(FakeBatch(WL_A, 1), 100.0)
    assert c2 is not c1 and c2.epoch == dyn.epoch
    assert c2.schedule.mode == "energy"
    dyn.resize(2, 2)
    c3, _ = eng.dispatch(FakeBatch(WL_A, 1), 200.0)
    assert c3 is not c2 and c3.epoch == dyn.epoch


def test_engine_fair_share_cap():
    dyn = fresh_dyn()
    eng = Engine(dyn, AnalyticBackend(), max_cells=2)
    cell, _ = eng.dispatch(FakeBatch(WL_A, 1), 0.0)
    used = cell.schedule.pipeline.devices_used()
    assert used.get("FPGA", 0) <= math.ceil(dyn.system.n_a / 2)
    assert used.get("GPU", 0) <= math.ceil(dyn.system.n_b / 2)


def test_engine_busy_floor_survives_invalidation():
    dyn = fresh_dyn()
    eng = Engine(dyn, AnalyticBackend(), max_cells=2)
    cell, rep = eng.dispatch(FakeBatch(WL_A, 8), 0.0)
    drain = rep.finish
    dyn.resize(2, 2)
    assert not eng.ready(WL_A, drain / 2)
    cell2, rep2 = eng.dispatch(FakeBatch(WL_A, 1), drain / 2)
    assert rep2.t0 >= drain


def test_engine_admission_pool_keys_are_stable():
    dyn = fresh_dyn()
    eng = Engine(dyn, AnalyticBackend(), max_cells=2)
    t = 0.0
    for _ in range(6):
        for wl in (WL_A, WL_B, WL_L):
            _, rep = eng.dispatch(FakeBatch(wl, 1), t)
            t = rep.finish
    assert eng.evictions > 0
    assert dyn.dp_solves <= 3


def test_router_serves_two_cells_concurrently():
    r = fresh_router(backend=torch_cpu())
    for i in range(4):
        r.submit(Request(i, WL_A, 0.0), 0.0)
        r.submit(Request(10 + i, WL_L, 0.0), 0.0)
    done = r.step(0.0) + r.drain(0.0)
    assert len(done) == 8
    assert len({d.cell for d in r.dispatches}) == 2
    t0s = [d.t0 for d in r.dispatches]
    assert t0s[0] == t0s[1] == 0.0


def test_router_stream_parity_analytic_vs_torch():
    """Same traffic stream, analytic vs torch execution: identical
    per-request completion ordering end to end through the port's
    Router (tests/test_backend.py's comparison)."""
    def run(backend):
        r = Router(fresh_dyn(),
                   batcher=SignatureBatcher(max_batch=8, max_wait=0.25),
                   policy=LoadWatermarkPolicy(window=10.0),
                   backend=backend)
        TrafficSim(seed=5, duration=6.0, day=6.0, peak_rate=4.0,
                   trough_rate=1.0).run(r)
        return sorted(r.metrics.latencies), r.metrics.completed
    assert run(AnalyticBackend()) == run(torch_cpu())


# ---------------------------------------------------------------------------
# the measurement loop and elastic runtime on the port
# ---------------------------------------------------------------------------
def _slow_traces():
    rec = TraceRecorder(AnalyticBackend())
    r = fresh_router(backend=rec)
    for i in range(2):
        r.submit(Request(i, WL_B, 0.0), 0.0)
    r.step(0.0)
    r.drain(0.0)
    traces = {k: dict(v) for k, v in rec.traces.items()}
    for tr in traces.values():
        tr["stage_times"] = ([4.0 * tr["stage_times"][0]]
                             + tr["stage_times"][1:])
    return traces


def _drive_batches(r, n_batches, t0=0.0, rid0=0):
    t, rid = t0, rid0
    for _ in range(n_batches):
        for _ in range(2):
            r.submit(Request(rid, WL_B, t), t)
            rid += 1
        t += 30.0
        r.step(t)
    r.drain(t)
    return t, rid


def test_replay_slow_stage_flips_straggler_and_reschedules():
    r = fresh_router(backend=ReplayBackend(_slow_traces()), max_batch=2,
                     policy_window=1e9)
    _drive_batches(r, 6)
    assert any("straggler flagged" in line for line in r.log)
    assert any(e.reason == "resize" for e in r.dyn.events)
    sys0 = paper_system("pcie4")
    assert r.pool.n_a + r.pool.n_b == sys0.n_a + sys0.n_b - 1
    assert r.metrics.completed == 12


def test_probation_regression_pool_recovers():
    sys0 = paper_system("pcie4")
    full = sys0.n_a + sys0.n_b
    prob = ProbationTracker(clean_epochs=3)
    backend = ReplayBackend(_slow_traces())
    r = fresh_router(backend=backend, max_batch=2, policy_window=1e9,
                     probation=prob)
    t, rid = _drive_batches(r, 4)
    assert r.pool.n_a + r.pool.n_b == full - 1
    backend.traces.clear()
    _drive_batches(r, 8, t0=t, rid0=rid)
    assert any("probation: re-admitting" in line for line in r.log)
    assert r.pool.n_a + r.pool.n_b == full
    assert not prob.banned


def test_probation_tracker_readmits_every_demoted_device():
    p = ProbationTracker(clean_epochs=2)
    assert p.on_demotion("FPGA")
    assert p.on_demotion("FPGA")
    assert p.on_clean() == []
    assert p.on_clean() == ["FPGA", "FPGA"]
    assert "FPGA" in p.on_probation


def test_elastic_runtime_executes_through_torch_backend():
    dyn = fresh_dyn()
    rt = ElasticRuntime(dyn, WL_B, backend=torch_cpu())
    rep = rt.execute(3, t0=1.0)
    assert len(rep.finishes) == 3
    assert rep.finishes[0] == pytest.approx(1.0 + pipeline_fill(rt.schedule))
    rt.on_failure("FPGA", 1)
    rep2 = rt.execute(1, t0=2.0)
    assert rt.handle.epoch == dyn.epoch
    assert rep2.finishes[0] > 2.0
    assert not any("straggler" in line for line in rt.log)
