"""The benchmark's reduction of a traced window by the program's spans
(``perfbench/spans.py``): on the CPU events of a tiny remat train step,
with the leaf CPU ops standing in for kernels, each op counted once under
one label, the labels summing to the total, a backward op given its
forward op's span by sequence number, the recompute's ops ``:remat``; on
synthetic events, a kernel given the op that called the launch; and the
per-layer metrics that read the spans (``perfbench/span_metrics.json``)
well formed, each with a reader."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401

import span_harness as h

PERFBENCH = Path(__file__).resolve().parents[1] / "perfbench"
if str(PERFBENCH) not in sys.path:
    sys.path.insert(0, str(PERFBENCH))

import harness  # noqa: E402
import spans  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def step():
    """(events, window, stand-in ops) of one traced train step."""
    with h.one_thread():
        ev = h.train_step()[3]
    win = [e for e in ev if e.name == "perfbench.window"][0]
    window = (win.time_range.start, win.time_range.end)
    ops = [(e, e.time_range.start, e.time_range.end) for e in ev
           if not e.cpu_children and not e.name.startswith(
               (spans.PREFIX, spans.BENCH, spans.EVAL))]
    return ev, window, ops


def test_each_op_once_and_the_labels_sum_to_the_total(step):
    ev, window, ops = step
    sp = spans.attribute(ev, ops, window)
    assert sum(sp.ops.values()) == len(ops) > 1000
    total = sum(b - a for _, a, b in ops) / 1e6
    assert sum(sp.self_s.values()) == pytest.approx(total, rel=1e-9)
    assert sp.total_s == pytest.approx(total, rel=1e-9)
    assert sp.self_s.get(spans.UNSPANNED, 0) < 0.01 * total
    for span in h.MIXER:
        for phase in spans.PHASES:
            assert sp.self_s[span + phase] > 0, span + phase
    # a layer body's inclusive time holds its mixer's, phase by phase
    for phase in ("", ":remat"):
        assert sp.incl_s["rt.block" + phase] == pytest.approx(
            sp.self_s["rt.block" + phase]
            + sum(sp.self_s[m + phase] for m in h.MIXER))
    assert sp.entered["rt.block"] == 2 * h.CFG.n_layers
    assert sp.entered["rt.ssm.conv"] == 2 * h.CFG.n_layers
    assert sp.phase_s(":remat") == pytest.approx(sum(
        s for k, s in sp.self_s.items() if k.endswith(":remat")))
    assert sp.seconds("rt.ssm.conv") == pytest.approx(sum(
        sp.self_s["rt.ssm.conv" + p] for p in spans.PHASES))


def _leaves(e):
    if not e.cpu_children:
        return [e]
    return [x for c in e.cpu_children for x in _leaves(c)]


def test_a_backward_op_takes_its_forward_ops_span(step):
    """Each rsqrt's backward (the pre-norm's in ``rt.block``, the gated
    norm's, the final norm's) is labelled by the span of the forward
    rsqrt that made its node, found by sequence number."""
    ev, window, _ = step
    fwd = {e.sequence_nr: e for e in ev if e.name == "aten::rsqrt"
           and not h.in_backward(e)}
    bwd = [e for e in ev
           if e.name == spans.EVAL + ": RsqrtBackward0"]
    seen = set()
    for b in bwd:
        want = h.nearest(fwd[b.sequence_nr],
                         lambda n: n.startswith(spans.PREFIX)).name
        seen.add(want)
        ops = [(x, x.time_range.start, x.time_range.end)
               for x in _leaves(b)]
        sp = spans.attribute(ev, ops, window)
        assert set(sp.self_s) == {want + ":bwd"}
        assert set(sp.incl_s) >= {want + ":bwd", "rt.train.forward:bwd"}
    assert seen == {"rt.block", "rt.ssm.gated_norm", "rt.final_norm"}


def test_recompute_ops_carry_remat(step):
    ev, window, _ = step
    again = [e for e in ev if e.name.startswith(spans.PREFIX)
             and h.in_backward(e)]
    assert {e.name for e in again} == {"rt.block", *h.MIXER}
    for e in again:
        ops = [(x, x.time_range.start, x.time_range.end)
               for x in _leaves(e)
               if not x.name.startswith(spans.PREFIX)]
        sp = spans.attribute(ev, ops, window)
        assert all(k.endswith(":remat") for k in sp.self_s), sp.self_s
        if e.name in h.MIXER:
            assert set(sp.self_s) == {e.name + ":remat"}


def _event(i, name, thread, a, b, device=False, seq=-1, fwd_thread=0):
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent
    return FunctionEvent(
        id=i, name=name, thread=thread, start_us=a, end_us=b,
        fwd_thread=fwd_thread, sequence_nr=seq,
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_kernels_take_the_op_that_called_their_launch():
    """Synthetic events as the profiler gives them on a card: a kernel
    shares its correlation id with the runtime call that launched it, on
    the launching op's thread (an op may have the same id: ids 40-43 are
    also a view's). The forward's mul in ``rt.ssm.conv``, its backward on
    the autograd thread, a recompute's kernel launched straight from a
    span, one whose call the profiler left off every op's thread, one with
    no call, a kernel outside every span, and the idle gaps."""
    from torch.autograd.profiler_util import EventList
    cpu = [
        _event(1, "perfbench.window", 1, 0, 1000),
        _event(2, "rt.block", 1, 10, 100),
        _event(3, "rt.ssm.conv", 1, 20, 60),
        _event(4, "aten::mul", 1, 30, 50, seq=7),
        _event(40, "cudaLaunchKernel", 1, 35, 40),
        _event(42, "aten::view", 1, 52, 54),
        _event(5, "aten::add", 1, 110, 120),
        _event(41, "cudaLaunchKernel", 1, 112, 115),
        _event(6, spans.EVAL + ": MulBackward0", 2, 300, 400, seq=7,
               fwd_thread=1),
        _event(7, "aten::mul", 2, 310, 330),
        _event(42, "cudaLaunchKernel", 2, 315, 320),
        _event(8, spans.EVAL + ": CatBackward0", 2, 500, 600, seq=3,
               fwd_thread=1),
        _event(9, "rt.ssm.scan", 2, 510, 590),
        _event(43, "cuLaunchKernel", 2, 520, 525),
        _event(44, "cudaLaunchKernel", 99, 530, 531),
    ]
    gpu = [_event(40, "mul_kernel", 0, 200, 250, device=True),
           _event(41, "add_kernel", 0, 260, 270, device=True),
           _event(42, "mul_bwd_kernel", 0, 400, 530, device=True),
           _event(43, "ssd_chunk_out", 0, 600, 700, device=True),
           _event(44, "ssd_chunk_state", 0, 700, 720, device=True),
           _event(45, "Memset (Device)", 0, 750, 760, device=True),
           _event(1, "perfbench.window", 0, 0, 1000, device=True)]
    events = EventList(cpu + gpu)
    events._build_tree()
    sp = spans.from_events(events, (0, 1000))
    # the kernels of a call on a thread of no op, and with no call, count
    # as unspanned, beside the one launched outside every span
    assert sp.self_s == pytest.approx({
        "rt.ssm.conv": 50e-6, spans.UNSPANNED: 40e-6,
        "rt.ssm.conv:bwd": 130e-6, "rt.ssm.scan:remat": 100e-6})
    assert sp.ops[spans.UNSPANNED] == 3
    assert sp.incl_s["rt.block:bwd"] == pytest.approx(130e-6)
    assert sp.entered == {"rt.block": 1, "rt.ssm.conv": 1, "rt.ssm.scan": 1}
    assert sp.top(2) == [["rt.ssm.conv:bwd", pytest.approx(130e-6), 1],
                         ["rt.ssm.scan:remat", pytest.approx(100e-6), 1]]
    assert dict(sp.idle_by_span()) == pytest.approx(
        {"perfbench.window": 610e-6, "rt.ssm.scan": 70e-6})


METRICS = json.loads((PERFBENCH / "span_metrics.json").read_text())


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_span_metric_entries_are_well_formed_and_read(m):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {e["name"]: e for e in bench["end_to_end"]}
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] == "device_trace" and m["better"] == "lower"
    assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for c in m["workloads"]:
        assert c in e2e[m["moves"]]["workloads"]
    layers = {x["layer"] for x in bench["per_layer"]}
    assert m["layer"] in layers or m["layer"] == "optimizer: optim/adamw.py"
    names = {x["name"] for x in bench["per_layer"] + bench["end_to_end"]}
    assert m["name"] not in names
    read = harness.reader(m["name"])
    run = harness.Run(cell=None, steps=2)
    assert read(run) is None                        # no trace: no reading
    sp = spans.Spans(
        self_s={"rt.ssm.conv": 0.1, "rt.ssm.conv:remat": 0.1,
                "rt.ssm.gated_norm:bwd": 0.2, "rt.block": 0.3,
                "rt.train.adamw": 0.05, "rt.adamw.norm": 0.01,
                spans.UNSPANNED: 0.04},
        incl_s={"rt.ssm.conv": 0.1, "rt.ssm.conv:remat": 0.1,
                "rt.ssm.gated_norm:bwd": 0.2, "rt.block": 0.4,
                "rt.block:remat": 0.1, "rt.train.adamw": 0.06,
                "rt.adamw.norm": 0.01},
        ops={}, entered={}, idle={}, total_s=0.8)
    run.trace = type("Trace", (), {"spans": sp})()
    want = {"conv_ms": 100.0, "gated_norm_ms": 100.0, "block_self_ms": 150.0,
            "remat_ms": 50.0, "adamw_ms": 30.0, "unspanned_pct": 5.0}
    assert read(run) == pytest.approx(want[m["name"].split(".")[0]])
