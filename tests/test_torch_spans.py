"""The program's spans (``repro_torch/tally.py:span``) at the layer
boundaries of the model step, on the CPU under ``torch.profiler``: a
layer body entered once a layer in a prefill pass and twice in a remat
train step; every ATen op of the Mamba2 mixer, in the forward and in
remat's recompute, inside one of its five spans; a layer body's own ops
only the pre-norm and the residual add; and with no profiler the shared
no-op, with the step's outputs bitwise those of a traced run."""
import collections

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401

import span_harness as h
from repro_torch import tally
from repro_torch.models import ssm
from repro_torch.models.common import tree_leaves
from repro_torch.models.layers import rms_norm

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def train_events():
    with h.one_thread():
        return h.train_step()[3]


@pytest.fixture(scope="module")
def prefill_events():
    with h.one_thread():
        return h.prefill()[1]


def _named(events, name):
    return [e for e in events if e.name == name]


def test_block_entered_once_a_layer_and_again_in_remat(train_events,
                                                       prefill_events):
    n = h.CFG.n_layers
    assert h.CFG.remat
    assert len(_named(prefill_events, "rt.block")) == n
    blocks = _named(train_events, "rt.block")
    assert len(blocks) == 2 * n
    assert sum(h.in_backward(b) for b in blocks) == n
    for name in ("rt.prefill", "rt.embed", "rt.final_norm", "rt.logits"):
        assert len(_named(prefill_events, name)) == 1, name
    for name in ("rt.train.forward", "rt.train.backward", "rt.train.adamw",
                 "rt.adamw.norm", "rt.loss", "rt.embed", "rt.final_norm"):
        assert len(_named(train_events, name)) == 1, name


def _aten(events):
    return [e for e in events if e.name.startswith("aten::")]


def test_every_mixer_op_lies_in_a_mixer_span():
    """The mixer alone under a checkpoint and its backward: each ATen op
    of the forward has one of the five spans as its nearest span, and the
    recompute enters the five again and runs there the forward's ops (but
    the detaches that save its tensors), or fewer: it stops once the
    backward has what it needs."""
    params, _, _ = h.model()
    p = {k: v[0] for k, v in params["layers"]["mix"].items()}
    x = torch.randn(h.B, h.S, h.CFG.d_model, dtype=h.CFG.cdtype,
                    requires_grad=True)

    def run():
        with torch.profiler.record_function("forward"):
            y = torch.utils.checkpoint.checkpoint(
                lambda t: ssm.mamba_block(p, t, h.CFG), x,
                use_reentrant=False)
        y.float().sum().backward()
    _, ev = h.traced(run)

    def span(e):
        s = h.nearest(e, lambda n: n.startswith(tally.SPAN_PREFIX))
        return None if s is None else s.name
    fwd = [e for e in _aten(ev) if h.nearest(e, lambda n: n == "forward")]
    again = [e for e in _aten(ev) if h.in_backward(e) and span(e)
             and e.name != "aten::detach"]
    assert [span(e) for e in fwd if span(e) not in h.MIXER] == []
    assert {span(e) for e in fwd} == set(h.MIXER)
    assert [e.name for e in ev if e.name in h.MIXER] == list(h.MIXER) * 2
    assert not (collections.Counter((span(e), e.name) for e in again)
                - collections.Counter((span(e), e.name) for e in fwd))
    assert len(again) > 0.9 * len(fwd)


def _top_aten(span):
    """Names of the ATen ops directly in ``span`` (no other ``rt.`` range
    or ATen op between), in order."""
    out = []
    for c in sorted(span.cpu_children, key=lambda e: e.time_range.start):
        if c.name.startswith("aten::"):
            out.append(c.name)
        elif not c.name.startswith(tally.SPAN_PREFIX):
            out.extend(_top_aten(c))
    return out


def test_block_self_time_is_the_pre_norm_and_the_residual_add(
        train_events, prefill_events):
    x = torch.randn(h.B, h.S, h.CFG.d_model, dtype=h.CFG.cdtype)
    scale = torch.ones(h.CFG.d_model, dtype=h.CFG.pdtype)

    _, ev = h.traced(lambda: x + rms_norm(x, scale, h.CFG.norm_eps))
    want = _top_aten(_named(ev, "perfbench.window")[0])
    assert want[-1] == "aten::add" and len(want) > 3
    blocks = _named(train_events, "rt.block") \
        + _named(prefill_events, "rt.block")
    assert len(blocks) == 3 * h.CFG.n_layers
    for b in blocks:
        # the recompute stops before the add, which no backward reads
        assert _top_aten(b) == (want[:-1] if h.in_backward(b) else want)
        kids = sorted((c for c in b.cpu_children
                       if c.name.startswith(tally.SPAN_PREFIX)),
                      key=lambda e: e.time_range.start)
        assert [c.name for c in kids] == list(h.MIXER)


def test_no_profiler_no_span_and_the_same_bits():
    assert not torch.autograd._profiler_enabled()
    assert tally.span("rt.block") is tally.span("rt.ssm.scan")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = tally.span("rt.block")
        assert on is not tally.span("rt.ssm.scan")
    plain = h.train_step(trace=False)
    traced = h.train_step(trace=True)
    for a, b in zip(plain[:3], traced[:3]):
        la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            assert torch.equal(la[k], lb[k]), k
    assert torch.equal(h.prefill(trace=False)[0], h.prefill(trace=True)[0])
