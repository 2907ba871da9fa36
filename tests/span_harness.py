"""A tiny Mamba2 model (the smoke config of mamba2-780m: two layers, each
one checkpoint under remat) traced by ``torch.profiler`` on the CPU: one
prefill pass and one train step, each inside a ``perfbench.window``
range as the benchmark's window is. Shared by the tests of the
program's spans (``test_torch_spans.py``) and of their reduction
(``test_perfbench_spans.py``); not collected."""
import contextlib
import copy

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_smoke
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.optim import AdamWConfig, adamw_init

CFG = get_smoke("mamba2-780m")
B, S = 2, 64
MIXER = ("rt.ssm.in_proj", "rt.ssm.conv", "rt.ssm.scan",
         "rt.ssm.gated_norm", "rt.ssm.out_proj")
EVAL = "autograd::engine::evaluate_function"


@contextlib.contextmanager
def one_thread():
    """One torch thread inside the block (a module-scoped fixture's work,
    which runs before the tests' ``one_torch_thread``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def model(seed: int = 0):
    """(parameters, optimizer state, a train batch) drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    params = init_params(lm.model_decls(CFG), g, "cpu", CFG.pdtype)
    opt = adamw_init(params, AdamWConfig(state_dtype="float32"))
    tok = torch.randint(0, CFG.vocab_size, (B, S + 1), generator=g)
    return params, opt, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def traced(fn):
    """(``fn()``, the profiler's events) of one call of ``fn`` in a
    ``perfbench.window`` range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("perfbench.window"):
            out = fn()
    return out, prof.events()


def train_step(seed: int = 0, trace: bool = True):
    """(params, opt state, the step's output, events or None) after one
    warm step and one more, traced or not."""
    params, opt, batch = model(seed)
    step = make_train_step(CFG, AdamWConfig(state_dtype="float32"),
                           device="cpu")
    params, opt, _ = step(params, opt, batch)

    def run():
        return step(params, opt, copy.copy(batch))
    if not trace:
        return (*run(), None)
    (params, opt, out), ev = traced(run)
    return params, opt, out, ev


def prefill(seed: int = 0, trace: bool = True):
    """(the logits, events or None) of one prefill pass."""
    params, _, batch = model(seed)
    step = make_prefill_step(CFG, device="cpu")

    def run():
        with torch.inference_mode():
            return step(params, {"tokens": batch["tokens"]})
    if not trace:
        return run(), None
    return traced(run)


def ancestors(e):
    e = e.cpu_parent
    while e is not None:
        yield e
        e = e.cpu_parent


def nearest(e, pick):
    """The nearest ancestor of ``e`` whose name ``pick`` accepts, or None."""
    return next((a for a in ancestors(e) if pick(a.name)), None)


def in_backward(e) -> bool:
    return nearest(e, lambda n: n.startswith(EVAL)) is not None
