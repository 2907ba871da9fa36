"""The plain reference against the program on the CPU at the program's
smoke sizes, in float32: the forward, the loss and its gradients, the
SSD scan and AdamW. The reference itself imports nothing of the
program; these tests import both sides."""
import ast
import dataclasses

import pytest
import torch

import harness
import weights
from reference import lm as ref
from reference import train as ref_train
from conftest import configs

ARCHS = [c["name"] for c in configs()]


def _f32(arch):
    from repro_torch.configs import get_smoke
    cfg = get_smoke(arch).replace(param_dtype="float32",
                                  compute_dtype="float32")
    return cfg, dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_the_programs(arch):
    from repro_torch.launch.steps import make_prefill_step
    cfg, d = _f32(arch)
    p = weights.make(d, 11, "cpu", torch.float32)
    tok = weights.token_pool(11, 1, 2, 128, d["vocab_size"], "cpu")[0]
    got = make_prefill_step(cfg, device="cpu")(p, {"tokens": tok})[:, 0]
    want = ref.last_logits(p, tok, d)
    # float32 sums taken in other orders (threads, chunks): ~1e-6 apart
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_the_programs(arch):
    from repro_torch.models import lm
    cfg, d = _f32(arch)
    tok = weights.token_pool(12, 1, 2, 128, d["vocab_size"], "cpu")[0]
    lab = torch.roll(tok, -1, 1)
    sides = []
    for fn in (lambda p: lm.lm_loss(p, {"tokens": tok, "labels": lab}, cfg),
               lambda p: ref.loss_sum(p, tok, lab, d) / tok.numel()):
        p = weights.make(d, 12, "cpu", torch.float32)
        flat = dict(weights.leaves(p))
        for t in flat.values():
            t.requires_grad_(True)
        loss = fn(p)
        loss.backward()
        sides.append((float(loss.detach()),
                      {k: t.grad for k, t in flat.items()}))
    (l0, g0), (l1, g1) = sides
    assert l0 == pytest.approx(l1, rel=1e-6)
    for k in g0:
        assert (g0[k] - g1[k]).abs().max() <= 1e-4 * g1[k].abs().max() \
            + 1e-9, k


def test_ssd_equals_the_programs_plain_scan():
    from repro_torch.kernels.ssd import ssd_chunked_plain
    g = torch.Generator().manual_seed(3)
    b, L, H, P, N = 2, 256, 3, 8, 16
    x = torch.randn(b, L, H, P, generator=g)
    dt = torch.randn(b, L, H, generator=g)
    B, C = (torch.randn(b, L, N, generator=g) for _ in range(2))
    A_log, D = torch.randn(H, generator=g), torch.randn(H, generator=g)
    want, _ = ssd_chunked_plain(x, dt, B, C, A_log, D, chunk=64)
    got = ref.ssd(x, dt, B, C, A_log, D, 64)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_adamw_equals_the_programs():
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    mix = harness.load_cell("mamba2-780m.train-16x4k").mix
    g = torch.Generator().manual_seed(4)
    params = {"a": (torch.randn(3, 64, 32, generator=g) * 1e-3)
              .bfloat16(), "b": torch.ones(40, dtype=torch.bfloat16)}
    ocfg = AdamWConfig(**mix["optimizer"])
    state = adamw_init(params, ocfg)
    p = {k: t.float().clone() for k, t in params.items()}
    mu = {k: torch.zeros_like(t) for k, t in p.items()}
    nu = {k: torch.zeros_like(t) for k, t in p.items()}
    from repro_torch.optim import cosine_schedule
    for k in range(3):
        grads = {n: torch.randn(t.shape, generator=g) for n, t in p.items()}
        adamw_update(params, grads, state, ocfg,
                     cosine_schedule(state["step"] - 0, **mix["schedule"]))
        ref_train.adamw_step(p, grads, mu, nu, k, mix["optimizer"],
                             mix["schedule"])
        for n in p:
            assert torch.equal(params[n].float(), p[n]), (k, n)
            assert torch.allclose(state["mu"][n], mu[n], rtol=1e-6)


def test_fp8_control_differs():
    cfg, d = _f32("mamba2-780m")
    p = weights.make(d, 13, "cpu", torch.float32)
    tok = weights.token_pool(13, 1, 1, 64, d["vocab_size"], "cpu")[0]
    a = ref.last_logits(p, tok, d)
    b = ref.last_logits(p, tok, d, "fp8")
    assert 1e-3 < float((a - b).abs().max() / a.abs().max()) < 0.5


def test_change_gap_reads_each_leaf_against_the_moving_median():
    """A leaf moved by one element's rounding on one side reads little
    against the median change of the leaves that move; a large leaf left
    unmoved reads 1; leaves neither side moves read 0."""
    grad = {n: torch.ones(4) for n in ("big", "mid", "small", "still")}
    ref_change = {"big": 0.03, "mid": 0.002, "small": 7.6e-6, "still": 0.0}

    def change_gap(**prog):
        got = {"grad": grad, "change": dict(ref_change, **prog)}
        return ref_train.gaps(got, {"grad": grad, "change": ref_change}
                              )["change_gap"]
    assert change_gap() == 0.0
    assert change_gap(small=0.0) == pytest.approx(7.6e-6 / 0.002)
    assert change_gap(big=0.0) == pytest.approx(1.0)
    assert change_gap(mid=0.001) == pytest.approx(0.5)
    assert change_gap(big=0.033) == pytest.approx(0.1)


@pytest.mark.parametrize("folder", ["reference", "families"])
def test_reference_imports_nothing_of_the_program(folder):
    banned = ("repro", "repro_torch", "jax") + (
        ("weights",) if folder == "reference" else ())
    for path in (harness.HERE / folder).glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)
