"""The port's training path vs the JAX reference at smoke size: ``lm_loss``
and every gradient against ``jax.grad`` of the reference's ``lm_loss``
(full attention through the flash custom VJP; sliding-window attention
through the banded op's backward; deepseek's MLA and routed experts with
the router's aux term; the vlm and encdec losses; the ssm and hybrid
losses through the SSD chunk scan), the train step over
three steps with and without gradient accumulation against the
reference's ``make_train_step``, the train CLI on the CPU, and the SSD's
autograd on either device (the restart replays of the train loop and of
the example are in tests/test_torch_train_restart.py).

The reference runs compiled under a (1, 1) ("data", "model") mesh of
automatic axes (its MoE layer is a ``shard_map``), in float32, on its
``init_params(PRNGKey(0))`` carried with ``lm_params_from_numpy`` (every
leaf it initialises to ones redrawn as 1 + 0.2 * normal, so that a norm's
gradient shows). Tokens and labels are ``synthetic_batch`` draws, the
family extras numpy normal draws. Tolerances: the loss within 1e-5
relative and each gradient within 1e-4 of its leaf's largest element (the
same math in another order); after three AdamW steps the parameters
within 1e-5 of each leaf's largest.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401

import lm_decode_harness as h
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic_batch
from repro_torch.kernels import ssd_chunked
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm_loss, lm_params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4


@pytest.fixture(scope="module")
def jref():
    ns = h.load_jref()
    ns.mesh = ns.jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        ns.jax.sharding.AxisType.Auto,) * 2)
    ns.ax = ns.models.axis_env_for_mesh(ns.mesh)
    from repro.models import lm as rlm
    from repro import optim
    ns.lm, ns.optim = rlm, optim
    return ns


def _cfgs(jref, arch, **kw):
    kw = {"param_dtype": "float32", "compute_dtype": "float32", **kw}
    return (jref.configs.get_smoke(arch).replace(**kw),
            tconfigs.get_smoke(arch).replace(**kw))


def _carried(jref, rcfg, cfg, seed=0):
    """(reference params as jnp arrays, the same params in the port)."""
    jax = jref.jax
    tree = jax.tree.map(np.asarray, jref.models.init_params(
        jref.models.model_decls(rcfg, jref.ax), jax.random.PRNGKey(seed),
        rcfg.pdtype))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: (1 + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim <= 2 and (a == 1).all() else a, tree)
    return (jax.tree.map(jref.jnp.asarray, tree),
            lm_params_from_numpy(tree, cfg, device="cpu"))


def _batch(cfg, B, S, step=0):
    """A numpy batch: synthetic tokens and labels (S text positions) and
    the family's extra."""
    b = synthetic_batch(step, B, S, cfg.vocab_size)
    rng = np.random.default_rng(step + 7)
    if cfg.family == "vlm":
        b["prefix_embeds"] = rng.normal(
            size=(B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        b["src_frames"] = rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32)
    return b


def _ref_loss_and_grads(jref, rcfg, rp, batch):
    jb = {k: jref.jnp.asarray(v) for k, v in batch.items()}
    fn = jref.jax.jit(jref.jax.value_and_grad(
        lambda p: jref.lm.lm_loss(p, jb, rcfg, jref.ax, jref.mesh)))
    loss, grads = fn(rp)
    return float(loss), {k: np.asarray(g) for k, g in
                         tree_leaves(jref.jax.tree.map(np.asarray, grads))}


def _port_loss_and_grads(cfg, tp, batch):
    leaves = [t for _, t in tree_leaves(tp)]
    for t in leaves:
        t.requires_grad_(True)
    loss = lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                   cfg)
    loss.backward()
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
             .numpy() for k, t in tree_leaves(tp)}
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch,kw,S", [
    ("qwen3-4b", {}, 128),                                  # flash VJP
    ("qwen3-4b", {"attention": "swa", "window": 32}, 128),  # banded backward
    ("deepseek-v2-236b", {}, 64),                           # MLA, MoE + aux
    ("paligemma-3b", {}, 120),                              # vlm: text only
    ("seamless-m4t-large-v2", {}, 64),                      # encdec
    ("mamba2-780m", {}, 128),                               # ssm: SSD scan
    ("zamba2-7b", {}, 64),                                  # hybrid
], ids=["qwen3-full", "qwen3-swa", "deepseek-aux", "paligemma-vlm",
        "seamless-encdec", "mamba2-ssm", "zamba2-hybrid"])
def test_lm_loss_and_gradients_match_jax_grad(jref, arch, kw, S):
    rcfg, cfg = _cfgs(jref, arch, **kw)
    rp, tp = _carried(jref, rcfg, cfg)
    batch = _batch(cfg, 2, S)
    rloss, rgrads = _ref_loss_and_grads(jref, rcfg, rp, batch)
    tloss, tgrads = _port_loss_and_grads(cfg, tp, batch)
    assert np.isfinite(tloss)
    assert tloss == pytest.approx(rloss, rel=LOSS_RTOL)
    assert tgrads.keys() == rgrads.keys()
    for k, r in rgrads.items():
        t = tgrads[k]
        assert t.shape == r.shape, k
        assert np.abs(t - r).max() <= GRAD_SHARE * np.abs(r).max() + 1e-12, \
            (k, float(np.abs(t - r).max()), float(np.abs(r).max()))


def test_moe_aux_loss_reaches_the_loss(jref):
    """deepseek's loss carries router_aux_weight times the routers' summed
    aux: with the weight at 0 the loss falls by exactly that term."""
    _, cfg = _cfgs(jref, "deepseek-v2-236b")
    _, tp = _carried(jref, *_cfgs(jref, "deepseek-v2-236b"))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 64).items()}
    with torch.no_grad():
        full = lm_loss(tp, b, cfg)
        bare = lm_loss(tp, b, cfg.replace(router_aux_weight=0.0))
        from repro_torch.models.lm import _forward
        _, aux = _forward(tp, b["tokens"], cfg)
    assert float(aux) > 0
    torch.testing.assert_close(full - bare, cfg.router_aux_weight * aux,
                               atol=1e-6, rtol=1e-5)


def test_mask_and_remat_do_not_change_the_gradient(jref):
    """``remat`` off gives the same loss and gradients as on (the layer
    bodies recomputed in the backward); a mask of zeros over half the
    positions gives the masked mean."""
    _, cfg = _cfgs(jref, "qwen3-4b", attention="swa", window=32)
    _, tp = _carried(jref, *_cfgs(jref, "qwen3-4b", attention="swa",
                                  window=32))
    batch = _batch(cfg, 2, 128)
    on = _port_loss_and_grads(cfg, tp, batch)
    for t in (t for _, t in tree_leaves(tp)):
        t.grad = None
    off = _port_loss_and_grads(cfg.replace(remat=False), tp, batch)
    assert on[0] == pytest.approx(off[0], rel=1e-6)
    for k in on[1]:
        np.testing.assert_allclose(on[1][k], off[1][k], atol=1e-6)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    mask = torch.zeros(2, 128)
    mask[:, :64] = 1
    with torch.no_grad():
        half = lm_loss(tp, {**b, "mask": mask}, cfg)
        first = lm_loss(tp, {k: v[:, :64] for k, v in b.items()}, cfg)
    torch.testing.assert_close(half, first, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_reference(jref, accum):
    rcfg, cfg = _cfgs(jref, "qwen3-4b", attention="swa", window=32,
                      grad_accum=accum)
    rp, tp = _carried(jref, rcfg, cfg)
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    ropt = jref.optim.adamw_init(rp, jref.optim.AdamWConfig(
        state_dtype=rcfg.opt_state_dtype))
    topt = adamw_init(tp, ocfg)
    rstep = jref.jax.jit(jref.steps.make_train_step(rcfg, jref.ax,
                                                    jref.mesh))
    tstep = make_train_step(cfg, ocfg, device="cpu")
    for step in range(3):
        batch = _batch(cfg, 4, 128, step)
        rp, ropt, rm = rstep(rp, ropt, {k: jref.jnp.asarray(v)
                                        for k, v in batch.items()})
        tp, topt, tm = tstep(tp, topt, batch)
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_RTOL)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=LOSS_RTOL)
    assert int(topt["step"]) == 3
    for (k, t), r in zip(tree_leaves(tp), jref.jax.tree.leaves(rp)):
        r = np.asarray(r)
        assert not t.requires_grad and t.grad is None
        assert np.abs(t.numpy() - r).max() <= 1e-5 * np.abs(r).max(), k


def test_train_cli_smoke_on_cpu(capsys):
    train_cli.main(["--arch", "qwen3-4b", "--smoke", "--steps", "6",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out
    assert "[train] step     5 loss" in out
    assert "[train] done" in out


def test_train_cli_smoke_on_cpu_ssm(capsys):
    """The ssm family through the same CLI: mamba2-780m's smoke config,
    the plain SSD scan differentiated on the CPU."""
    train_cli.main(["--arch", "mamba2-780m", "--smoke", "--steps", "6",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] mamba2-780m (smoke)" in out
    assert "[train] step     5 loss" in out
    assert "[train] done" in out


def test_layers_split_each_stacked_leaf_once():
    """The forward hands layer i the i-th piece of one ``unbind`` a stacked
    leaf: a leaf's pieces share one backward node, which stacks their
    gradients once (a ``t[i]`` view a layer would add a zero-filled
    gradient of the whole leaf for each layer), and the gradient is the
    same."""
    from repro_torch.models import lm
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, 5, generator=g, requires_grad=True),
            "b": {"c": torch.randn(3, 6, generator=g, requires_grad=True)}}
    layers = lm._layers(tree)
    assert len(layers) == 3 and lm._layers(None) == []
    for leaf in (lambda t: t["a"], lambda t: t["b"]["c"]):
        nodes = {leaf(lp).grad_fn for lp in layers}
        assert len(nodes) == 1
        assert type(nodes.pop()).__name__.startswith("UnbindBackward")
    w = torch.arange(3.0)
    sum(w[i] * (lp["a"].sum() + lp["b"]["c"].square().sum())
        for i, lp in enumerate(layers)).backward()
    torch.testing.assert_close(tree["a"].grad,
                               w[:, None, None].expand(3, 4, 5),
                               rtol=0, atol=0)
    torch.testing.assert_close(tree["b"]["c"].grad,
                               2 * w[:, None] * tree["b"]["c"].detach(),
                               rtol=0, atol=0)


def test_ssd_stays_differentiable_on_the_cpu():
    """On the CPU the plain chunk scan is differentiable by autograd (the
    ssm parity tests rely on it)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, 2, 16, generator=g, requires_grad=True)
    dt = torch.randn(1, 64, 2, generator=g)
    B, C = (torch.randn(1, 64, 8, generator=g) for _ in range(2))
    y, s = ssd_chunked(x, dt, B, C, torch.zeros(2), torch.ones(2), chunk=32)
    (y.sum() + s.sum()).backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_under_grad_runs_the_backward_kernel(cuda, dtype):
    """On the card the chunk scan under grad runs its routed forward and,
    in the backward, each launch of the route ``_bwd_route`` names once
    (``csrc/ssd_chunk_bwd_tc.cu`` in bf16, ``csrc/ssd_chunk_bwd.cu`` in
    float32); x's gradient equals the plain backward's (float32 within
    1e-4 of its largest, bf16 one ulp of the plain float32 backward
    rounded once)."""
    from repro_torch.kernels import ssd
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, 256, 2, 64, generator=g, device=cuda,
                    dtype=dtype, requires_grad=True)
    dt = torch.randn(1, 256, 2, generator=g, device=cuda)
    B, C = (torch.randn(1, 256, 64, generator=g, device=cuda,
                        dtype=dtype) for _ in range(2))
    A_log, D = torch.zeros(2, device=cuda), torch.ones(2, device=cuda)
    dy = torch.randn(1, 256, 2, 64, generator=g, device=cuda, dtype=dtype)
    fns = ssd._BWD_KERNELS[ssd._bwd_route(dtype, 64, 64, 128)]
    before = [f.launches for f in fns]
    y, s = ssd_chunked(x, dt, B, C, A_log, D, chunk=128)
    assert y.requires_grad and torch.isfinite(y).all()
    y.backward(dy)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1] * len(fns)
    dts, da = ssd._discretize(dt, A_log)
    exp = ssd.ssd_chunked_bwd_plain(x.detach(), dts, da, B, C, D, dy,
                                    chunk=128)[0]
    if dtype == torch.bfloat16:
        torch.testing.assert_close(x.grad, exp.to(dtype), atol=1e-5,
                                   rtol=2 ** -7)
    else:
        err = float((x.grad - exp).abs().max())
        assert err <= 1e-4 * float(exp.abs().max())
