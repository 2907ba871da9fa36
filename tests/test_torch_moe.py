"""Port Mixture-of-Experts FFN (``models/moe.py``, deepseek v2/v3) vs the JAX
reference's ``moe_ffn`` under a (1, 1) ("data", "model") mesh: the
declarations, the routed expert ids and gates, the kept slots under a
capacity overflow, the output and the aux loss, tied router
probabilities, and the few tokens of a decode step.

Weights are the reference's ``init_params(PRNGKey(0))`` of the MoE
declarations, carried as numpy; inputs are numpy draws from a seed.
The reference runs compiled (``jax.jit``; eager ``shard_map`` takes ~5 s
a call). Tolerances: float32 1e-5 (``tests/test_torch_lm.py``'s FFN), the
aux loss 1e-6 relative; bfloat16 2e-2 of the largest output, the aux
loss 1e-4 relative (compiled, XLA keeps the router's logits in float32
inside its fusion where the port rounds them to bfloat16: 1.4e-6 on the
prefill case). The expert ids are held exactly (against the reference's
routing primitives run op by op), and so are the gates in float32. The
combine adds each token's slots in slot order, as the reference's
scatter-add does; on the CPU the two agree to the tolerances above.
"""
AUX_RTOL = {"float32": 1e-6, "bfloat16": 1e-4}
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.common import tree_leaves, tree_map


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import repro.configs as configs
    import repro.models as models
    from repro.models import moe
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return jax, configs, models, moe, mesh, models.axis_env_for_mesh(mesh)


def _cfgs(jref, dtype="float32", arch="deepseek-v2-236b", **kw):
    configs = jref[1]
    kw = {"param_dtype": dtype, "compute_dtype": dtype, **kw}
    return (configs.get_smoke(arch).replace(**kw),
            tconfigs.get_smoke(arch).replace(**kw))


def _params(jref, rcfg, cfg, seed=0, edit=None):
    """(reference MoE params as jnp arrays, the same in the port); ``edit``
    may change the numpy tree first."""
    jax, _, models, moe, _, ax = jref
    tree = jax.tree.map(np.asarray, models.init_params(
        moe.moe_decls(rcfg, ax), jax.random.PRNGKey(seed), rcfg.pdtype))
    if edit:
        edit(tree)
    ours = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        cfg.pdtype), tree)
    return jax.tree.map(jax.numpy.asarray, tree), ours


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ref_ffn(jref, rcfg, rp, x):
    jax, _, _, moe, mesh, ax = jref
    y, aux = jax.jit(lambda p, xx: moe.moe_ffn(p, xx, rcfg, ax, mesh))(
        rp, jax.numpy.asarray(x, rcfg.cdtype))
    return _np(y), float(aux)


def _port_ffn(cfg, tp, x):
    with torch.inference_mode():
        y, aux = tmoe.moe_ffn(tp, torch.from_numpy(x).to(cfg.cdtype), cfg)
    assert y.dtype == cfg.cdtype and aux.dtype == torch.float32
    return _np(y), float(aux)


def _ref_route(jref, rcfg, router, x):
    """The reference's routing primitives: logits in the compute dtype, the
    float32 softmax, ``jax.lax.top_k`` and the renormalised gates."""
    jax = jref[0]
    jnp = jax.numpy
    xf = jnp.asarray(x, rcfg.cdtype).reshape(-1, rcfg.d_model)
    probs = jax.nn.softmax(
        (xf @ router.astype(rcfg.cdtype)).astype(jnp.float32), axis=-1)
    g, ids = jax.lax.top_k(probs, rcfg.top_k)
    return np.asarray(g / jnp.maximum(g.sum(-1, keepdims=True), 1e-9)), \
        np.asarray(ids)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
@pytest.mark.parametrize("get", ["get_smoke", "get_config"])
def test_moe_decls_match_reference(jref, arch, get):
    configs, moe, ax = jref[1], jref[3], jref[5]
    rcfg, cfg = getattr(configs, get)(arch), getattr(tconfigs, get)(arch)
    for r, c in ((rcfg, cfg), (rcfg.replace(n_shared_experts=0),
                               cfg.replace(n_shared_experts=0))):
        for stack in (None, 2):
            exp = {p: tuple(d.shape) for p, d in tree_leaves(
                moe.moe_decls(r, ax, stack))}
            out = {p: tuple(d.shape) for p, d in tree_leaves(
                tmoe.moe_decls(c, stack))}
            assert out == exp
            assert ("['shared_wi']" in out) == bool(c.n_shared_experts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference_top_k(jref, dtype):
    rcfg, cfg = _cfgs(jref, dtype)
    rp, tp = _params(jref, rcfg, cfg)
    x = _x(cfg, 2, 64)
    g_exp, ids_exp = _ref_route(jref, rcfg, rp["router"], x)
    with torch.inference_mode():
        probs, g, ids = tmoe.route(
            torch.from_numpy(x).to(cfg.cdtype).reshape(-1, cfg.d_model),
            tp["router"], cfg)
    assert probs.dtype == g.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), ids_exp)
    np.testing.assert_allclose(g.numpy(), g_exp, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_router_probabilities_pick_the_lower_id(jref, dtype):
    """Experts 5 and 2 (and 7 and 0) share a router column, so every
    token's probabilities tie exactly between them; ``jax.lax.top_k``
    takes the lower id first, and so must the port."""
    def tie(tree):
        r = tree["router"] = tree["router"].copy()
        r[:, 5], r[:, 7] = r[:, 2], r[:, 0]

    rcfg, cfg = _cfgs(jref, dtype, top_k=3)
    rp, tp = _params(jref, rcfg, cfg, edit=tie)
    x = _x(cfg, 2, 64, seed=1)
    _, ids_exp = _ref_route(jref, rcfg, rp["router"], x)
    with torch.inference_mode():
        _, _, ids = tmoe.route(
            torch.from_numpy(x).to(cfg.cdtype).reshape(-1, cfg.d_model),
            tp["router"], cfg)
    ids = ids.numpy()
    np.testing.assert_array_equal(ids, ids_exp)
    both = (ids == 2).any(-1) & (ids == 5).any(-1)
    assert both.any()                      # the tie is exercised
    y, aux = _port_ffn(cfg, tp, x)
    y_exp, aux_exp = _ref_ffn(jref, rcfg, rp, x)
    if dtype == "float32":
        np.testing.assert_allclose(y, y_exp, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(y - y_exp).max() <= 2e-2 * np.abs(y_exp).max()
    assert aux == pytest.approx(aux_exp, rel=AUX_RTOL[dtype])


def _kept(ids, cpe, C):
    """Independently of the implementation: assignment a (flat over
    (token, k)) is kept when fewer than ``cpe`` earlier assignments went to
    its expert and fewer than ``C`` assignments sort before it by
    (expert, a)."""
    flat = ids.reshape(-1)
    key = np.lexsort((np.arange(flat.size), flat))       # (expert, a)
    sorted_pos = np.empty_like(key)
    sorted_pos[key] = np.arange(flat.size)
    rank = np.array([(flat[:a] == flat[a]).sum() for a in range(flat.size)])
    return (rank < cpe) & (sorted_pos < C)


@pytest.mark.parametrize("B,S,cf", [(2, 64, 1.25), (2, 64, 0.25),
                                    (2, 1, 1.25)],
                         ids=["prefill", "overflow", "decode"])
def test_kept_slots(jref, B, S, cf):
    """The slot grid keeps exactly the assignments of the rule in
    ``_kept``: none dropped at the config's capacity factor, many at 0.25
    (where C = cpe * E also cuts), and all of a decode step's 2 tokens
    (cpe falls to the alignment floor, capped at t * k)."""
    rcfg, cfg = _cfgs(jref, capacity_factor=cf)
    _, tp = _params(jref, rcfg, cfg)
    x = torch.from_numpy(_x(cfg, B, S, seed=2)).reshape(-1, cfg.d_model)
    t, k, E = B * S, cfg.top_k, cfg.n_experts
    cpe = tmoe.expert_capacity(t, cfg)
    with torch.inference_mode():
        _, _, ids = tmoe.route(x, tp["router"], cfg)
        tok, assign, valid = tmoe.slot_grid(ids, cfg)
    assert tok.shape == valid.shape == (E, cpe)
    got = np.zeros(t * k, bool)
    got[assign[valid].numpy()] = True
    assert assign[valid].unique().numel() == int(valid.sum())
    exp = _kept(ids.numpy(), cpe, min(cpe * E, t * k))
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(tok[valid].numpy(),
                                  assign[valid].numpy() // k)
    if cf == 0.25:
        assert (~exp).sum() > t * k // 4     # the overflow drops many
    else:
        assert exp.all()
    if S == 1:
        assert cpe == min(cfg.moe_cap_align, t * k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,cf", [(2, 64, 1.25), (2, 64, 0.25),
                                    (2, 1, 1.25), (3, 1, 1.25)],
                         ids=["prefill", "overflow", "decode", "decode-b3"])
def test_moe_ffn_matches_reference(jref, dtype, B, S, cf):
    rcfg, cfg = _cfgs(jref, dtype, capacity_factor=cf)
    rp, tp = _params(jref, rcfg, cfg, seed=3)
    x = _x(cfg, B, S, seed=4)
    y, aux = _port_ffn(cfg, tp, x)
    y_exp, aux_exp = _ref_ffn(jref, rcfg, rp, x)
    assert y.shape == (B, S, cfg.d_model)
    if dtype == "float32":
        np.testing.assert_allclose(y, y_exp, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(y - y_exp).max() <= 2e-2 * np.abs(y_exp).max()
    assert aux == pytest.approx(aux_exp, rel=AUX_RTOL[dtype])


def test_moe_ffn_without_shared_experts_matches_reference(jref):
    rcfg, cfg = _cfgs(jref, arch="deepseek-v3-671b", n_shared_experts=0)
    rp, tp = _params(jref, rcfg, cfg)
    x = _x(cfg, 2, 32, seed=5)
    y, aux = _port_ffn(cfg, tp, x)
    y_exp, aux_exp = _ref_ffn(jref, rcfg, rp, x)
    np.testing.assert_allclose(y, y_exp, atol=1e-5, rtol=1e-5)
    assert aux == pytest.approx(aux_exp, rel=AUX_RTOL["float32"])


def test_combine_adds_each_tokens_slots_in_slot_order():
    """A token's slots are added one at a time in slot order, in y's
    dtype: with bf16 values whose sum depends on the order, the result is
    the left-to-right sum, and a dropped slot adds nothing."""
    big, small = 256.0, 1.0                 # 256 + 1 rounds back in bf16
    y = torch.tensor([[[big], [0.0]], [[small], [small]],
                      [[-big], [0.0]]], dtype=torch.bfloat16)   # (E=3, 2, 1)
    tok = torch.tensor([[0, 0], [0, 1], [0, 0]])
    valid = torch.tensor([[True, False], [True, True], [True, False]])
    out = tmoe._combine(y, tok, valid, t=2, k=3)
    # token 0: ((256 + 1) + -256) in bf16 = 0; token 1: 1
    assert out.dtype == torch.bfloat16
    assert out[:, 0].tolist() == [0.0, 1.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_moe_ffn_is_bit_repeatable_on_the_card(cuda):
    """Two calls on the same input give the same bits (no atomics in the
    combine); 1,024 tokens, 16 experts, top-4."""
    cfg = tconfigs.get_smoke("deepseek-v2-236b").replace(n_experts=16,
                                                         top_k=4)
    from repro_torch.models import init_params
    dev = cuda
    p = init_params(tmoe.moe_decls(cfg), torch.Generator(dev).manual_seed(0),
                    dev)
    x = torch.randn((4, 256, cfg.d_model), device=dev).to(cfg.cdtype)
    a, aux_a = tmoe.moe_ffn(p, x, cfg)
    b, aux_b = tmoe.moe_ffn(p, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
