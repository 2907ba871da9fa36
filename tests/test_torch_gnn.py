"""Port GCN/GIN vs the reference gcn_forward/gin_forward with the
reference's weights carried across, at V = 256, F = 64, over both sparse
operands (the CSR operand of the serving path and blocked-ELL; each
kernel's plain version on the CPU), atol/rtol 1e-4: float32 sums in
another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models.gnn import (gcn_forward, gin_forward, init_gcn_params as
                              ref_init_gcn, init_gin_params as ref_init_gin)
from repro.sparse import random_graph_csr as ref_random_graph_csr
from repro_torch.kernels import BlockedEll, CsrOperand
from repro_torch.models import (GCN, GIN, gcn_params_from_numpy,
                                gin_params_from_numpy, init_gcn_params,
                                init_gin_params)
from repro_torch.sparse import random_graph_csr

V, E, F = 256, 1500, 64


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    x = np.random.default_rng(0).normal(size=(V, F)).astype(np.float32)
    g_ref = ref_random_graph_csr(V, E, seed=3)
    g = random_graph_csr(V, E, seed=3, device="cpu")
    return x, g_ref, g


def _operand(g, b):
    """``b`` None: the CSR operand; else blocked-ELL with bm = bk = b."""
    if b is None:
        return CsrOperand.from_csr(g, device="cpu")
    return BlockedEll.from_csr(g, b, b, device="cpu")


@pytest.mark.parametrize("b", [16, 128, None], ids=["16", "128", "csr"])
def test_gcn_matches_reference(inputs, b):
    x, g_ref, g = inputs
    params = ref_init_gcn(jax.random.PRNGKey(1), F, 128)
    exp = np.asarray(gcn_forward(params, g_ref, jnp.asarray(x)))
    model = GCN(gcn_params_from_numpy(_to_numpy(params), device="cpu"))
    adj = _operand(g, b)
    out = model(adj, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, exp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("eps,b", [(0.0, 16), (0.25, 16), (0.0, None),
                                   (0.25, None)],
                         ids=["0.0", "0.25", "csr-0.0", "csr-0.25"])
def test_gin_matches_reference(inputs, eps, b):
    x, g_ref, g = inputs
    params = ref_init_gin(jax.random.PRNGKey(2), F, 128)
    params = [dict(p, eps=jnp.float32(eps)) for p in params]
    exp = np.asarray(gin_forward(params, g_ref, jnp.asarray(x)))
    model = GIN(gin_params_from_numpy(_to_numpy(params), device="cpu"))
    adj = _operand(g, b)
    out = model(adj, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, exp, atol=1e-4, rtol=1e-4)


def test_init_params_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    gcn = init_gcn_params(F, 128, generator=gen, device="cpu")
    ref = ref_init_gcn(jax.random.PRNGKey(0), F, 128)
    assert [p["theta"].shape for p in gcn] == \
        [tuple(p["theta"].shape) for p in ref]
    # Glorot-scaled normal: std (2 / (d_in + hidden)) ** 0.5
    assert float(gcn[0]["theta"].std()) == pytest.approx(
        (2.0 / (F + 128)) ** 0.5, rel=0.05)
    gin = init_gin_params(F, 128, generator=gen, device="cpu")
    ref = ref_init_gin(jax.random.PRNGKey(0), F, 128)
    assert [[tuple(w.shape) for w in p["mlp"]] for p in gin] == \
        [[tuple(w.shape) for w in p["mlp"]] for p in ref]
    again = init_gcn_params(F, 128, generator=torch.Generator()
                            .manual_seed(0), device="cpu")
    assert torch.equal(again[0]["theta"], gcn[0]["theta"])
