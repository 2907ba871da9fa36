"""Port sparse substrate vs the reference: same graphs from the same seed,
same SpMM within float32 tolerance (1e-4, the reference's own for SpMM)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.sparse as ref
import repro_torch.sparse as port
from repro.data import table1_graph as ref_table1_graph
from repro.data import table1_features as ref_table1_features
from repro_torch.data import table1_features, table1_graph


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("seed", [0, 1, 3, 7])
@pytest.mark.parametrize("n,e", [(64, 200), (256, 1500), (1000, 9000)])
def test_random_graph_csr_matches_reference(n, e, seed):
    r = ref.random_graph_csr(n, e, seed=seed)
    p = port.random_graph_csr(n, e, seed=seed, device="cpu")
    assert p.shape == r.shape and p.nnz == r.nnz
    np.testing.assert_array_equal(_np(p.indptr), np.asarray(r.indptr))
    np.testing.assert_array_equal(_np(p.indices), np.asarray(r.indices))
    np.testing.assert_array_equal(_np(p.data), np.asarray(r.data))
    assert p.sparsity == pytest.approx(r.sparsity)


def test_unnormalized_graph_matches_reference():
    r = ref.random_graph_csr(128, 700, seed=5, normalized=False)
    p = port.random_graph_csr(128, 700, seed=5, normalized=False,
                              device="cpu")
    np.testing.assert_array_equal(_np(p.data), np.asarray(r.data))


def test_dense_roundtrip_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(48, 80)).astype(np.float32)
    a[rng.random(a.shape) > 0.1] = 0.0
    r = ref.csr_from_dense(a)
    p = port.csr_from_dense(a, device="cpu")
    np.testing.assert_array_equal(_np(p.indptr), np.asarray(r.indptr))
    np.testing.assert_array_equal(_np(p.indices), np.asarray(r.indices))
    np.testing.assert_array_equal(_np(p.data), np.asarray(r.data))
    np.testing.assert_array_equal(port.csr_to_dense(p), ref.csr_to_dense(r))
    np.testing.assert_array_equal(port.csr_to_dense(p), a)


@pytest.mark.parametrize("n,e,f", [(256, 1500, 64), (500, 4000, 128),
                                   (1024, 16384, 128)])
def test_spmm_csr_matches_reference(n, e, f):
    x = np.random.default_rng(n).normal(size=(n, f)).astype(np.float32)
    r = np.asarray(ref.spmm_csr(ref.random_graph_csr(n, e, seed=3),
                                jnp.asarray(x)))
    g = port.random_graph_csr(n, e, seed=3, device="cpu")
    p = _np(port.spmm_csr(g, torch.from_numpy(x)))
    np.testing.assert_allclose(p, r, atol=1e-4, rtol=1e-4)
    d = _np(port.spmm_dense_ref(port.csr_to_dense(g), torch.from_numpy(x)))
    np.testing.assert_allclose(p, d, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,scale", [("OA", 0.01), ("S4", 0.001)])
def test_table1_builders_match_reference(name, scale):
    r = ref_table1_graph(name, scale=scale, seed=1)
    p = table1_graph(name, scale=scale, seed=1, device="cpu")
    np.testing.assert_array_equal(_np(p.indices), np.asarray(r.indices))
    np.testing.assert_array_equal(_np(p.data), np.asarray(r.data))
    np.testing.assert_array_equal(table1_features(name, scale=scale, seed=1),
                                  ref_table1_features(name, scale=scale,
                                                      seed=1))
