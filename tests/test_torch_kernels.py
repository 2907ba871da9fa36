"""Port blocked-ELL SpMM vs the reference Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and the oracles.

Tolerances: the kernel tests' own atol 1e-3 / rtol 1e-4 against the
float64 oracle; format conversion is exact. The CUDA kernel is compared
with its plain version on the card (marked ``cuda``) at atol/rtol 1e-4:
both sum fp32 products, in different orders.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (BlockedEll, csr_to_blocked_ell, ref,
                                 spmm_blocked_ell, spmm_blocked_ell_plain,
                                 spmm_op, to_blocked_ell)
from repro_torch.sparse import csr_from_dense, random_graph_csr


@pytest.fixture(scope="module")
def jref():
    """The JAX reference, imported here so that the ``cuda`` tests of this
    file also run on a machine that has a card and no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.kernels as kernels
    import repro.sparse as sparse
    return types.SimpleNamespace(
        jnp=jnp, oracles=kernels.ref,
        spmm_blocked_ell=kernels.spmm_blocked_ell, spmm_op=kernels.spmm_op,
        to_blocked_ell=kernels.to_blocked_ell,
        csr_to_dense=sparse.csr_to_dense,
        random_graph_csr=sparse.random_graph_csr)


SHAPES = [(256, 256, 128, 0.02), (512, 768, 256, 0.05),
          (256, 512, 128, 0.30), (384, 384, 128, 0.001)]


def _sparse(M, K, density, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    a[rng.random((M, K)) > density] = 0.0
    return a, rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# format conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("n,e,seed", [(256, 1500, 3), (512, 6000, 0),
                                      (1024, 3000, 9)])
def test_csr_to_blocked_ell_matches_dense_conversion(jref, n, e, seed, b):
    ref_blocks, ref_idx = jref.to_blocked_ell(
        jref.csr_to_dense(jref.random_graph_csr(n, e, seed=seed)), b, b)
    blocks, idx = csr_to_blocked_ell(
        random_graph_csr(n, e, seed=seed, device="cpu"), b, b)
    assert blocks.dtype == ref_blocks.dtype and idx.dtype == ref_idx.dtype
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(blocks, ref_blocks)


@pytest.mark.parametrize("M,K,N,density", SHAPES)
def test_csr_to_blocked_ell_on_unstructured_matrices(jref, M, K, N, density):
    a, _ = _sparse(M, K, density, M + N)
    got = csr_to_blocked_ell(csr_from_dense(a, device="cpu"), 128, 128)
    for g, r in zip(got, jref.to_blocked_ell(a, 128, 128)):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(to_blocked_ell(a, 16, 16),
                    jref.to_blocked_ell(a, 16, 16)):
        np.testing.assert_array_equal(g, r)


def test_csr_to_blocked_ell_rejects_ragged_shapes():
    with pytest.raises(ValueError):
        csr_to_blocked_ell(random_graph_csr(100, 300, device="cpu"), 16, 16)


# ---------------------------------------------------------------------------
# SpMM: plain version vs the Pallas kernel and the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N,density", SHAPES)
def test_spmm_plain_matches_pallas_kernel(jref, M, K, N, density):
    jnp = jref.jnp
    a, rng = _sparse(M, K, density, M + N)
    blocks, idx = jref.to_blocked_ell(a, 128, 128)
    x = rng.normal(size=(K, N)).astype(np.float32)
    ref_out = np.asarray(jref.spmm_blocked_ell(
        jnp.asarray(blocks), jnp.asarray(idx), jnp.asarray(x)))
    out = spmm_blocked_ell_plain(_t(blocks), _t(idx), _t(x)).numpy()
    np.testing.assert_allclose(out, ref_out, atol=1e-3, rtol=1e-4)
    exp = a.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(out, exp, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(out, ref.spmm_ref(blocks, idx, x).numpy(),
                               atol=1e-3, rtol=1e-4)
    # the wrapper takes the plain version on a CPU tensor
    np.testing.assert_array_equal(
        spmm_blocked_ell(_t(blocks), _t(idx), _t(x)).numpy(), out)


def test_spmm_ref_matches_reference_oracle(jref):
    a, rng = _sparse(256, 384, 0.08, 7)
    blocks, idx = jref.to_blocked_ell(a, 128, 128)
    x = rng.normal(size=(384, 64)).astype(np.float32)
    np.testing.assert_allclose(ref.spmm_ref(_t(blocks), _t(idx), _t(x)),
                               jref.oracles.spmm_ref(blocks, idx, x),
                               rtol=1e-12)


def test_spmm_empty_block_rows(jref):
    jnp = jref.jnp
    a = np.zeros((256, 256), np.float32)
    a[200, 5] = 3.0      # only the second block-row has data
    blocks, idx = to_blocked_ell(a, 128, 128)
    x = np.ones((256, 64), np.float32)
    out = spmm_blocked_ell(_t(blocks), _t(idx), _t(x)).numpy()
    ref_out = np.asarray(jref.spmm_blocked_ell(
        jnp.asarray(blocks), jnp.asarray(idx), jnp.asarray(x)))
    assert np.all(out[:128] == 0)
    np.testing.assert_allclose(out[200], 3.0)
    np.testing.assert_allclose(out, ref_out, atol=1e-3, rtol=1e-4)


def test_spmm_small_chunks_match_one_chunk():
    a, rng = _sparse(512, 512, 0.05, 4)
    blocks, idx = to_blocked_ell(a, 16, 16)
    x = rng.normal(size=(512, 100)).astype(np.float32)
    one = spmm_blocked_ell_plain(_t(blocks), _t(idx), _t(x))
    many = spmm_blocked_ell_plain(_t(blocks), _t(idx), _t(x), chunk_bytes=1)
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(one.numpy(), a.astype(np.float64) @ x,
                               atol=1e-3, rtol=1e-4)


def test_spmm_op_matches_reference(jref):
    a, rng = _sparse(256, 256, 0.05, 11)
    x = rng.normal(size=(256, 128)).astype(np.float32)
    r = np.asarray(jref.spmm_op(a, jref.jnp.asarray(x)))
    np.testing.assert_allclose(spmm_op(a, _t(x)).numpy(), r, atol=1e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("bad", ["x64", "blocks16", "idx64"])
def test_wrapper_raises_on_unsupported_dtype(bad):
    a, rng = _sparse(128, 128, 0.1, 1)
    blocks, idx = to_blocked_ell(a, 16, 16)
    x = rng.normal(size=(128, 64)).astype(np.float32)
    blocks, idx, x = _t(blocks), _t(idx), _t(x)
    if bad == "x64":
        x = x.double()
    elif bad == "blocks16":
        blocks = blocks.half()
    else:
        idx = idx.long()
    with pytest.raises(TypeError):
        spmm_blocked_ell(blocks, idx, x)


def test_wrapper_raises_on_bad_shapes():
    blocks = torch.zeros((2, 1, 16, 16))
    idx = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        spmm_blocked_ell(blocks, idx, torch.zeros((40, 8)))     # K % bk
    with pytest.raises(ValueError):
        spmm_blocked_ell(blocks, idx[:1], torch.zeros((32, 8)))
    with pytest.raises(ValueError):
        BlockedEll.from_numpy(np.zeros((2, 1, 16, 16), np.float32),
                              np.full((2, 1), 2, np.int32), 32,
                              device="cpu")


# ---------------------------------------------------------------------------
# the CUDA kernel (runs only where there is a card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("N", [64, 100, 128, 256])
def test_cuda_kernel_matches_plain(cuda, b, N):
    a, rng = _sparse(512, 768, 0.05, b + N)
    a[:b] = 0.0                                    # an empty block-row
    blocks, idx = to_blocked_ell(a, b, b)
    x = rng.normal(size=(768, N)).astype(np.float32)
    args = [_t(v).to(cuda) for v in (blocks, idx, x)]
    before = spmm_blocked_ell.launches
    out = spmm_blocked_ell(*args)
    torch.cuda.synchronize()
    assert spmm_blocked_ell.launches == before + 1
    plain = spmm_blocked_ell_plain(*args)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    assert torch.all(out[:b] == 0)
