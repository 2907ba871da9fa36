"""Port SpMM (blocked-ELL and row-wise CSR) vs the reference Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and the oracles.

Tolerances: the kernel tests' own atol 1e-3 / rtol 1e-4 against the
float64 oracle; the CSR plain version against the Pallas kernel at
atol/rtol 1e-4 (tests/test_kernels.py:89-143's, both float32); format
conversion is exact. The CUDA kernels are compared with their plain
versions on the card (marked ``cuda``) at atol/rtol 1e-4: both sum fp32
products, in different orders.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (BlockedEll, CsrOperand, csr_to_blocked_ell,
                                 ref, spmm_blocked_ell, spmm_blocked_ell_plain,
                                 spmm_csr_rows, spmm_csr_rows_plain, spmm_op,
                                 to_blocked_ell)
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
# row-wise CSR SpMM: the operand, the plain version and the wrapper
# ---------------------------------------------------------------------------
CSR_SHAPES = [(256, 256, 128, 0.02), (256, 384, 100, 0.08),
              (512, 768, 256, 0.05), (384, 256, 64, 0.30),
              (128, 512, 100, 0.001)]


def _csr_args(op):
    return op.indptr, op.indices, op.values


@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("M,K,N,density", CSR_SHAPES)
def test_spmm_csr_rows_plain_matches_pallas_kernel(jref, M, K, N, density,
                                                   b):
    jnp = jref.jnp
    a, rng = _sparse(M, K, density, M + K + N)
    x = rng.normal(size=(K, N)).astype(np.float32)
    blocks, idx = jref.to_blocked_ell(a, b, b)
    ref_out = np.asarray(jref.spmm_blocked_ell(
        jnp.asarray(blocks), jnp.asarray(idx), jnp.asarray(x),
        interpret=True))
    op = CsrOperand.from_csr(csr_from_dense(a, device="cpu"), device="cpu")
    assert op.shape == (M, K) and op.indptr.dtype == torch.int32
    out = spmm_csr_rows_plain(*_csr_args(op), _t(x)).numpy()
    np.testing.assert_allclose(out, ref_out, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out, a.astype(np.float64) @ x, atol=1e-4,
                               rtol=1e-4)
    # the wrapper and the operand take the plain version on a CPU tensor
    np.testing.assert_array_equal(
        spmm_csr_rows(*_csr_args(op), _t(x)).numpy(), out)
    np.testing.assert_array_equal((op @ _t(x)).numpy(), out)


@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("n,e,seed", [(256, 1500, 3), (1024, 3000, 9)])
def test_csr_operand_from_blocked_ell_matches_from_csr(n, e, seed, b):
    g = random_graph_csr(n, e, seed=seed, device="cpu")
    blocks, idx = csr_to_blocked_ell(g, b, b)
    a = CsrOperand.from_blocked_ell(blocks, idx, n, device="cpu")
    c = CsrOperand.from_csr(g, device="cpu")
    assert a.shape == c.shape == (n, n) and a.nnz == c.nnz == g.nnz
    for f in ("indptr", "indices", "values"):
        assert getattr(a, f).dtype == getattr(c, f).dtype
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    assert c.nbytes == (n + 1) * 4 + g.nnz * 8


def test_csr_operand_from_blocked_ell_sums_repeated_tiles():
    blocks = np.zeros((1, 3, 16, 16), np.float32)
    blocks[0, 0, 2, 3] = 1.5
    blocks[0, 1, 2, 3] = 2.0              # the same tile again: summed
    blocks[0, 2, 0, 1] = -1.0
    op = CsrOperand.from_blocked_ell(blocks, np.array([[1, 1, 0]]), 32,
                                     device="cpu")
    x = torch.arange(32 * 3, dtype=torch.float32).reshape(32, 3)
    np.testing.assert_allclose(
        (op @ x).numpy(), ref.spmm_ref(blocks, np.array([[1, 1, 0]]), x),
        rtol=1e-6)
    assert op.indices.tolist() == [1, 19] and op.values.tolist() == [-1, 3.5]


@pytest.mark.parametrize("N", [64, 100])
def test_spmm_csr_rows_empty_rows_and_long_row(N):
    rng = np.random.default_rng(N)
    a = np.zeros((96, 512), np.float32)
    a[5, rng.choice(512, 300, replace=False)] = rng.normal(size=300)
    a[40, 7] = 2.0
    a[95, :33] = rng.normal(size=33)      # one more than a warp's batch
    x = rng.normal(size=(512, N)).astype(np.float32)
    op = CsrOperand.from_csr(csr_from_dense(a, device="cpu"), device="cpu")
    out = (op @ _t(x)).numpy()
    empty = np.abs(a).sum(axis=1) == 0
    assert empty.sum() == 93 and np.all(out[empty] == 0)
    np.testing.assert_allclose(out, a.astype(np.float64) @ x, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("bad,exc", [
    ("indices64", TypeError), ("indptr64", TypeError),
    ("values64", TypeError), ("x64", TypeError),
    ("x_noncontiguous", ValueError), ("mixed_devices", ValueError),
    ("nnz_mismatch", ValueError)])
def test_csr_wrapper_raises(bad, exc):
    a, rng = _sparse(64, 96, 0.1, 2)
    op = CsrOperand.from_csr(csr_from_dense(a, device="cpu"), device="cpu")
    indptr, indices, values = _csr_args(op)
    x = _t(rng.normal(size=(96, 32)).astype(np.float32))
    if bad == "indices64":
        indices = indices.long()
    elif bad == "indptr64":
        indptr = indptr.long()
    elif bad == "values64":
        values = values.double()
    elif bad == "x64":
        x = x.double()
    elif bad == "x_noncontiguous":
        x = _t(rng.normal(size=(32, 96)).astype(np.float32)).t()
    elif bad == "mixed_devices":
        x = x.to("meta")
    else:
        values = values[:-1]
    with pytest.raises(exc):
        spmm_csr_rows(indptr, indices, values, x)


def test_csr_operand_rejects_bad_input():
    with pytest.raises(ValueError):          # K does not fit int32
        CsrOperand.from_numpy(np.zeros(2, np.int64), np.zeros(0, np.int64),
                              np.zeros(0, np.float32), (1, 2**31),
                              device="cpu")
    with pytest.raises(ValueError):          # column out of range
        CsrOperand.from_numpy(np.array([0, 1]), np.array([4]),
                              np.ones(1, np.float32), (1, 4), device="cpu")
    with pytest.raises(ValueError):          # indptr does not end at nnz
        CsrOperand.from_numpy(np.array([0, 2]), np.array([0]),
                              np.ones(1, np.float32), (1, 4), device="cpu")
    with pytest.raises(ValueError):          # idx out of range
        CsrOperand.from_blocked_ell(np.ones((1, 1, 16, 16), np.float32),
                                    np.full((1, 1), 2), 32, device="cpu")
    op = CsrOperand.from_csr(csr_from_dense(np.eye(16, dtype=np.float32),
                                            device="cpu"), device="cpu")
    with pytest.raises(ValueError):          # x rows != K
        op @ torch.zeros((15, 4))


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


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 100, 128, 256])
def test_cuda_csr_kernel_matches_plain(cuda, N):
    a, rng = _sparse(300, 700, 0.05, N)
    a[:17] = 0.0                                   # empty rows
    a[200, :600] = rng.normal(size=600)            # a row of 600 non-zeros
    x = rng.normal(size=(700, N)).astype(np.float32)
    op = CsrOperand.from_csr(csr_from_dense(a, device="cpu"), device=cuda)
    xc = _t(x).to(cuda)
    before = spmm_csr_rows.launches
    out = op @ xc
    again = op @ xc
    torch.cuda.synchronize()
    assert spmm_csr_rows.launches == before + 2
    assert torch.equal(out, again)                 # no atomics
    plain = spmm_csr_rows_plain(*_csr_args(op), xc)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    assert torch.all(out[:17] == 0)
