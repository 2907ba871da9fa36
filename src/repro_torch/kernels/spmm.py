"""SpMM: the host-side formats and the hand-written Hopper kernels.

Two kernels compute ``out = A @ X`` for a sparse A and a dense float32 X:

* ``spmm_csr_rows`` (``csrc/spmm_csr_rows.cu``) reads A as CSR, its
  non-zeros in row order, one warp per output row. It is the GCN path's
  SpMM (``ops.CsrOperand``).
* ``spmm_blocked_ell`` (``csrc/spmm_blocked_ell.cu``) takes the TPU
  kernel's literal operand: each (bm x bk) tile with any non-zero stored
  densely, padded to a fixed number of tiles per block-row (the ELL
  width); padding tiles point at column block 0 with zero values.
  ``csr_to_blocked_ell`` builds it straight from CSR, without the dense
  matrix (which at ogbn-arxiv size would be 170,000² floats).

Each wrapper launches its kernel on a CUDA tensor and uses its plain
PyTorch version (``*_plain``) on a CPU tensor; it never falls back from one
to the other. ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..sparse import CSR, spmm_csr
from . import _build

KERNEL_BM = (16, 32, 64, 128)    # tile heights the CUDA kernel is built for
KERNEL_KC = 16                   # bk must be a multiple of this
PLAIN_CHUNK_BYTES = 256 << 20    # bound on the gathered X slabs per chunk


# ---------------------------------------------------------------------------
# format conversion (host-side, numpy)
# ---------------------------------------------------------------------------
def to_blocked_ell(a_dense: np.ndarray, bm: int = 128, bk: int = 128):
    """Dense (M, K) -> (blocks (nbr, ell, bm, bk), idx (nbr, ell) int32).
    ell = max non-empty column-blocks over the block-rows."""
    M, K = a_dense.shape
    assert M % bm == 0 and K % bk == 0, (M, K, bm, bk)
    nbr, nbc = M // bm, K // bk
    tiles = a_dense.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
    nonzero = np.abs(tiles).sum(axis=(2, 3)) > 0          # (nbr, nbc)
    ell = max(int(nonzero.sum(axis=1).max()), 1)
    blocks = np.zeros((nbr, ell, bm, bk), a_dense.dtype)
    idx = np.zeros((nbr, ell), np.int32)
    for r in range(nbr):
        cols = np.nonzero(nonzero[r])[0]
        for e, c in enumerate(cols):
            blocks[r, e] = tiles[r, c]
            idx[r, e] = c
    return blocks, idx


def csr_to_blocked_ell(csr, bm: int = 16, bk: int = 16):
    """CSR -> the same ``(blocks, idx)`` as
    ``to_blocked_ell(csr_to_dense(csr), bm, bk)``, without the dense matrix.

    A tile is non-empty iff it holds a non-zero value; column blocks come in
    ascending order within a block-row; padding slots keep idx 0 and zero
    values. Entries are assumed unique per (row, column), as
    ``random_graph_csr`` and ``csr_from_dense`` make them."""
    M, K = csr.shape
    if M % bm or K % bk:
        raise ValueError(f"shape {(M, K)} is not a multiple of {(bm, bk)}")
    nbr, nbc = M // bm, K // bk
    indptr = csr.indptr.cpu().numpy()
    cols = csr.indices.cpu().numpy().astype(np.int64)
    vals = csr.data.cpu().numpy().astype(np.float32)
    rows = np.repeat(np.arange(M, dtype=np.int64), np.diff(indptr))
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    key = (rows // bm) * nbc + cols // bk                 # tile id
    tiles, pos = np.unique(key, return_inverse=True)      # sorted by (r, c)
    tile_r, tile_c = tiles // nbc, tiles % nbc
    slot = np.arange(len(tiles)) - np.searchsorted(tile_r, tile_r)
    per_row = np.bincount(tile_r, minlength=nbr)
    ell = max(int(per_row.max()) if nbr else 0, 1)
    blocks = np.zeros((nbr, ell, bm, bk), np.float32)
    idx = np.zeros((nbr, ell), np.int32)
    idx[tile_r, slot] = tile_c
    blocks[tile_r[pos], slot[pos], rows % bm, cols % bk] = vals
    return blocks, idx


# ---------------------------------------------------------------------------
# blocked-ELL SpMM: plain PyTorch version and the kernel's wrapper
# ---------------------------------------------------------------------------
def _check(blocks, idx, x):
    if blocks.dim() != 4 or idx.dim() != 2 or x.dim() != 2:
        raise ValueError("want blocks (nbr, ell, bm, bk), idx (nbr, ell), "
                         f"x (K, N); got {tuple(blocks.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(x.shape)}")
    nbr, ell, bm, bk = blocks.shape
    if tuple(idx.shape) != (nbr, ell):
        raise ValueError(f"idx {tuple(idx.shape)} != {(nbr, ell)}")
    if x.shape[0] % bk:
        raise ValueError(f"K={x.shape[0]} is not a multiple of bk={bk}")
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"float32 only; got blocks {blocks.dtype}, "
                        f"x {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not (blocks.device == idx.device == x.device):
        raise ValueError("blocks, idx and x must be on one device")


def spmm_blocked_ell_plain(blocks, idx, x, *,
                           chunk_bytes: int = PLAIN_CHUNK_BYTES):
    """Plain PyTorch version: gather the X slabs by idx, einsum over e, in
    chunks of block-rows so the gathered slabs stay under ``chunk_bytes``
    (unchunked they would be ~12 GB at ogbn-arxiv size)."""
    nbr, ell, bm, bk = blocks.shape
    K, N = x.shape
    xs = x.reshape(K // bk, bk, N)
    out = torch.empty((nbr * bm, N), dtype=x.dtype, device=x.device)
    step = max(1, chunk_bytes // max(1, ell * bk * N * x.element_size()))
    for r0 in range(0, nbr, step):
        r1 = min(r0 + step, nbr)
        slabs = xs[idx[r0:r1].long()]                     # (c, ell, bk, N)
        o = torch.einsum("remk,rekn->rmn", blocks[r0:r1].float(),
                         slabs.float())
        out[r0 * bm:r1 * bm] = o.reshape(-1, N).to(x.dtype)
    return out


@functools.cache
def _kernel_fn():
    fn = _build.load("spmm_blocked_ell").spmm_blocked_ell_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_blocked_ell(blocks, idx, x):
    """(nbr, ell, bm, bk) blocked-ELL  @  (K, N) -> (nbr*bm, N), float32.

    On a CUDA tensor: the hand-written kernel, on the current stream. On a
    CPU tensor: ``spmm_blocked_ell_plain``. idx values must lie in
    [0, K/bk) (the kernel skips a tile whose column block does not)."""
    _check(blocks, idx, x)
    if x.device.type == "cpu":
        return spmm_blocked_ell_plain(blocks, idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    nbr, ell, bm, bk = blocks.shape
    K, N = x.shape
    if bm not in KERNEL_BM or bk % KERNEL_KC:
        raise ValueError(f"kernel takes bm in {KERNEL_BM} and bk a multiple "
                         f"of {KERNEL_KC}; got bm={bm}, bk={bk}")
    if not (blocks.is_contiguous() and idx.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("blocks, idx and x must be contiguous")
    out = torch.empty((nbr * bm, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn()(blocks.data_ptr(), idx.data_ptr(), x.data_ptr(),
                           out.data_ptr(), nbr, ell, bm, bk, K, N, stream)
    if err != 0:
        raise RuntimeError(f"spmm_blocked_ell launch failed: cudaError {err}")
    spmm_blocked_ell.launches += 1
    return out


spmm_blocked_ell.launches = 0


# ---------------------------------------------------------------------------
# row-wise CSR SpMM: plain PyTorch version and the kernel's wrapper
# ---------------------------------------------------------------------------
INT32_MAX = 2**31 - 1


def _check_csr(indptr, indices, values, x):
    if indptr.dim() != 1 or indices.dim() != 1 or values.dim() != 1 \
            or x.dim() != 2 or indptr.numel() < 1:
        raise ValueError("want indptr (M+1,), indices (nnz,), values (nnz,), "
                         f"x (K, N); got {tuple(indptr.shape)}, "
                         f"{tuple(indices.shape)}, {tuple(values.shape)}, "
                         f"{tuple(x.shape)}")
    if indices.shape != values.shape:
        raise ValueError(f"indices {tuple(indices.shape)} and values "
                         f"{tuple(values.shape)} differ")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError(f"indptr and indices must be int32; got "
                        f"{indptr.dtype}, {indices.dtype}")
    if values.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"float32 only; got values {values.dtype}, "
                        f"x {x.dtype}")
    if not (indptr.device == indices.device == values.device == x.device):
        raise ValueError("indptr, indices, values and x must be on one "
                         "device")
    if not all(t.is_contiguous() for t in (indptr, indices, values, x)):
        raise ValueError("indptr, indices, values and x must be contiguous")
    if max(x.shape) > INT32_MAX or indptr.numel() - 1 > INT32_MAX:
        raise ValueError(f"M, K and N must fit int32; got M = "
                         f"{indptr.numel() - 1}, x {tuple(x.shape)}")


def spmm_csr_rows_plain(indptr, indices, values, x):
    """Plain PyTorch version, ``sparse.spmm_csr``: expand the rows, gather
    the X rows by column, scale by the values and sum them per row with
    ``index_add_``."""
    shape = (indptr.numel() - 1, x.shape[0])
    return spmm_csr(CSR(indptr.long(), indices.long(), values, shape), x)


@functools.cache
def _csr_kernel_fn():
    fn = _build.load("spmm_csr_rows").spmm_csr_rows_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spmm_csr_rows(indptr, indices, values, x):
    """CSR (M, K)  @  (K, N) -> (M, N), float32; K is ``x.shape[0]``.

    On a CUDA tensor: the hand-written kernel, on the current stream. On a
    CPU tensor: ``spmm_csr_rows_plain``. Column indices must lie in
    [0, K) and each row's columns are summed in the order stored."""
    _check_csr(indptr, indices, values, x)
    if x.device.type == "cpu":
        return spmm_csr_rows_plain(indptr, indices, values, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M = indptr.numel() - 1
    K, N = x.shape
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _csr_kernel_fn()(indptr.data_ptr(), indices.data_ptr(),
                               values.data_ptr(), x.data_ptr(),
                               out.data_ptr(), M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr_rows launch failed: cudaError {err}")
    spmm_csr_rows.launches += 1
    return out


spmm_csr_rows.launches = 0
