"""Banded (sliding-window) causal flash attention: the hand-written Hopper
kernels and their plain PyTorch version.

The TPU kernel ``repro/kernels/swa.py:swa_attention_pallas`` visits, for
each 128-row query block, only the key blocks inside the window, with an
online softmax over them (the SWAT analogue). Two CUDA kernels compute it
on the card:

  * ``swa_attention_wgmma`` (``csrc/swa_attention_wgmma.cu``): bf16 with
    D 64, 128 or 256, both products on bf16 ``wgmma``, K/V tiles fed by
    TMA into a ring of shared-memory stages (128-key tiles in three stages
    at D 64 and 128, 64-key tiles in two at D 256); the qwen3-4b prefill
    path's (D 128) and paligemma-3b's and gemma-2b's under long_500k (D
    256, MQA);
  * ``swa_attention_fma`` (``csrc/swa_attention.cu``): float32 on float32
    FMA (it also takes bf16, which ``swa_attention`` never sends it).

The backward has no TPU kernel (the reference trains through XLA's
autodiff of the model zoo's banded attention); on the card it is three
hand-written launches (row statistics, dk and dv, dq), in one of two
kernels that ``_bwd_route`` names:

  * ``csrc/swa_attention_bwd_wgmma.cu``: bf16 with D 64 or 128, every
    band product on bf16 ``wgmma``, the streamed tiles fed by TMA; the
    training path's (D 128);
  * ``csrc/swa_attention_bwd.cu``: float32 FMA, for float32 with D 64,
    128 or 256 and bf16 with D 256 (no training path on the card).

``swa_attention_bwd`` takes them on a CUDA tensor and
``swa_attention_bwd_plain`` on a CPU tensor.

``swa_attention`` takes the kernel that ``_route`` names on a CUDA tensor
and ``swa_attention_plain`` on a CPU tensor; it never falls back from one
to another. On a meta tensor (``launch/dryrun.py``) it and
``swa_attention_bwd`` run the CUDA route's own wrappers, with their checks
and allocations, up to the launch, which they skip; they add one call of
the route's work (``work``, ``bwd_work``: the formulas that
``chip_smoke.py``'s bounds read) to the dry run's tally
(``repro_torch/tally.py``). Each kernel's entry function counts its launches
(``.launches``); ``swa_attention.launches`` counts both forward
kernels.

Layout: q (B, H, S, D), k and v (B, KV, S, D); query head h reads KV head
h // (H // KV). Every route takes what one of the reference's two
functions takes: the model zoo's ``swa_attention`` (a window that divides
S, or covers it) or the Pallas kernel (S and window multiples of its block,
``BLK`` = 128). Both CUDA kernels tile S by 128 rows, so on a CUDA tensor
S and the window must be multiples of ``BLK``; the plain version on the CPU
takes the rest.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import tally
from . import _build

NEG_INF = -1e30
BLK = 128                        # the TPU kernel's block: S, window % BLK == 0
WGMMA_D = (64, 128, 256)         # bf16 head dims of the wgmma kernel
WGMMA_BWD_D = (64, 128)          # bf16 head dims of the wgmma backward
FMA_D = (64, 128, 256)           # head dims of the FMA kernel
PLAIN_CHUNK_BYTES = 256 << 20    # bound on one piece of the plain scores
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, window: int):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("want q (B, H, S, D), k and v (B, KV, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, D) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if window <= 0:
        raise ValueError(f"window={window} is not positive")
    if window < S and S % window and (S % BLK or window % BLK):
        raise ValueError(f"window={window} neither divides S={S} nor are "
                         f"both multiples of {BLK}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v must share one dtype, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def swa_attention_plain(q, k, v, *, window: int, scale: float,
                        chunk_bytes: int = PLAIN_CHUNK_BYTES):
    """Plain PyTorch version, in the chunk + halo form of the JAX package's
    ``models/attention.py:swa_attention``: chunks of c = min(window, S)
    queries see their own chunk and the one before (2c keys), masked to
    0 <= row - col < window, with a float32 softmax. S is padded at the end
    to a multiple of c (padded keys lie after every real query, so the
    causal mask drops them). Works on one (batch, KV head, chunk, row
    range) at a time so that a piece of scores stays under ``chunk_bytes``
    (unchunked they would be 34 GB at the main path's shape)."""
    _check(q, k, v, window)
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    c = min(window, S)
    nc = -(-S // c)
    pad = nc * c - S
    rows = max(1, min(c, chunk_bytes // max(1, G * 2 * c * 4)))
    i = torch.arange(c, device=q.device)[:, None]
    j = torch.arange(2 * c, device=q.device)[None, :]
    rel = i + c - j                          # distance q - k
    band = (rel >= 0) & (rel < window)
    out = torch.empty_like(q)
    for b in range(B):
        for kh in range(KV):
            heads = slice(kh * G, (kh + 1) * G)
            qf = q[b, heads].float() * scale                    # (G, S, D)
            # halo: one chunk of zeros before the first
            kf = torch.nn.functional.pad(k[b, kh].float(), (0, 0, c, pad))
            vf = torch.nn.functional.pad(v[b, kh].float(), (0, 0, c, pad))
            for n in range(nc):
                kw, vw = kf[n * c:(n + 2) * c], vf[n * c:(n + 2) * c]
                valid = band if n > 0 else band & (j >= c)
                for r0 in range(0, min(c, S - n * c), rows):
                    r1 = min(r0 + rows, S - n * c)
                    s = qf[:, n * c + r0:n * c + r1] @ kw.T    # (G, r, 2c)
                    s = torch.where(valid[r0:r1], s, NEG_INF)
                    p = torch.softmax(s, dim=-1)
                    out[b, heads, n * c + r0:n * c + r1] = (p @ vw).to(
                        q.dtype)
    return out


def _check_bwd(q, k, v, o, do, window: int):
    _check(q, k, v, window)
    for label, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{label} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")


def _piece(G: int, w: int, S: int, chunk_bytes: int) -> int:
    """Rows (or keys) a piece of the plain backward takes at once, so that
    G x n x (n + w - 1) float32 scores stay under ``chunk_bytes``."""
    n = S
    while n > 1 and G * n * (n + w - 1) * 4 > chunk_bytes:
        n = (n + 1) // 2
    return n


def _band(r0: int, r1: int, c0: int, c1: int, window: int, device):
    rel = (torch.arange(r0, r1, device=device)[:, None]
           - torch.arange(c0, c1, device=device)[None, :])
    return (rel >= 0) & (rel < window)


def swa_attention_bwd_stats_plain(q, k, o, do, *, window: int, scale: float,
                                  chunk_bytes: int = PLAIN_CHUNK_BYTES):
    """Row statistics of the backward, plain PyTorch: (lse, delta), both
    float32 (B, H, S). lse is recomputed from the band, with the forward's
    finite ``NEG_INF`` and ``max(l, 1e-30)``: m the largest in-band score
    of a row, lse = m + log(max(sum exp(s - m), 1e-30)); delta = sum_d
    do * o. Works on pieces of rows, as ``swa_attention_bwd_plain``."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    w = min(window, S)
    n = _piece(G, w, S, chunk_bytes)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = (do.float() * o.float()).sum(dim=-1)
    for b in range(B):
        for kh in range(KV):
            heads = slice(kh * G, (kh + 1) * G)
            qs = q[b, heads].float() * scale                    # (G, S, D)
            kf = k[b, kh].float()
            for r0 in range(0, S, n):
                r1 = min(S, r0 + n)
                c0 = max(0, r0 - w + 1)
                valid = _band(r0, r1, c0, r1, window, q.device)
                s = torch.where(valid, qs[:, r0:r1] @ kf[c0:r1].T, NEG_INF)
                m = s.amax(dim=-1)
                e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
                lse[b, heads, r0:r1] = m + torch.log(
                    e.sum(dim=-1).clamp_min(1e-30))
    return lse, delta


def swa_attention_bwd_plain(q, k, v, o, do, *, window: int, scale: float,
                            chunk_bytes: int = PLAIN_CHUNK_BYTES):
    """Plain PyTorch backward of the banded attention: (dq, dk, dv) in the
    inputs' dtype, from q (B, H, S, D), k and v (B, KV, S, D), the forward's
    output o and its gradient do (both (B, H, S, D)).

    The arithmetic of the reference's flash backward
    (``models/attention.py:_flash_vjp_bwd``) under the band mask
    ``0 <= row - col < window``, in float32: with lse and delta from
    ``swa_attention_bwd_stats_plain``, for each block of keys and the
    query rows that see it, s = (q * scale) k^T, p = exp(s - lse) (0 off
    the band), dv = p^T do, dp = do v^T, ds = p (dp - delta) scale, dq +=
    ds k, dk = ds^T q; dk and dv sum the G query heads of a KV head. A
    block of keys is as large as keeps G x keys x (keys + window - 1)
    float32 scores under ``chunk_bytes``."""
    _check_bwd(q, k, v, o, do, window)
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    w = min(window, S)
    n = _piece(G, w, S, chunk_bytes)
    lse, delta = swa_attention_bwd_stats_plain(
        q, k, o, do, window=window, scale=scale, chunk_bytes=chunk_bytes)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for b in range(B):
        for kh in range(KV):
            heads = slice(kh * G, (kh + 1) * G)
            qf = q[b, heads].float()                            # (G, S, D)
            dof = do[b, heads].float()
            kf, vf = k[b, kh].float(), v[b, kh].float()
            dqf = torch.zeros_like(qf)
            for c0 in range(0, S, n):
                c1 = min(S, c0 + n)
                r1 = min(S, c1 + w - 1)          # rows c0 .. r1 see a key
                valid = _band(c0, r1, c0, c1, window, q.device)
                s = (qf[:, c0:r1] * scale) @ kf[c0:c1].T        # (G, r, c)
                p = torch.where(
                    valid, torch.exp(s - lse[b, heads, c0:r1, None]), 0.0)
                del s
                dv[b, kh, c0:c1] = (p.transpose(1, 2) @ dof[:, c0:r1]).sum(0)
                ds = p * (dof[:, c0:r1] @ vf[c0:c1].T
                          - delta[b, heads, c0:r1, None]) * scale
                del p
                dqf[:, c0:r1] += ds @ kf[c0:c1]
                dk[b, kh, c0:c1] = (ds.transpose(1, 2) @ qf[:, c0:r1]).sum(0)
            dq[b, heads] = dqf
    return dq, dk, dv


def _route(dtype, D: int) -> str:
    """The kernel that takes a CUDA input of this dtype and head dim:
    ``"wgmma"`` (bf16, D 64, 128 or 256) or ``"fma"`` (float32 with D 64,
    128 or 256). Raises on what neither takes."""
    if dtype == torch.bfloat16 and D in WGMMA_D:
        return "wgmma"
    if dtype == torch.float32 and D in FMA_D:
        return "fma"
    raise ValueError(f"no SWA kernel takes {dtype} with D={D}: the wgmma "
                     f"kernel takes bf16 with D in {WGMMA_D}, the FMA kernel "
                     f"float32 with D in {FMA_D}")


@functools.cache
def _fma_fn():
    fn = _build.load("swa_attention").swa_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int64] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_fn():
    fn = _build.load("swa_attention_wgmma").swa_attention_wgmma_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int64] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def wgmma_smem_bytes(D: int) -> int:
    """Dynamic shared memory a CTA of the wgmma kernel takes at head dim D
    (builds the kernel's library)."""
    fn = _build.load("swa_attention_wgmma").swa_attention_wgmma_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(D)


def _check_tiles(S: int, window: int):
    """Both CUDA kernels tile S by ``BLK`` rows; raises on an S or a window
    that is not a multiple of it (the plain version on the CPU takes
    them)."""
    if S % BLK or window % BLK:
        raise ValueError(f"the CUDA kernels tile S by {BLK} rows, so S and "
                         f"the window must be multiples of {BLK}; got S={S}, "
                         f"window={window}")


def _cuda_args(name: str, dtypes, dims, q, k, v, window: int):
    """Checks shared by both kernels on a CUDA (or, in the dry run, meta)
    input; returns the output, with q's strides."""
    _check(q, k, v, window)
    _check_tiles(q.shape[2], window)
    if q.dtype not in dtypes or q.shape[3] not in dims:
        raise ValueError(f"{name} takes {dtypes} with D in {dims}; got "
                         f"{q.dtype} with D={q.shape[3]}")
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on a CUDA tensor; got {q.device} "
                         "(swa_attention takes the plain version on the CPU)")
    out = torch.empty_like(q)
    for label, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (st * t.element_size()) % 16 for st in t.stride()[:3]):
            raise ValueError(f"{label}: the last dimension must be contiguous "
                             f"and rows 16-byte aligned; strides "
                             f"{t.stride()}")
    return out


def _strides(q, k, v, out):
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3])


def swa_attention_wgmma(q, k, v, *, window: int, scale: float):
    """The wgmma kernel on bf16 CUDA tensors with D 64, 128 or 256, on the
    current stream; raises on anything else."""
    out = _cuda_args("swa_attention_wgmma", (torch.bfloat16,), WGMMA_D,
                     q, k, v, window)
    if out.is_meta:                 # the dry run: no launch
        return out
    B, H, S, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _wgmma_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, H, k.shape[1], S, D, window,
                          scale, *_strides(q, k, v, out), stream)
    if err < 0:
        raise RuntimeError(
            "swa_attention_wgmma: no cuTensorMapEncodeTiled in the driver"
            if err == -1 else f"swa_attention_wgmma: the driver refused a "
            f"TMA map, CUresult {-err - 1000}")
    if err != 0:
        raise RuntimeError(f"swa_attention_wgmma launch failed: cudaError "
                           f"{err}")
    swa_attention_wgmma.launches += 1
    return out


def swa_attention_fma(q, k, v, *, window: int, scale: float):
    """The FMA kernel on float32 or bf16 CUDA tensors with D 64, 128 or 256,
    on the current stream; raises on anything else. ``swa_attention``
    routes bf16 to the wgmma kernel instead."""
    out = _cuda_args("swa_attention_fma", tuple(_DTYPES), FMA_D, q, k, v,
                     window)
    B, H, S, D = q.shape
    if B * H > 65535:
        raise ValueError(f"the FMA kernel takes B*H <= 65535; got {B * H}")
    if out.is_meta:                 # the dry run: no launch
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fma_fn()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), B, H, k.shape[1], S, D,
                        window, scale, *_strides(q, k, v, out), stream)
    if err != 0:
        raise RuntimeError(f"swa_attention_fma launch failed: cudaError "
                           f"{err}")
    swa_attention_fma.launches += 1
    return out


_KERNELS = {"wgmma": swa_attention_wgmma, "fma": swa_attention_fma}


# ---------------------------------------------------------------------------
# The work of a call (chip_smoke.py's bounds and the dry run's tally read
# these)
# ---------------------------------------------------------------------------
def band_pairs(S: int, window: int) -> int:
    """The in-band (row, key) pairs of one (batch, head)."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def work(B, H, KV, S, D, window, esize):
    """(bytes, FLOPs) of one forward call on these shapes: q, k, v read
    once and o written once, against the q.k and p.v products of the
    in-band pairs only (2 D FLOPs a pair each)."""
    flops = 4.0 * D * band_pairs(S, window) * B * H
    nbytes = (2 * B * H + 2 * B * KV) * S * D * esize
    return nbytes, flops


def bwd_work(B, H, KV, S, D, window, esize, products=5, stats=False,
             grads=("dq", "dk", "dv")):
    """(bytes, FLOPs) of ``products`` band products of the backward on
    these shapes (2 D FLOPs a pair each; the whole backward is five: s
    recomputed, dp, dv, dq, dk), against the bytes: q, o, do and k read
    once and lse and delta written (``stats``), or q, do, k, v, lse and
    delta read once and the named gradients written once."""
    flops = 2.0 * D * band_pairs(S, window) * B * H * products
    qsz, kvsz = B * H * S * D * esize, B * KV * S * D * esize
    row = B * H * S * 4
    if stats:
        nbytes = 3 * qsz + kvsz + 2 * row          # q, o, do, k; lse, delta
    else:
        nbytes = 2 * qsz + 2 * kvsz + 2 * row      # q, do, k, v, lse, delta
        nbytes += sum(qsz if g == "dq" else kvsz for g in grads)
    return nbytes, flops


def swa_attention(q, k, v, *, window: int, scale: float):
    """Banded causal attention, (B, H, S, D) -> (B, H, S, D) in q's dtype.

    On a CUDA tensor: the kernel that ``_route`` names, on the current
    stream; the output has q's strides, and any strides with a contiguous
    last dimension and 16-byte aligned rows are read in place. On a CPU
    tensor: ``swa_attention_plain``. On a meta tensor: the same route with
    no launch, one call of its work in the dry run's tally."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, window=window, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    route = _route(q.dtype, q.shape[3])
    out = _KERNELS[route](q, k, v, window=window, scale=scale)
    if q.is_meta:
        nbytes, flops = work(*q.shape[:2], k.shape[1], *q.shape[2:], window,
                             q.element_size())
        tally.kernel(f"swa_attention_{route}", flops, nbytes)
    else:
        swa_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# The backward on the card: csrc/swa_attention_bwd_wgmma.cu (bf16, D 64 and
# 128) and csrc/swa_attention_bwd.cu (float32 FMA)
# ---------------------------------------------------------------------------
BWD_ENTRIES = ("swa_attention_bwd_stats", "swa_attention_bwd_dkdv",
               "swa_attention_bwd_dq")
BWD_WGMMA_ENTRIES = ("swa_attention_bwd_wgmma_stats",
                     "swa_attention_bwd_wgmma_dkdv",
                     "swa_attention_bwd_wgmma_dq")
_BWD_SOURCES = {"fma": ("swa_attention_bwd", BWD_ENTRIES),
                "wgmma": ("swa_attention_bwd_wgmma", BWD_WGMMA_ENTRIES)}


def _bwd_route(dtype, D: int) -> str:
    """The backward kernel that takes a CUDA input of this dtype and head
    dim: ``"wgmma"`` (bf16, D 64 or 128) or ``"fma"`` (float32 with D 64,
    128 or 256, and bf16 with D 256, where a consumer thread of the wgmma
    design would hold 256 floats of dk and dv alone). Raises on what
    neither takes."""
    if dtype == torch.bfloat16 and D in WGMMA_BWD_D:
        return "wgmma"
    if dtype in _DTYPES and D in FMA_D:
        return "fma"
    raise ValueError(f"no SWA backward kernel takes {dtype} with D={D}: the "
                     f"wgmma backward takes bf16 with D in {WGMMA_BWD_D}, "
                     f"the FMA backward float32 or bf16 with D in {FMA_D}")


@functools.cache
def _bwd_fn(route: str, which: int):
    source, names = _BWD_SOURCES[route]
    fn = getattr(_build.load(source), names[which])
    fn.argtypes = ([ctypes.c_int] * (route == "fma")
                   + [ctypes.c_void_p] * (10 + (route == "wgmma"))
                   + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _bwd_smem(route: str, D: int) -> dict:
    source, names = _BWD_SOURCES[route]
    fn = getattr(_build.load(source), f"{source}_smem")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return {name: fn(i, D) for i, name in enumerate(names)}


def bwd_smem_bytes(D: int) -> dict:
    """Dynamic shared memory of each FMA backward launch at head dim D
    (builds the kernel's library)."""
    return _bwd_smem("fma", D)


def bwd_wgmma_smem_bytes(D: int) -> dict:
    """Dynamic shared memory of each wgmma backward launch at head dim D
    (builds the kernel's library)."""
    return _bwd_smem("wgmma", D)


def _bwd_cuda_check(route: str, which: int, q, k, v, o, do, window: int):
    name = _BWD_SOURCES[route][1][which]
    _check_bwd(q, k, v, o, do, window)
    _check_tiles(q.shape[2], window)
    if route == "wgmma" and (q.dtype != torch.bfloat16
                             or q.shape[3] not in WGMMA_BWD_D):
        raise ValueError(f"{name} takes bf16 with D in {WGMMA_BWD_D}; got "
                         f"{q.dtype} with D={q.shape[3]}")
    if q.shape[3] not in FMA_D:
        raise ValueError(f"{name} takes D in {FMA_D}; got D={q.shape[3]}")
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on a CUDA tensor; got {q.device} "
                         "(swa_attention_bwd takes the plain version on the "
                         "CPU)")
    B, H = q.shape[:2]
    if route == "fma" and B * H > 65535:
        raise ValueError(f"{name} takes B*H <= 65535; got {B * H}")


def _bwd_launch(route: str, which: int, q, k, v, o, do, lse, delta, dq, dk,
                dv, *, window: int, scale: float, work=None):
    """One entry of a backward kernel, counted in its ``.launches``; every
    tensor it reads or writes must have a contiguous last dimension and
    16-byte aligned rows. ``work`` is the wgmma dk/dv launch's float32
    workspace. On meta tensors (the dry run) it checks the strides and
    returns with no launch."""
    name = _BWD_SOURCES[route][1][which]
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = []
    for label, t in zip(("q", "k", "v", "o", "do", "dq", "dk", "dv"),
                        tensors):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (st * t.element_size()) % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}: {label} needs a contiguous last "
                             f"dimension and 16-byte aligned rows; strides "
                             f"{t.stride()}")
        strides += t.stride()[:3]
    if q.is_meta:
        return
    B, H, S, D = q.shape
    arr = (ctypes.c_int64 * 24)(*strides)
    # the FMA entries take the dtype first, the wgmma ones a workspace
    # pointer after delta (NULL where unread)
    head = (_DTYPES[q.dtype],) if route == "fma" else ()
    tail = () if route == "fma" else (
        None if work is None else work.data_ptr(),)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bwd_fn(route, which)(
            *head, *(t.data_ptr() for t in tensors), lse.data_ptr(),
            delta.data_ptr(), *tail, B, H, k.shape[1], S, D, window, scale,
            ctypes.addressof(arr), stream)
    if err < 0:
        raise RuntimeError(
            f"{name}: no cuTensorMapEncodeTiled in the driver" if err == -1
            else f"{name}: the driver refused a TMA map, CUresult "
            f"{-err - 1000}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _BWD_ENTRY_FNS[name].launches += 1


def _bwd_stats(route, q, k, v, o, do, window, scale):
    _bwd_cuda_check(route, 0, q, k, v, o, do, window)
    lse, delta = (torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device) for _ in range(2))
    # dq, dk, dv are not read: q, k, v stand in for their pointers
    _bwd_launch(route, 0, q, k, v, o, do, lse, delta, q, k, v,
                window=window, scale=scale)
    return lse, delta


def _bwd_dkdv(route, q, k, v, o, do, lse, delta, window, scale):
    _bwd_cuda_check(route, 1, q, k, v, o, do, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the wgmma kernel's float32 sums of dk and dv (2 D a key)
    work = None if route == "fma" else torch.empty(
        2 * k.numel(), dtype=torch.float32, device=k.device)
    _bwd_launch(route, 1, q, k, v, o, do, lse, delta, q, dk, dv,
                window=window, scale=scale, work=work)
    return dk, dv


def _bwd_dq(route, q, k, v, o, do, lse, delta, window, scale):
    _bwd_cuda_check(route, 2, q, k, v, o, do, window)
    dq = torch.empty_like(q)
    _bwd_launch(route, 2, q, k, v, o, do, lse, delta, dq, k, v,
                window=window, scale=scale)
    return dq


def swa_attention_bwd_stats(q, k, v, o, do, *, window: int, scale: float):
    """Launch 1 of the FMA backward kernel on CUDA tensors: (lse, delta),
    float32 (B, H, S), as ``swa_attention_bwd_stats_plain``."""
    return _bwd_stats("fma", q, k, v, o, do, window, scale)


def swa_attention_bwd_dkdv(q, k, v, o, do, lse, delta, *, window: int,
                           scale: float):
    """Launch 2 of the FMA backward kernel on CUDA tensors: (dk, dv) in k's
    dtype and strides, from the row statistics of launch 1."""
    return _bwd_dkdv("fma", q, k, v, o, do, lse, delta, window, scale)


def swa_attention_bwd_dq(q, k, v, o, do, lse, delta, *, window: int,
                         scale: float):
    """Launch 3 of the FMA backward kernel on CUDA tensors: dq in q's dtype
    and strides, from the row statistics of launch 1."""
    return _bwd_dq("fma", q, k, v, o, do, lse, delta, window, scale)


def swa_attention_bwd_wgmma_stats(q, k, v, o, do, *, window: int,
                                  scale: float):
    """Launch 1 of the wgmma backward kernel on bf16 CUDA tensors with D 64
    or 128: (lse, delta), float32 (B, H, S), as
    ``swa_attention_bwd_stats_plain``."""
    return _bwd_stats("wgmma", q, k, v, o, do, window, scale)


def swa_attention_bwd_wgmma_dkdv(q, k, v, o, do, lse, delta, *, window: int,
                                 scale: float):
    """Launch 2 of the wgmma backward kernel on bf16 CUDA tensors: (dk, dv)
    in k's strides, from the row statistics of launch 1."""
    return _bwd_dkdv("wgmma", q, k, v, o, do, lse, delta, window, scale)


def swa_attention_bwd_wgmma_dq(q, k, v, o, do, lse, delta, *, window: int,
                               scale: float):
    """Launch 3 of the wgmma backward kernel on bf16 CUDA tensors: dq in
    q's strides, from the row statistics of launch 1."""
    return _bwd_dq("wgmma", q, k, v, o, do, lse, delta, window, scale)


# the three launches of each route, in order: stats, dk and dv, dq
_BWD_KERNELS = {
    "fma": (swa_attention_bwd_stats, swa_attention_bwd_dkdv,
            swa_attention_bwd_dq),
    "wgmma": (swa_attention_bwd_wgmma_stats, swa_attention_bwd_wgmma_dkdv,
              swa_attention_bwd_wgmma_dq)}
_BWD_ENTRY_FNS = {f.__name__: f for fs in _BWD_KERNELS.values() for f in fs}


def swa_attention_bwd(q, k, v, o, do, *, window: int, scale: float):
    """Backward of ``swa_attention``: (dq, dk, dv) in the inputs' dtype,
    from the forward's inputs, its output o and the output's gradient do.

    On a CUDA tensor: the three launches of the kernel that ``_bwd_route``
    names, on the current stream (S and window multiples of ``BLK``; o and
    do with the strides the kernel takes, see ``_bwd_launch``). On a CPU
    tensor: ``swa_attention_bwd_plain``. On a meta tensor: the same
    launches' checks and allocations with no launch, one call of the
    route's work in the dry run's tally."""
    _check_bwd(q, k, v, o, do, window)
    if q.device.type == "cpu":
        return swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                       scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    route = _bwd_route(q.dtype, q.shape[3])
    stats, dkdv, dq_fn = _BWD_KERNELS[route]
    lse, delta = stats(q, k, v, o, do, window=window, scale=scale)
    dk, dv = dkdv(q, k, v, o, do, lse, delta, window=window, scale=scale)
    dq = dq_fn(q, k, v, o, do, lse, delta, window=window, scale=scale)
    if q.is_meta:
        nbytes, flops = bwd_work(*q.shape[:2], k.shape[1], *q.shape[2:],
                                 window, q.element_size())
        tally.kernel(f"swa_attention_bwd_{route}", flops, nbytes)
    return dq, dk, dv


swa_attention.launches = 0
swa_attention_wgmma.launches = 0
swa_attention_fma.launches = 0
swa_attention_bwd_stats.launches = 0
swa_attention_bwd_dkdv.launches = 0
swa_attention_bwd_dq.launches = 0
swa_attention_bwd_wgmma_stats.launches = 0
swa_attention_bwd_wgmma_dkdv.launches = 0
swa_attention_bwd_wgmma_dq.launches = 0
