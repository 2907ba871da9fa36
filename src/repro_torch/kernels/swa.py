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

``swa_attention`` takes the kernel that ``_route`` names on a CUDA tensor
and ``swa_attention_plain`` on a CPU tensor; it never falls back from one
to another. Each kernel's entry function counts its launches
(``.launches``); ``swa_attention.launches`` counts both.

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

from . import _build

NEG_INF = -1e30
BLK = 128                        # the TPU kernel's block: S, window % BLK == 0
WGMMA_D = (64, 128, 256)         # bf16 head dims of the wgmma kernel
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
    """Checks shared by both kernels on a CUDA input; returns the output,
    with q's strides."""
    _check(q, k, v, window)
    _check_tiles(q.shape[2], window)
    if q.dtype not in dtypes or q.shape[3] not in dims:
        raise ValueError(f"{name} takes {dtypes} with D in {dims}; got "
                         f"{q.dtype} with D={q.shape[3]}")
    if q.device.type != "cuda":
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


def swa_attention(q, k, v, *, window: int, scale: float):
    """Banded causal attention, (B, H, S, D) -> (B, H, S, D) in q's dtype.

    On a CUDA tensor: the kernel that ``_route`` names, on the current
    stream; the output has q's strides, and any strides with a contiguous
    last dimension and 16-byte aligned rows are read in place. On a CPU
    tensor: ``swa_attention_plain``."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _KERNELS[_route(q.dtype, q.shape[3])](q, k, v, window=window,
                                                scale=scale)
    swa_attention.launches += 1
    return out


swa_attention.launches = 0
swa_attention_wgmma.launches = 0
swa_attention_fma.launches = 0
