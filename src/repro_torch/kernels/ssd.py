"""Mamba2 SSD (state-space duality) chunk scan: the hand-written Hopper
kernel and its plain PyTorch version.

The TPU kernel ``repro/kernels/ssd.py:ssd_chunked_pallas`` runs a grid
(batch, head, chunk) whose chunk axis is sequential, with the (P, N) state
in VMEM scratch across it. Per chunk, with la = cumsum(dt * a):

    W  = (C B^T) * M * dt^T,   M[s, t] = exp(la_s - la_t) for s >= t
    y  = W x + (C S^T) * exp(la)
    S' = exp(la_Q) S + (x * exp(la_Q - la) * dt)^T B

``ssd_chunked`` launches ``csrc/ssd_chunked.cu`` on a CUDA tensor and uses
``ssd_chunked_plain`` on a CPU tensor; it never falls back from one to the
other. ``ssd_chunked.launches`` counts kernel launches.

Numerics follow the model zoo's ``models/ssm.py:ssd_chunked``, the function
the JAX model path calls: softplus(dt) and a = -exp(A_log) in float32
outside the scan (shared by both versions here), la a cumulative sum of
dt * a inside each chunk taken in order, all arithmetic in float32, the
D * x skip added in float32 and y rounded to x's type once; the final state
is float32. (The Pallas wrapper instead rounds y first and adds a rounded
D * x, which differs by one ulp in bfloat16.)

Layouts: x (b, L, H, P), dt (b, L, H), B and C (b, L, N) shared by every
head, A_log and D (H,); init_state (b, H, P, N) or None for zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

Q_MAX = 256                      # the kernel keeps a chunk's rows in smem
KERNEL_N = (64, 128)             # state sizes the CUDA kernel is built for
KERNEL_P_STEP = 32               # P columns per thread block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, B, C, A_log, D, chunk: int, init_state):
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("want x (b, L, H, P), dt (b, L, H), B and C "
                         f"(b, L, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, L, H, P = x.shape
    N = B.shape[-1]
    if tuple(dt.shape) != (b, L, H) or tuple(B.shape) != (b, L, N) \
            or C.shape != B.shape:
        raise ValueError(f"dt {tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match x {tuple(x.shape)}")
    if tuple(A_log.shape) != (H,) or tuple(D.shape) != (H,):
        raise ValueError(f"A_log and D must be ({H},)")
    if init_state is not None and tuple(init_state.shape) != (b, H, P, N):
        raise ValueError(f"init_state {tuple(init_state.shape)} is not "
                         f"{(b, H, P, N)}")
    Q = min(chunk, L)
    if Q <= 0 or L % Q:
        raise ValueError(f"L={L} is not divisible by chunk {Q}")
    if not all(t.is_floating_point() for t in (x, dt, B, C, A_log, D)):
        raise TypeError("every input must be a floating-point tensor")
    devs = {t.device for t in (x, dt, B, C, A_log, D)}
    if init_state is not None:
        devs.add(init_state.device)
    if len(devs) != 1:
        raise ValueError("every input must be on one device")
    return Q


def _discretize(dt, A_log):
    """(softplus(dt), dt * a) in float32, a = -exp(A_log). softplus as
    ``jax.nn.softplus`` writes it: max(x, 0) + log1p(exp(-|x|))."""
    x = dt.float()
    dts = x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))
    return dts, dts * -torch.exp(A_log.float())


def _chunk_cumsum(da, Q: int):
    """la = cumsum of da within each chunk of Q rows, (b, nc, Q, H), added
    in order row by row, as the kernel adds them."""
    b, L, H = da.shape
    la = da.reshape(b, L // Q, Q, H).clone()
    for i in range(1, Q):
        la[:, :, i] += la[:, :, i - 1]
    return la


def ssd_chunked_plain(x, dt, B, C, A_log, D, *, chunk: int,
                      init_state=None):
    """Plain PyTorch version: a loop over chunks with the products of the
    model zoo's ``ssd_chunked``, W kept as (b, Q, Q, H) (never a
    (b, Q, Q, H, P) product). Returns (y in x's dtype, final state
    float32)."""
    Q = _check(x, dt, B, C, A_log, D, chunk, init_state)
    b, L, H, P = x.shape
    N = B.shape[-1]
    dts, da = _discretize(dt, A_log)
    la = _chunk_cumsum(da, Q)
    S = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    Df = D.float()[:, None]
    for c in range(L // Q):
        rows = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq = x[:, rows].float(), B[:, rows].float(), C[:, rows].float()
        dtq, lq = dts[:, rows], la[:, c]                      # (b, Q, H)
        seg = lq[:, :, None, :] - lq[:, None, :, :]           # (b, Q, Q, H)
        M = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                      float("-inf")))        # mask, then exp
        W = torch.einsum("bsn,btn->bst", Cq, Bq)[..., None] * M \
            * dtq[:, None]
        del seg, M
        yq = torch.einsum("bsth,bthp->bshp", W, xq)
        del W
        yq = yq + torch.einsum("bsn,bhpn->bshp", Cq, S) \
            * torch.exp(lq)[..., None]
        w = torch.exp(lq[:, -1:] - lq) * dtq                  # (b, Q, H)
        S = S * torch.exp(lq[:, -1])[..., None, None] \
            + torch.einsum("btn,bthp->bhpn", Bq, xq * w[..., None])
        y[:, rows] = (yq + Df * xq).to(x.dtype)
    return y, S


@functools.cache
def _kernel_fn():
    fn = _build.load("ssd_chunked").ssd_chunked_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 6 + [ctypes.c_int64] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel_operand(name, t, lead):
    """Strides of a view the kernel reads in place: the last dimension
    contiguous, the others (the first ``lead``) 16-byte aligned."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            (st * t.element_size()) % 16 for st in t.stride()[:lead]):
        raise ValueError(f"{name}: the last dimension must be contiguous and "
                         f"rows 16-byte aligned; strides {t.stride()}")
    return t.stride()[:lead]


def ssd_chunked(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """SSD chunk scan -> (y (b, L, H, P) in x's dtype, final state
    (b, H, P, N) float32).

    On a CUDA tensor: the hand-written kernel, on the current stream. x, B
    and C may be strided views (last dimension contiguous, rows 16-byte
    aligned), as ``mamba_block`` slices them from the conv output; B and C
    must have x's dtype, float32 or bfloat16; P a multiple of 32, N 64 or
    128, Q = min(chunk, L) at most 256. On a CPU tensor:
    ``ssd_chunked_plain``."""
    Q = _check(x, dt, B, C, A_log, D, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, B, C, A_log, D, chunk=chunk,
                                 init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, L, H, P = x.shape
    N = B.shape[-1]
    if x.dtype not in _DTYPES or not (x.dtype == B.dtype == C.dtype):
        raise TypeError("x, B, C must share one dtype, float32 or bfloat16; "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if N not in KERNEL_N or P % KERNEL_P_STEP or Q > Q_MAX or H > 65535 \
            or b > 65535:
        raise ValueError(f"kernel takes N in {KERNEL_N}, P a multiple of "
                         f"{KERNEL_P_STEP}, Q <= {Q_MAX}; got N={N}, P={P}, "
                         f"Q={Q}")
    xs = _kernel_operand("x", x, 3)
    bs = _kernel_operand("B", B, 2)
    cs = _kernel_operand("C", C, 2)
    dts, da = (t.contiguous() for t in _discretize(dt, A_log))
    Df = D.float().contiguous()
    s0 = None if init_state is None else init_state.float().contiguous()
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            _DTYPES[x.dtype], x.data_ptr(), dts.data_ptr(), da.data_ptr(),
            B.data_ptr(), C.data_ptr(), Df.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), b, L, H, P, N, Q, *xs, *bs, *cs,
            stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunked launch failed: cudaError {err}")
    ssd_chunked.launches += 1
    return y, s_out


ssd_chunked.launches = 0
