"""Mamba2 SSD (state-space duality) chunk scan: the hand-written Hopper
kernels and their plain PyTorch versions.

The TPU kernel ``repro/kernels/ssd.py:ssd_chunked_pallas`` runs a grid
(batch, head, chunk) whose chunk axis is sequential, with the (P, N) state
in VMEM scratch across it. Per chunk, with la = cumsum(dt * a):

    W  = (C B^T) * M * dt^T,   M[s, t] = exp(la_s - la_t) for s >= t
    y  = W x + (C S^T) * exp(la)
    S' = exp(la_Q) S + (x * exp(la_Q - la) * dt)^T B

Two CUDA routes compute it on the card:

  * ``ssd_chunked_tc`` (``csrc/ssd_chunk_tc.cu``): bf16 with P a multiple
    of 64, N 64 or 128 and Q a multiple of 64 up to 256, on bf16 tensor
    cores (``wmma``) in three chunk-parallel kernels: the chunk states
    (``ssd_chunk_state``), a float32 scan over them (``ssd_state_scan``)
    and the chunk outputs (``ssd_chunk_out``); the mamba2 prefill path's;
  * ``ssd_chunked_fma`` (``csrc/ssd_chunked.cu``): float32, and the bf16
    shapes the tensor-core route does not take, on float32 FMA with the
    chunk loop inside one kernel.

``ssd_chunked`` takes the route that ``_route`` names on a CUDA tensor and
``ssd_chunked_plain`` on a CPU tensor; it never falls back from one to
another. ``ssd_chunked.launches`` counts its calls, each route's entry its
own calls, and each of the three tensor-core kernels its own launches.
``ssd_chunk_state_plain``, ``ssd_state_scan_plain`` and
``ssd_chunk_out_plain`` are the three kernels' functions in plain PyTorch;
composed, they give ``ssd_chunked_plain``'s result (tests and
``chip_smoke.py`` only).

Numerics follow the model zoo's ``models/ssm.py:ssd_chunked``, the function
the JAX model path calls: softplus(dt) and a = -exp(A_log) in float32
outside the scan (shared by every version here), la a cumulative sum of
dt * a inside each chunk taken in order, all arithmetic in float32, the
D * x skip added in float32 and y rounded to x's type once; the final state
is float32. (The Pallas wrapper instead rounds y first and adds a rounded
D * x, which differs by one ulp in bfloat16.) The tensor-core route keeps
float32 accuracy by splitting each float32 operand v of a bf16 product
into three bf16 parts, hi = bf16(v), mid = bf16(v - hi) and lo =
bf16(v - hi - mid) (see ``csrc/ssd_chunk_tc.cu``).

Layouts: x (b, L, H, P), dt (b, L, H), B and C (b, L, N) shared by every
head, A_log and D (H,); init_state (b, H, P, N) or None for zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

Q_MAX = 256                      # the kernels keep a chunk's rows in smem
KERNEL_N = (64, 128)             # state sizes both CUDA routes are built for
KERNEL_P_STEP = 32               # P columns per block of the FMA kernel
TC_STEP = 64                     # tensor-core route: P slice and row tile
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


def softplus(x):
    """softplus as ``jax.nn.softplus`` writes it: max(x, 0) +
    log1p(exp(-|x|)). Shared with the recurrent decode step."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _discretize(dt, A_log):
    """(softplus(dt), dt * a) in float32, a = -exp(A_log)."""
    dts = softplus(dt.float())
    return dts, dts * -torch.exp(A_log.float())


def _chunk_cumsum(da, Q: int):
    """la = cumsum of da within each chunk of Q rows, (b, nc, Q, H), added
    in order row by row, as the kernel adds them."""
    b, L, H = da.shape
    la = da.reshape(b, L // Q, Q, H).clone()
    for i in range(1, Q):
        la[:, :, i] += la[:, :, i - 1]
    return la


def _chunk_y(xq, Bq, Cq, dtq, lq, S, Df):
    """y of one chunk in float32, (b, Q, H, P): W x + (C S^T) exp(la) + D x
    with W = (C B^T) * exp(la_s - la_t) [s >= t] * dt_t, masked before the
    exp and kept as (b, Q, Q, H) (never a (b, Q, Q, H, P) product); S is
    the (b, H, P, N) state entering the chunk."""
    Q = xq.shape[1]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xq.device).tril()
    seg = lq[:, :, None, :] - lq[:, None, :, :]               # (b, Q, Q, H)
    M = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                  float("-inf")))            # mask, then exp
    W = torch.einsum("bsn,btn->bst", Cq, Bq)[..., None] * M * dtq[:, None]
    del seg, M
    yq = torch.einsum("bsth,bthp->bshp", W, xq)
    del W
    yq = yq + torch.einsum("bsn,bhpn->bshp", Cq, S) * torch.exp(lq)[..., None]
    return yq + Df * xq


def ssd_chunked_plain(x, dt, B, C, A_log, D, *, chunk: int,
                      init_state=None):
    """Plain PyTorch version: a loop over chunks with the products of the
    model zoo's ``ssd_chunked``, the state carried from chunk to chunk.
    Returns (y in x's dtype, final state float32)."""
    Q = _check(x, dt, B, C, A_log, D, chunk, init_state)
    b, L, H, P = x.shape
    N = B.shape[-1]
    dts, da = _discretize(dt, A_log)
    la = _chunk_cumsum(da, Q)
    S = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    y = torch.empty_like(x)
    Df = D.float()[:, None]
    for c in range(L // Q):
        rows = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq = x[:, rows].float(), B[:, rows].float(), C[:, rows].float()
        dtq, lq = dts[:, rows], la[:, c]                      # (b, Q, H)
        y[:, rows] = _chunk_y(xq, Bq, Cq, dtq, lq, S, Df).to(x.dtype)
        w = torch.exp(lq[:, -1:] - lq) * dtq                  # (b, Q, H)
        S = S * torch.exp(lq[:, -1])[..., None, None] \
            + torch.einsum("btn,bthp->bhpn", Bq, xq * w[..., None])
    return y, S


# ---------------------------------------------------------------------------
# the three chunk-parallel stages of the tensor-core route, in plain PyTorch
# (dts and da are ``_discretize``'s; la (b, L, H) and the per-chunk states
# (b, nc, H, P, N) are float32, as the kernels' workspaces)
# ---------------------------------------------------------------------------
def ssd_chunk_state_plain(x, dts, da, B, *, chunk: int):
    """K1, ``ssd_chunk_state``: la, the cumulative sum of da within each
    chunk in row order, (b, L, H); and each chunk's own addition to the
    state, ds = (x * exp(la_end - la) * dt)^T B, (b, nc, H, P, N)."""
    b, L, H, P = x.shape
    N, nc = B.shape[-1], L // chunk
    la = _chunk_cumsum(da, chunk)                             # (b, nc, Q, H)
    w = torch.exp(la[:, :, -1:] - la) * dts.reshape(b, nc, chunk, H)
    u = x.float().reshape(b, nc, chunk, H, P) * w[..., None]
    ds = torch.einsum("bctn,bcthp->bchpn",
                      B.float().reshape(b, nc, chunk, N), u)
    return la.reshape(b, L, H), ds


def ssd_state_scan_plain(la, ds, *, chunk: int, init_state=None):
    """K2, ``ssd_state_scan``: the state entering each chunk, (b, nc, H, P,
    N), and the final state, with S <- S * exp(la_end) + ds chunk after
    chunk, as ``ssd_chunked_plain`` carries it."""
    b, nc, H, P, N = ds.shape
    la_end = la.reshape(b, nc, chunk, H)[:, :, -1]            # (b, nc, H)
    S = (torch.zeros((b, H, P, N), dtype=torch.float32, device=ds.device)
         if init_state is None else init_state.float())
    s_in = torch.empty_like(ds)
    for c in range(nc):
        s_in[:, c] = S
        S = S * torch.exp(la_end[:, c])[..., None, None] + ds[:, c]
    return s_in, S


def ssd_chunk_out_plain(x, dts, la, B, C, D, s_in, *, chunk: int):
    """K3, ``ssd_chunk_out``: y of every chunk from the state entering it,
    in x's dtype, rounded once."""
    b, L, H, P = x.shape
    la = la.reshape(b, L // chunk, chunk, H)
    y = torch.empty_like(x)
    Df = D.float()[:, None]
    for c in range(L // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        y[:, rows] = _chunk_y(x[:, rows].float(), B[:, rows].float(),
                              C[:, rows].float(), dts[:, rows], la[:, c],
                              s_in[:, c], Df).to(x.dtype)
    return y


def _route(dtype, P: int, N: int, Q: int) -> str:
    """The route that takes a CUDA input of this dtype and shape: ``"tc"``
    (bf16, P a multiple of 64, N 64 or 128, Q a multiple of 64 up to 256)
    or ``"fma"`` (float32 or bf16, P a multiple of 32, N 64 or 128,
    Q <= 256). Raises on what neither takes."""
    if dtype == torch.bfloat16 and P % TC_STEP == 0 and N in KERNEL_N \
            and Q % TC_STEP == 0 and 0 < Q <= Q_MAX:
        return "tc"
    if dtype in _DTYPES and N in KERNEL_N and P % KERNEL_P_STEP == 0 \
            and 0 < Q <= Q_MAX:
        return "fma"
    raise ValueError(f"no SSD kernel takes {dtype} with P={P}, N={N}, Q={Q}: "
                     f"the tensor-core route takes bf16 with P a multiple of "
                     f"{TC_STEP}, N in {KERNEL_N} and Q a multiple of "
                     f"{TC_STEP} up to {Q_MAX}, the FMA kernel float32 or "
                     f"bf16 with P a multiple of {KERNEL_P_STEP}, N in "
                     f"{KERNEL_N} and Q <= {Q_MAX}")


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


def _cuda_inputs(name, x, B, C):
    """Checks shared by both routes on a CUDA input."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA tensor; got {x.device} "
                         "(ssd_chunked takes the plain version on the CPU)")
    if x.dtype not in _DTYPES or not (x.dtype == B.dtype == C.dtype):
        raise TypeError("x, B, C must share one dtype, float32 or bfloat16; "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    b, _, H, _ = x.shape
    if H > 65535 or b > 65535:
        raise ValueError(f"the kernels take b and H up to 65535; got {b}, {H}")


def ssd_chunked_fma(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """The FMA kernel on float32 or bf16 CUDA tensors (P a multiple of 32,
    N 64 or 128, Q <= 256), on the current stream; raises on anything
    else. ``ssd_chunked`` routes the bf16 shapes of the tensor-core route
    there instead."""
    Q = _check(x, dt, B, C, A_log, D, chunk, init_state)
    _cuda_inputs("ssd_chunked_fma", x, B, C)
    _route(x.dtype, x.shape[3], B.shape[-1], Q)   # raises on what it can't
    b, L, H, P = x.shape
    N = B.shape[-1]
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
        raise RuntimeError(f"ssd_chunked_fma launch failed: cudaError {err}")
    ssd_chunked_fma.launches += 1
    return y, s_out


@functools.cache
def _tc_fn():
    fn = _build.load("ssd_chunk_tc").ssd_chunk_tc_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 6 + [ctypes.c_int64] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tc_smem_bytes(Q: int, N: int) -> int:
    """Dynamic shared memory a block of ``ssd_chunk_out`` takes at chunk Q
    and state size N (builds the kernels' library)."""
    fn = _build.load("ssd_chunk_tc").ssd_chunk_out_smem
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(Q, N)


def _tc_launch(stages, dims, *, x=None, dts=None, da=None, B=None, C=None,
               D=None, s0=None, la, st, y=None, s_out=None):
    """One call of the C entry point: the kernels named in ``stages`` (K1,
    K2, K3 in that order) on the current stream, for dims (b, L, H, P, N,
    Q). A stage reads only its own tensors; the others may be None."""
    if la.device.type != "cuda":
        raise ValueError(f"the tensor-core SSD kernels run on CUDA tensors; "
                         f"got {la.device}")
    strides = [(0,) * n if t is None else _kernel_operand(name, t, n)
               for name, t, n in (("x", x, 3), ("B", B, 2), ("C", C, 2))]
    ptr = lambda t: None if t is None else t.data_ptr()        # noqa: E731
    stream = torch.cuda.current_stream(la.device).cuda_stream
    mask = sum(1 << i for i, n in enumerate(_STAGE_FNS) if n in stages)
    with torch.cuda.device(la.device):
        err = _tc_fn()(mask, ptr(x), ptr(dts), ptr(da), ptr(B), ptr(C),
                       ptr(D), ptr(s0), ptr(la), ptr(st), ptr(y), ptr(s_out),
                       *dims, *(v for t in strides for v in t), stream)
    if err != 0:
        raise RuntimeError(f"{'+'.join(stages)} launch failed: cudaError "
                           f"{err}")
    for n in stages:
        _STAGE_FNS[n].launches += 1


def _tc_dims(b, L, H, P, N, chunk, dtype=torch.bfloat16):
    """(b, L, H, P, N, Q) of an input the tensor-core kernels take; raises
    on anything else."""
    Q = min(chunk, L)
    if dtype != torch.bfloat16 or Q <= 0 or L % Q or H * b > 65535 \
            or _route(dtype, P, N, Q) != "tc":
        raise ValueError(f"the tensor-core SSD kernels take bf16 with P a "
                         f"multiple of {TC_STEP}, N in {KERNEL_N}, Q a "
                         f"multiple of {TC_STEP} up to {Q_MAX} dividing L, "
                         f"H * b <= 65535; got {dtype}, (b, L, H, P) "
                         f"{(b, L, H, P)}, N={N}, Q={Q}")
    return b, L, H, P, N, Q


def _f32(t):
    return None if t is None else t.float().contiguous()


def ssd_chunk_state(x, dts, da, B, *, chunk: int):
    """K1 alone on CUDA tensors -> (la (b, L, H), ds (b, nc, H, P, N)), as
    ``ssd_chunk_state_plain``."""
    if B.dtype != x.dtype:
        raise ValueError(f"B must be {x.dtype}; got {B.dtype}")
    dims = _tc_dims(*x.shape, B.shape[-1], chunk, x.dtype)
    b, L, H, P, N, Q = dims
    la = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
    st = torch.empty((b, L // Q, H, P, N), dtype=torch.float32,
                     device=x.device)
    _tc_launch(("ssd_chunk_state",), dims, x=x, dts=_f32(dts), da=_f32(da),
               B=B, la=la, st=st)
    return la, st


def ssd_state_scan(la, st, *, chunk: int, init_state=None):
    """K2 alone on CUDA tensors: ``st`` (b, nc, H, P, N), contiguous
    float32, holds each chunk's ds and is overwritten with the state
    entering each chunk; returns the final state, as
    ``ssd_state_scan_plain``."""
    b, nc, H, P, N = st.shape
    dims = _tc_dims(b, nc * chunk, H, P, N, chunk)
    if st.dtype != torch.float32 or not st.is_contiguous() \
            or tuple(la.shape) != (b, nc * chunk, H):
        raise ValueError(f"st must be contiguous float32 and la "
                         f"{(b, nc * chunk, H)}; got {st.dtype}, "
                         f"{tuple(la.shape)}")
    s_out = torch.empty((b, H, P, N), dtype=torch.float32, device=st.device)
    _tc_launch(("ssd_state_scan",), dims, s0=_f32(init_state), la=_f32(la),
               st=st, s_out=s_out)
    return s_out


def ssd_chunk_out(x, dts, la, B, C, D, s_in, *, chunk: int):
    """K3 alone on CUDA tensors -> y in x's dtype, from the state entering
    each chunk ``s_in`` (b, nc, H, P, N), as ``ssd_chunk_out_plain``."""
    if not (B.dtype == C.dtype == x.dtype):
        raise ValueError(f"B and C must be {x.dtype}; got {B.dtype}, "
                         f"{C.dtype}")
    dims = _tc_dims(*x.shape, B.shape[-1], chunk, x.dtype)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _tc_launch(("ssd_chunk_out",), dims, x=x, dts=_f32(dts), B=B, C=C,
               D=_f32(D), la=_f32(la), st=_f32(s_in), y=y)
    return y


def ssd_chunked_tc(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """The tensor-core route on bf16 CUDA tensors (P a multiple of 64, N 64
    or 128, Q a multiple of 64 up to 256): K1, K2 and K3 of
    ``csrc/ssd_chunk_tc.cu`` from one call, on the current stream, with
    float32 workspaces la (b, L, H) and st (b, nc, H, P, N); raises on
    anything else."""
    _check(x, dt, B, C, A_log, D, chunk, init_state)
    _cuda_inputs("ssd_chunked_tc", x, B, C)
    dims = _tc_dims(*x.shape, B.shape[-1], chunk, x.dtype)
    b, L, H, P, N, Q = dims
    dts, da = (t.contiguous() for t in _discretize(dt, A_log))
    la = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
    st = torch.empty((b, L // Q, H, P, N), dtype=torch.float32,
                     device=x.device)
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    _tc_launch(tuple(_STAGE_FNS), dims, x=x, dts=dts, da=da, B=B, C=C,
               D=_f32(D), s0=_f32(init_state), la=la, st=st, y=y,
               s_out=s_out)
    ssd_chunked_tc.launches += 1
    return y, s_out


_KERNELS = {"tc": ssd_chunked_tc, "fma": ssd_chunked_fma}
_STAGE_FNS = {"ssd_chunk_state": ssd_chunk_state,     # K1, K2, K3 in order
              "ssd_state_scan": ssd_state_scan,
              "ssd_chunk_out": ssd_chunk_out}


def ssd_chunked(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """SSD chunk scan -> (y (b, L, H, P) in x's dtype, final state
    (b, H, P, N) float32).

    On a CUDA tensor: the route that ``_route`` names, on the current
    stream. x, B and C may be strided views (last dimension contiguous,
    rows 16-byte aligned), as ``mamba_block`` slices them from the conv
    output; B and C must have x's dtype, float32 or bfloat16. On a CPU
    tensor: ``ssd_chunked_plain``."""
    Q = _check(x, dt, B, C, A_log, D, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, B, C, A_log, D, chunk=chunk,
                                 init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _cuda_inputs("ssd_chunked", x, B, C)
    out = _KERNELS[_route(x.dtype, x.shape[3], B.shape[-1], Q)](
        x, dt, B, C, A_log, D, chunk=chunk, init_state=init_state)
    ssd_chunked.launches += 1
    return out


ssd_chunked.launches = 0
ssd_chunked_tc.launches = 0
ssd_chunked_fma.launches = 0
ssd_chunk_state.launches = 0
ssd_state_scan.launches = 0
ssd_chunk_out.launches = 0
