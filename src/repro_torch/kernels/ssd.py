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
another. On a meta tensor (``launch/dryrun.py``) it, ``ssd_chunked_fwd``
and ``ssd_chunked_bwd`` run the CUDA routes' own wrappers, with their
checks and allocations, up to each launch, which the launch helpers
skip; each forward and each backward adds one call of the route's work
(``work``, ``bwd_work``: the formulas that ``chip_smoke.py``'s bounds
read) to the dry run's tally (``repro_torch/tally.py``). On a CUDA tensor
under grad it runs through ``_SsdChunked``: the
forward is the routed kernel, keeping la and the states entering the
chunks (the tensor-core route's own workspaces; the FMA kernel writes
them when asked), and the backward is ``ssd_chunked_bwd``, the route
that ``_bwd_route`` names: for float32 ``csrc/ssd_chunk_bwd.cu`` on FMA
(bK1 ``ssd_chunk_bwd_dstate``, bK2 ``ssd_chunk_bwd_scan``, bK3
``ssd_chunk_bwd_grads``), for bf16 ``csrc/ssd_chunk_bwd_tc.cu`` on bf16
tensor cores after the same bK1 (``ssd_chunk_bwd_tc_scan``, the scan with
a state split over blocks; ``ssd_chunk_bwd_tc_dgs``, the gradient of C B^T
summed over heads once per chunk; ``ssd_chunk_bwd_tc_dbdc``, dB and dC;
``ssd_chunk_bwd_tc_head``, dx, d dts and d da); the chain from
softplus(dt) and dt * a to dt and A_log stays with autograd. On the CPU
the plain version stays differentiable by autograd.
``ssd_chunked.launches`` counts its calls, each route's entry its
own calls, each of the three tensor-core kernels its own launches,
``ssd_chunked_bwd.launches`` the backward's calls and each backward entry
its launches. ``ssd_chunk_state_plain``, ``ssd_state_scan_plain`` and
``ssd_chunk_out_plain`` are the three forward kernels' functions in plain
PyTorch, composed they give ``ssd_chunked_plain``'s result;
``ssd_chunk_bwd_dstate_plain``, ``ssd_chunk_bwd_scan_plain`` and
``ssd_chunk_bwd_grads_plain`` the FMA backward's, and the
``ssd_chunk_bwd_tc_*_plain`` the tensor-core backward's, each route's
composed in ``ssd_chunked_bwd_plain`` (tests and ``chip_smoke.py``
only).

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

from .. import tally
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
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
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
    """Checks shared by both routes on a CUDA (or, in the dry run, meta)
    input."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on a CUDA tensor; got {x.device} "
                         "(ssd_chunked takes the plain version on the CPU)")
    if x.dtype not in _DTYPES or not (x.dtype == B.dtype == C.dtype):
        raise TypeError("x, B, C must share one dtype, float32 or bfloat16; "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    b, _, H, _ = x.shape
    if H > 65535 or b > 65535:
        raise ValueError(f"the kernels take b and H up to 65535; got {b}, {H}")


def _fwd_tally(route, x, dts, da, B, D, s0, Q):
    """One forward call of ``route`` on meta tensors, in the dry run's
    tally: the work of the inputs the route's kernel reads."""
    b, L, H, P = x.shape
    nbytes, flops = work(b, L, H, P, B.shape[-1], Q, x.element_size(),
                         dt_bytes=dts.nbytes + da.nbytes, param_bytes=D.nbytes,
                         init_bytes=0 if s0 is None else s0.nbytes)
    tally.kernel(f"ssd_chunked_{route}", flops, nbytes)


def _fma_run(x, dts, da, B, C, D, init_state, Q, states=False):
    """One launch of the FMA kernel, counted in
    ``ssd_chunked_fma.launches`` -> (y, final state, la, the states
    entering the chunks); with ``states`` the kernel also writes la (b, L,
    H) and the entering states (b, nc, H, P, N), float32, which the
    backward reads; else those two are None. On meta tensors (the dry run)
    no launch, one call in the tally."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    xs = _kernel_operand("x", x, 3)
    bs = _kernel_operand("B", B, 2)
    cs = _kernel_operand("C", C, 2)
    dts, da = dts.float().contiguous(), da.float().contiguous()
    Df = D.float().contiguous()
    s0 = _f32(init_state)
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    la = st = None
    if states:
        la = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
        st = torch.empty((b, L // Q, H, P, N), dtype=torch.float32,
                         device=x.device)
    if x.is_meta:
        _fwd_tally("fma", x, dts, da, B, Df, s0, Q)
        return y, s_out, la, st
    ptr = lambda t: None if t is None else t.data_ptr()        # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            _DTYPES[x.dtype], x.data_ptr(), dts.data_ptr(), da.data_ptr(),
            B.data_ptr(), C.data_ptr(), Df.data_ptr(), ptr(s0), y.data_ptr(),
            s_out.data_ptr(), ptr(la), ptr(st), b, L, H, P, N, Q, *xs, *bs,
            *cs, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunked_fma launch failed: cudaError {err}")
    ssd_chunked_fma.launches += 1
    return y, s_out, la, st


def ssd_chunked_fma(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """The FMA kernel on float32 or bf16 CUDA tensors (P a multiple of 32,
    N 64 or 128, Q <= 256), on the current stream; raises on anything
    else. ``ssd_chunked`` routes the bf16 shapes of the tensor-core route
    there instead."""
    Q = _check(x, dt, B, C, A_log, D, chunk, init_state)
    _cuda_inputs("ssd_chunked_fma", x, B, C)
    _route(x.dtype, x.shape[3], B.shape[-1], Q)   # raises on what it can't
    y, s_out, _, _ = _fma_run(x, *_discretize(dt, A_log), B, C, D,
                              init_state, Q)
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
    Q). A stage reads only its own tensors; the others may be None. On
    meta tensors (the dry run) it checks and returns with no launch."""
    if la.device.type not in ("cuda", "meta"):
        raise ValueError(f"the tensor-core SSD kernels run on CUDA tensors; "
                         f"got {la.device}")
    strides = [(0,) * n if t is None else _kernel_operand(name, t, n)
               for name, t, n in (("x", x, 3), ("B", B, 2), ("C", C, 2))]
    if la.is_meta:
        return
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


def _tc_run(x, dts, da, B, C, D, init_state, chunk):
    """K1, K2 and K3 from one call, counted in ``ssd_chunked_tc.launches``
    -> (y, final state, la, st), st holding the state entering each chunk
    after K2. On meta tensors (the dry run) no launch, one call in the
    tally."""
    dims = _tc_dims(*x.shape, B.shape[-1], chunk, x.dtype)
    b, L, H, P, N, Q = dims
    la = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
    st = torch.empty((b, L // Q, H, P, N), dtype=torch.float32,
                     device=x.device)
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    dts, da, D, s0 = _f32(dts), _f32(da), _f32(D), _f32(init_state)
    _tc_launch(tuple(_STAGE_FNS), dims, x=x, dts=dts, da=da, B=B, C=C, D=D,
               s0=s0, la=la, st=st, y=y, s_out=s_out)
    if x.is_meta:
        _fwd_tally("tc", x, dts, da, B, D, s0, Q)
    else:
        ssd_chunked_tc.launches += 1
    return y, s_out, la, st


def ssd_chunked_tc(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """The tensor-core route on bf16 CUDA tensors (P a multiple of 64, N 64
    or 128, Q a multiple of 64 up to 256): K1, K2 and K3 of
    ``csrc/ssd_chunk_tc.cu`` from one call, on the current stream, with
    float32 workspaces la (b, L, H) and st (b, nc, H, P, N); raises on
    anything else."""
    _check(x, dt, B, C, A_log, D, chunk, init_state)
    _cuda_inputs("ssd_chunked_tc", x, B, C)
    y, s_out, _, _ = _tc_run(x, *_discretize(dt, A_log), B, C, D, init_state,
                             chunk)
    return y, s_out


def ssd_chunked_fwd(x, dts, da, B, C, D, *, chunk: int, init_state=None):
    """The forward under grad on CUDA tensors, from the discretised dts and
    da (float32 (b, L, H)): the route that ``_route`` names -> (y, final
    state, la (b, L, H), the states entering the chunks (b, nc, H, P, N)),
    the last two float32 and kept for the backward (the tensor-core
    route's own workspaces; the FMA kernel writes them when asked)."""
    Q = min(chunk, x.shape[1])
    _cuda_inputs("ssd_chunked_fwd", x, B, C)
    if _route(x.dtype, x.shape[3], B.shape[-1], Q) == "tc":
        return _tc_run(x, dts, da, B, C, D, init_state, chunk)
    return _fma_run(x, dts, da, B, C, D, init_state, Q, states=True)


def ssd_chunked_fwd_plain(x, dts, da, B, C, D, *, chunk: int,
                          init_state=None):
    """``ssd_chunked_fwd`` in plain PyTorch: the three plain stages
    composed (tests stand it in for the kernels)."""
    la, ds = ssd_chunk_state_plain(x, dts, da, B, chunk=chunk)
    s_in, s_out = ssd_state_scan_plain(la, ds, chunk=chunk,
                                       init_state=init_state)
    y = ssd_chunk_out_plain(x, dts, la, B, C, D, s_in, chunk=chunk)
    return y, s_out, la, s_in


_KERNELS = {"tc": ssd_chunked_tc, "fma": ssd_chunked_fma}
_STAGE_FNS = {"ssd_chunk_state": ssd_chunk_state,     # K1, K2, K3 in order
              "ssd_state_scan": ssd_state_scan,
              "ssd_chunk_out": ssd_chunk_out}


# ---------------------------------------------------------------------------
# The work of a forward call (chip_smoke.py's bound and the dry run's tally
# read it)
# ---------------------------------------------------------------------------
def work(b, L, H, P, N, Q, esize, *, dt_bytes, param_bytes, init_bytes=0):
    """(bytes, FLOPs) of one forward call on x (b, L, H, P) and B, C (b, L,
    N) of element size ``esize``, chunk Q: every input read once (dt's
    side, ``dt_bytes``: dt, or the discretised dts and da; A_log and D,
    ``param_bytes``; an initial state, ``init_bytes``) and y and the
    float32 final state written once, against the products with C B^T
    counted once per (batch, chunk) (B and C are shared by the heads) and
    only the causal triangle of C B^T and W x."""
    nc, tri = L // Q, Q * (Q + 1) // 2
    nbytes = (2 * b * L * H * P * esize + 2 * b * L * N * esize + dt_bytes
              + param_bytes + init_bytes + b * H * P * N * 4)
    flops = 2.0 * b * nc * (tri * N + H * (tri * P + 2 * Q * P * N))
    return nbytes, flops


# ---------------------------------------------------------------------------
# the backward, in three stages (no TPU kernel: the reference's gradient is
# XLA's autodiff of the model zoo's ssd_chunked). With S_c the state
# entering chunk c and g_c the gradient of the state leaving it (the final
# state's gradient for the last chunk):
#   bK1  R_c     = sum_s exp(la_s) dy_s^T C_s                 (b, nc, H, P, N)
#   bK2  g_c-1   = exp(la_end) g_c + R_c, walked from the last chunk; the
#        gradient of init_state is g_-1; dle_c = exp(la_end) <g_c, S_c>
#   bK3  dx, d dts, d da, dB, dC and D's partial sums per chunk
# ---------------------------------------------------------------------------
def ssd_chunk_bwd_dstate_plain(dy, C, la, *, chunk: int):
    """bK1: each chunk's own addition to the gradient of the state
    entering it, R_c = sum_s exp(la_s) dy_s^T C_s, float32 (b, nc, H, P,
    N)."""
    b, L, H, P = dy.shape
    N, nc = C.shape[-1], L // chunk
    e = torch.exp(la.float()).reshape(b, nc, chunk, H)
    dyq = dy.float().reshape(b, nc, chunk, H, P) * e[..., None]
    return torch.einsum("bcshp,bcsn->bchpn", dyq,
                        C.float().reshape(b, nc, chunk, N))


def ssd_chunk_bwd_scan_plain(la, R, s_in, *, chunk: int, dstate=None):
    """bK2: the reverse scan over chunks -> (g (b, nc, H, P, N), the
    gradient of the state leaving each chunk; the gradient of init_state
    (b, H, P, N); dle (b, nc, H), exp(la_end) <g_c, S_c>, la_end's share
    from the state's decay), as ``ssd_state_scan_plain`` walks forward."""
    b, nc, H, P, N = R.shape
    la_end = la.reshape(b, nc, chunk, H)[:, :, -1]            # (b, nc, H)
    g = (torch.zeros((b, H, P, N), dtype=torch.float32, device=R.device)
         if dstate is None else dstate.float())
    gs = torch.empty_like(R)
    dle = torch.empty((b, nc, H), dtype=torch.float32, device=R.device)
    for c in range(nc - 1, -1, -1):
        decay = torch.exp(la_end[:, c])
        gs[:, c] = g
        dle[:, c] = decay * (g * s_in[:, c]).sum((-2, -1))
        g = g * decay[..., None, None] + R[:, c]
    return gs, g, dle


def ssd_chunk_bwd_grads_plain(x, dts, la, B, C, D, dy, s_in, g, dle, *,
                              chunk: int):
    """bK3: the per-chunk gradients from the state entering each chunk
    (``s_in``) and the gradient of the state leaving it (``g``) -> (dx in
    x's dtype, d dts and d da float32 (b, L, H), dB and dC in B's dtype
    (summed over the heads), dD float32 (H,)). d la gathers the intra-chunk
    exps, exp(la) C S^T, and the state update's exp(la_end - la) and
    exp(la_end) (``dle``); d da is its reverse cumulative sum within the
    chunk."""
    b, L, H, P = x.shape
    N, Q = B.shape[-1], chunk
    la = la.float().reshape(b, L // Q, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ddts = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
    dda = torch.empty_like(ddts)
    dD = torch.zeros((H,), dtype=torch.float32, device=x.device)
    Df = D.float()[:, None]
    for c in range(L // Q):
        rows = slice(c * Q, (c + 1) * Q)
        xq, dyq = x[:, rows].float(), dy[:, rows].float()      # (b, Q, H, P)
        Bq, Cq = B[:, rows].float(), C[:, rows].float()        # (b, Q, N)
        dtq, lq = dts[:, rows].float(), la[:, c]               # (b, Q, H)
        S, gc = s_in[:, c], g[:, c]                            # (b, H, P, N)
        seg = lq[:, :, None, :] - lq[:, None, :, :]            # (b, s, t, H)
        M = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                      float("-inf")))
        del seg
        GM = torch.einsum("bsn,btn->bst", Cq, Bq)[..., None] * M
        dW = torch.einsum("bshp,bthp->bsth", dyq, xq)          # dy_s . x_t
        dGs = (dW * M * dtq[:, None]).sum(-1)                  # over heads
        del M
        dWGM = dW * GM
        del dW
        gB = torch.einsum("btn,bhpn->bthp", Bq, gc)            # g B_t
        e_end = torch.exp(lq[:, -1:] - lq)                     # (b, Q, H)
        w = e_end * dtq
        dxq = torch.einsum("bsth,bshp->bthp", GM * dtq[:, None], dyq)
        dx[:, rows] = (dxq + w[..., None] * gB + Df * dyq).to(x.dtype)
        u = e_end * (xq * gB).sum(-1)
        ddts[:, rows] = dWGM.sum(1) + u
        v = dtq * u
        A = dWGM * dtq[:, None]
        del dWGM, GM
        CS = torch.einsum("bsn,bhpn->bshp", Cq, S)
        dla = A.sum(2) - A.sum(1) + torch.exp(lq) * (dyq * CS).sum(-1) - v
        dla[:, -1] += dle[:, c] + v.sum(1)
        dda[:, rows] = dla.flip(1).cumsum(1).flip(1)
        del A
        dC[:, rows] = (torch.einsum("bst,btn->bsn", dGs, Bq)
                       + torch.einsum("bsh,bshp,bhpn->bsn", torch.exp(lq),
                                      dyq, S)).to(C.dtype)
        dB[:, rows] = (torch.einsum("bst,bsn->btn", dGs, Cq)
                       + torch.einsum("bth,bthp,bhpn->btn", w, xq, gc)
                       ).to(B.dtype)
        dD += (dyq * xq).sum((0, 1, 3))
    return dx, ddts, dda, dB, dC, dD


def ssd_chunked_bwd_plain(x, dts, da, B, C, D, dy, dstate=None, *,
                          chunk: int, init_state=None, route="fma"):
    """The backward of the chunk scan in plain PyTorch, from the forward's
    own inputs (dts and da as ``_discretize`` gives them) and the
    gradients of y and of the final state (None for zero) -> (dx, d dts,
    d da, dB, dC, dD, d init_state): la and the entering states from the
    plain forward stages, then the plain versions of the launches of
    ``route``: ``"fma"`` bK1, bK2 and bK3 (``csrc/ssd_chunk_bwd.cu``),
    ``"tc"`` bK1, scan, dgs, dbdc and head (``csrc/ssd_chunk_bwd_tc.cu``).
    Not autograd of the plain forward: the kernels' decomposition, written
    out."""
    Q = min(chunk, x.shape[1])
    la, ds = ssd_chunk_state_plain(x, dts, da, B, chunk=Q)
    s_in, _ = ssd_state_scan_plain(la, ds, chunk=Q, init_state=init_state)
    return _BWD_RUNS[route](_BWD_PLAIN[route], x, dts, la, B, C, D, s_in,
                            dy, dstate, Q)


def ssd_chunked_bwd_stages_plain(x, dts, la, B, C, D, s_in, dy, dstate=None,
                                 *, chunk: int):
    """``ssd_chunked_bwd``'s three stages in plain PyTorch, on any device,
    from the forward's saved la and entering states (``ssd_chunked_bwd``
    takes it on a CPU tensor; tests and ``chip_smoke.py`` stand it in for
    the kernel on the card)."""
    return _bwd_stages(_BWD_PLAIN["fma"], x, dts, la, B, C, D, s_in, dy,
                       dstate, min(chunk, x.shape[1]))


def _bwd_stages(stages, x, dts, la, B, C, D, s_in, dy, dstate, Q):
    dstate_fn, scan_fn, grads_fn = stages
    R = dstate_fn(dy, C, la, chunk=Q)
    g, dinit, dle = scan_fn(la, R, s_in, chunk=Q, dstate=dstate)
    dx, ddts, dda, dB, dC, dD = grads_fn(x, dts, la, B, C, D, dy, s_in, g,
                                         dle, chunk=Q)
    return dx, ddts, dda, dB, dC, dD, dinit


def _slice_sums(t, size):
    """Sums of the last dimension in consecutive slices of ``size`` (the
    last one shorter where it does not divide), in slice order."""
    return torch.stack([t[..., i:i + size].sum(-1)
                        for i in range(0, t.shape[-1], size)], -1)


def ssd_chunk_bwd_tc_scan_plain(la, R, s_in, *, chunk: int, dstate=None):
    """The tensor-core route's scan: bK2's g and init_state's gradient, and
    <g_c, S_c> as partial sums over slices of BWD_SLICE entries of each
    (b, chunk, head) state, (b, nc, H, slices), without the decay (the
    head stage adds them in slice order and applies exp(la_end))."""
    g, dinit, _ = ssd_chunk_bwd_scan_plain(la, R, s_in, chunk=chunk,
                                           dstate=dstate)
    b, nc, H, P, N = g.shape
    return g, dinit, _slice_sums((g * s_in).reshape(b, nc, H, P * N),
                                 BWD_SLICE)


def ssd_chunk_bwd_tc_dgs_plain(x, dts, la, dy, *, chunk: int):
    """dGs = sum_h dW_h * M_h * dts_h on the causal triangle of each chunk,
    float32 (b, nc, Q, Q), zero above the diagonal: the head-summed
    gradient of C B^T."""
    b, L, H, P = x.shape
    Q, nc = chunk, L // chunk
    la = la.float().reshape(b, nc, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    out = torch.empty((b, nc, Q, Q), dtype=torch.float32, device=x.device)
    for c in range(nc):
        rows = slice(c * Q, (c + 1) * Q)
        lq = la[:, c]
        M = torch.exp((lq[:, :, None, :] - lq[:, None, :, :]).masked_fill(
            ~causal[None, :, :, None], float("-inf")))
        dW = torch.einsum("bshp,bthp->bsth", dy[:, rows].float(),
                          x[:, rows].float())
        out[:, c] = (dW * M * dts[:, rows].float()[:, None]).sum(-1)
    return out


def ssd_chunk_bwd_tc_dbdc_plain(x, dts, la, B, C, dy, s_in, g, dgs, *,
                                chunk: int):
    """dB and dC in B's dtype from the head-summed dGs: dC = dGs B +
    sum_h exp(la) dy S_c, dB = dGs^T C + sum_h w x g_c, w = exp(la_end -
    la) dts; and the row sums qc = sum_n C (dy S_c) and xg = sum_n B (x
    g_c), float32 (boxes, b, L, H), one partial a box of BWD_BOX state
    columns (the head stage adds them in box order)."""
    b, L, H, P = x.shape
    N, Q = B.shape[-1], chunk
    la = la.float().reshape(b, L // Q, Q, H)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    nbox = -(-N // BWD_BOX)
    qc = torch.empty((nbox, b, L, H), dtype=torch.float32, device=x.device)
    xg = torch.empty_like(qc)
    for c in range(L // Q):
        rows = slice(c * Q, (c + 1) * Q)
        xq, dyq = x[:, rows].float(), dy[:, rows].float()
        Bq, Cq = B[:, rows].float(), C[:, rows].float()
        lq, dtq = la[:, c], dts[:, rows].float()
        w = torch.exp(lq[:, -1:] - lq) * dtq
        dyS = torch.einsum("bshp,bhpn->bshn", dyq, s_in[:, c])
        xG = torch.einsum("bthp,bhpn->bthn", xq, g[:, c])
        dC[:, rows] = (torch.einsum("bst,btn->bsn", dgs[:, c], Bq)
                       + torch.einsum("bsh,bshn->bsn", torch.exp(lq), dyS)
                       ).to(C.dtype)
        dB[:, rows] = (torch.einsum("bst,bsn->btn", dgs[:, c], Cq)
                       + torch.einsum("bth,bthn->btn", w, xG)).to(B.dtype)
        qc[:, :, rows] = _slice_sums(dyS * Cq[:, :, None], BWD_BOX
                                     ).permute(3, 0, 1, 2)
        xg[:, :, rows] = _slice_sums(xG * Bq[:, :, None], BWD_BOX
                                     ).permute(3, 0, 1, 2)
    return dB, dC, qc, xg


def ssd_chunk_bwd_tc_head_plain(x, dts, la, B, C, D, dy, g, dlep, qc, xg, *,
                                chunk: int):
    """The per-head gradients: dx in x's dtype, d dts and d da float32 (b,
    L, H), D's partial sums dy.x (b, nc, H); the state's and C S^T's terms
    of d la and d dts from the dbdc stage's row sums (qc, xg) and the
    scan's slices of <g, S> (dlep)."""
    b, L, H, P = x.shape
    Q = chunk
    la = la.float().reshape(b, L // Q, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dx = torch.empty_like(x)
    ddts = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
    dda = torch.empty_like(ddts)
    dDp = torch.empty((b, L // Q, H), dtype=torch.float32, device=x.device)
    qs, xs = qc.sum(0), xg.sum(0)
    Df = D.float()[:, None]
    for c in range(L // Q):
        rows = slice(c * Q, (c + 1) * Q)
        xq, dyq = x[:, rows].float(), dy[:, rows].float()
        Bq, Cq = B[:, rows].float(), C[:, rows].float()
        dtq, lq = dts[:, rows].float(), la[:, c]
        M = torch.exp((lq[:, :, None, :] - lq[:, None, :, :]).masked_fill(
            ~causal[None, :, :, None], float("-inf")))
        GM = torch.einsum("bsn,btn->bst", Cq, Bq)[..., None] * M
        del M
        dWGM = torch.einsum("bshp,bthp->bsth", dyq, xq) * GM
        gB = torch.einsum("btn,bhpn->bthp", Bq, g[:, c])
        e_end = torch.exp(lq[:, -1:] - lq)
        dxq = torch.einsum("bsth,bshp->bthp", GM * dtq[:, None], dyq)
        dx[:, rows] = (dxq + (e_end * dtq)[..., None] * gB
                       + Df * dyq).to(x.dtype)
        u = e_end * xs[:, rows]
        ddts[:, rows] = dWGM.sum(1) + u
        v = dtq * u
        A = dWGM * dtq[:, None]
        del dWGM, GM
        dla = A.sum(2) - A.sum(1) + torch.exp(lq) * qs[:, rows] - v
        dla[:, -1] += torch.exp(lq[:, -1]) * dlep[:, c].sum(-1) + v.sum(1)
        dda[:, rows] = dla.flip(1).cumsum(1).flip(1)
        dDp[:, c] = (dyq * xq).sum((1, 3))
    return dx, ddts, dda, dDp


def _bwd_tc_stages(stages, x, dts, la, B, C, D, s_in, dy, dstate, Q):
    """The tensor-core route's five launches (bK1, scan, dgs, dbdc, head),
    or their plain versions, composed."""
    dstate_fn, scan_fn, dgs_fn, dbdc_fn, head_fn = stages
    R = dstate_fn(dy, C, la, chunk=Q)
    g, dinit, dlep = scan_fn(la, R, s_in, chunk=Q, dstate=dstate)
    dgs = dgs_fn(x, dts, la, dy, chunk=Q)
    dB, dC, qc, xg = dbdc_fn(x, dts, la, B, C, dy, s_in, g, dgs, chunk=Q)
    dx, ddts, dda, dDp = head_fn(x, dts, la, B, C, D, dy, g, dlep, qc, xg,
                                 chunk=Q)
    return dx, ddts, dda, dB, dC, dDp.sum((0, 1)), dinit


BWD_P = 64                       # the backward kernels' head dim
BWD_SLICE = 1024                 # state entries of a block of the tc scan
BWD_BOX = 64                     # state columns of a tc dbdc block


def _bwd_route(dtype, P: int, N: int, Q: int) -> str:
    """The backward kernel that takes a CUDA input of this dtype and shape
    (P 64, N 64 or 128, Q a multiple of 64 up to 256: mamba2-780m's and
    zamba2-7b's mixers): ``"tc"`` for bf16 (``csrc/ssd_chunk_bwd_tc.cu``,
    bf16 tensor cores) and ``"fma"`` for float32
    (``csrc/ssd_chunk_bwd.cu``, float32 FMA). Raises on anything else."""
    if P == BWD_P and N in KERNEL_N and Q % TC_STEP == 0 \
            and 0 < Q <= Q_MAX:
        if dtype == torch.bfloat16:
            return "tc"
        if dtype == torch.float32:
            return "fma"
    raise ValueError(f"no SSD backward kernel takes {dtype} with P={P}, "
                     f"N={N}, Q={Q}: the tensor-core backward takes bf16 "
                     f"and the FMA backward float32, with P {BWD_P}, N in "
                     f"{KERNEL_N} and Q a multiple of {TC_STEP} up to "
                     f"{Q_MAX} (64-row tiles, no ragged edge)")


@functools.cache
def _bwd_fn():
    fn = _build.load("ssd_chunk_bwd").ssd_chunk_bwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 6 + [ctypes.c_int64] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bwd_smem_bytes(N: int) -> dict:
    """Dynamic shared memory of each backward launch of both routes at
    state size N (Q 256; builds the kernels' libraries)."""
    out = {}
    for src, names in (("ssd_chunk_bwd", BWD_ENTRIES),
                       ("ssd_chunk_bwd_tc", BWD_TC_ENTRIES)):
        fn = getattr(_build.load(src), f"{src}_smem")
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        out.update({name: fn(i, 256, N) for i, name in enumerate(names)})
    return out


def _bwd_checks(name, dims, dtype, la, x, B, C, dy):
    """The checks shared by both backward kernels' launches, for dims (b,
    L, H, P, N, Q) and x's dtype -> (the device, the element strides of x,
    B and C, zeros for a None)."""
    b, L, H, P, N, Q = dims
    dev = la.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on a CUDA tensor; got {dev} "
                         "(ssd_chunked_bwd takes the plain version on the "
                         "CPU)")
    if Q <= 0 or L % Q:
        raise ValueError(f"L={L} is not divisible by chunk {Q}")
    _bwd_route(dtype, P, N, Q)
    if H > 65535 or b > 65535:
        raise ValueError(f"{name} takes b and H up to 65535; got {b}, {H}")
    for label, t in (("x", x), ("B", B), ("C", C), ("dy", dy)):
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}; got {t.dtype}")
    return dev, [(0,) * n if t is None else _kernel_operand(label, t, n)
                 for label, t, n in (("x", x, 3), ("B", B, 2), ("C", C, 2))]


def _bwd_launch(stage: str, dims, dtype, *, x=None, dts=None, la=None,
                B=None, C=None, D=None, dy=None, st=None, gbuf=None,
                dstate=None, dinit=None, dle=None, dx=None, ddts=None,
                dda=None, dB=None, dC=None, dDp=None):
    """One entry of ``csrc/ssd_chunk_bwd.cu`` on the current stream, for
    dims (b, L, H, P, N, Q) and x's dtype, counted in its ``.launches``. A
    stage reads only its own tensors; the others may be None. On meta
    tensors (the dry run) it checks and returns with no launch."""
    name = f"ssd_chunk_bwd_{stage}"
    dev, strides = _bwd_checks(name, dims, dtype, la, x, B, C, dy)
    if dev.type == "meta":
        return
    ptr = lambda t: None if t is None else t.data_ptr()        # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _bwd_fn()(
            BWD_ENTRIES.index(name), _DTYPES[dtype], ptr(x), ptr(dts),
            ptr(la), ptr(B), ptr(C), ptr(D), ptr(dy), ptr(st), ptr(gbuf),
            ptr(dstate), ptr(dinit), ptr(dle), ptr(dx), ptr(ddts), ptr(dda),
            ptr(dB), ptr(dC), ptr(dDp), *dims,
            *(v for t in strides for v in t), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _BWD_ENTRY_FNS[name].launches += 1


def ssd_chunk_bwd_dstate(dy, C, la, *, chunk: int):
    """bK1 alone on CUDA tensors -> R (b, nc, H, P, N) float32, as
    ``ssd_chunk_bwd_dstate_plain``."""
    b, L, H, P = dy.shape
    dims = (b, L, H, P, C.shape[-1], min(chunk, L))
    R = torch.empty((b, L // dims[5], H, P, dims[4]), dtype=torch.float32,
                    device=dy.device)
    _bwd_launch("dstate", dims, dy.dtype, la=_f32(la), C=C, dy=dy.contiguous(),
                gbuf=R)
    return R


def ssd_chunk_bwd_scan(la, R, s_in, *, chunk: int, dstate=None):
    """bK2 alone on CUDA tensors: ``R`` (b, nc, H, P, N), contiguous
    float32, holds bK1's sums and is overwritten with g, the gradient of
    the state leaving each chunk; returns (R, the gradient of init_state,
    dle), as ``ssd_chunk_bwd_scan_plain``."""
    b, nc, H, P, N = R.shape
    if R.dtype != torch.float32 or not R.is_contiguous() \
            or tuple(s_in.shape) != tuple(R.shape) \
            or tuple(la.shape) != (b, nc * chunk, H):
        raise ValueError(f"R must be contiguous float32, s_in {tuple(R.shape)}"
                         f" and la {(b, nc * chunk, H)}; got {R.dtype}, "
                         f"{tuple(s_in.shape)}, {tuple(la.shape)}")
    dinit = torch.empty((b, H, P, N), dtype=torch.float32, device=R.device)
    dle = torch.empty((b, nc, H), dtype=torch.float32, device=R.device)
    _bwd_launch("scan", (b, nc * chunk, H, P, N, chunk), torch.float32,
                la=_f32(la), st=_f32(s_in), gbuf=R,
                dstate=None if dstate is None else _f32(dstate),
                dinit=dinit, dle=dle)
    return R, dinit, dle


def ssd_chunk_bwd_grads(x, dts, la, B, C, D, dy, s_in, g, dle, *,
                        chunk: int):
    """bK3 alone on CUDA tensors -> (dx, d dts, d da, dB, dC, dD), as
    ``ssd_chunk_bwd_grads_plain``; dD from per-(batch, chunk) partial sums
    added in a fixed order."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    dims = (b, L, H, P, N, min(chunk, L))
    dx = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    dB = torch.empty((b, L, N), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, L, N), dtype=C.dtype, device=x.device)
    ddts = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
    dda = torch.empty_like(ddts)
    dDp = torch.empty((b, L // dims[5], H), dtype=torch.float32,
                      device=x.device)
    _bwd_launch("grads", dims, x.dtype, x=x, dts=_f32(dts), la=_f32(la),
                B=B, C=C, D=_f32(D), dy=dy.contiguous(), st=_f32(s_in),
                gbuf=_f32(g), dle=_f32(dle), dx=dx, ddts=ddts, dda=dda,
                dB=dB, dC=dC, dDp=dDp)
    return dx, ddts, dda, dB, dC, dDp.sum((0, 1))


@functools.cache
def _bwd_tc_fn():
    fn = _build.load("ssd_chunk_bwd_tc").ssd_chunk_bwd_tc
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 22
                   + [ctypes.c_int] * 6 + [ctypes.c_int64] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bwd_tc_launch(stage: str, dims, *, x=None, dts=None, la=None, B=None,
                   C=None, D=None, dy=None, st=None, R=None, g=None,
                   dstate=None, dinit=None, dlep=None, dgs=None, dB=None,
                   dC=None, qc=None, xg=None, dx=None, ddts=None, dda=None,
                   dDp=None):
    """One launch of ``csrc/ssd_chunk_bwd_tc.cu`` on the current stream,
    for dims (b, L, H, P, N, Q) of bf16 inputs, counted in its
    ``.launches``. A stage reads only its own tensors; the others may be
    None. On meta tensors (the dry run) it checks and returns with no
    launch."""
    name = f"ssd_chunk_bwd_tc_{stage}"
    dev, strides = _bwd_checks(name, dims, torch.bfloat16, la, x, B, C, dy)
    if dev.type == "meta":
        return
    ptr = lambda t: None if t is None else t.data_ptr()        # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _bwd_tc_fn()(
            BWD_TC_ENTRIES.index(name), ptr(x), ptr(dts), ptr(la), ptr(B),
            ptr(C), ptr(D), ptr(dy), ptr(st), ptr(R), ptr(g), ptr(dstate),
            ptr(dinit), ptr(dlep), ptr(dgs), ptr(dB), ptr(dC), ptr(qc),
            ptr(xg), ptr(dx), ptr(ddts), ptr(dda), ptr(dDp), *dims,
            *(v for t in strides for v in t), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")
    _BWD_ENTRY_FNS[name].launches += 1


def ssd_chunk_bwd_tc_scan(la, R, s_in, *, chunk: int, dstate=None):
    """The tensor-core route's scan alone on CUDA tensors: ``R`` (b, nc, H,
    P, N), contiguous float32, holds bK1's sums and is overwritten with g;
    returns (R, the gradient of init_state, the slices of <g, S>), as
    ``ssd_chunk_bwd_tc_scan_plain``."""
    b, nc, H, P, N = R.shape
    if R.dtype != torch.float32 or not R.is_contiguous() \
            or tuple(s_in.shape) != tuple(R.shape) \
            or tuple(la.shape) != (b, nc * chunk, H):
        raise ValueError(f"R must be contiguous float32, s_in {tuple(R.shape)}"
                         f" and la {(b, nc * chunk, H)}; got {R.dtype}, "
                         f"{tuple(s_in.shape)}, {tuple(la.shape)}")
    dinit = torch.empty((b, H, P, N), dtype=torch.float32, device=R.device)
    dlep = torch.empty((b, nc, H, P * N // BWD_SLICE), dtype=torch.float32,
                       device=R.device)
    _bwd_tc_launch("scan", (b, nc * chunk, H, P, N, chunk), la=_f32(la),
                   st=_f32(s_in), R=R, g=R,
                   dstate=None if dstate is None else _f32(dstate),
                   dinit=dinit, dlep=dlep)
    return R, dinit, dlep


def ssd_chunk_bwd_tc_dgs(x, dts, la, dy, *, chunk: int):
    """dgs alone on CUDA tensors -> dGs (b, nc, Q, Q) float32, as
    ``ssd_chunk_bwd_tc_dgs_plain`` on the causal tiles (the tiles above the
    diagonal are not written)."""
    b, L, H, P = x.shape
    Q = min(chunk, L)
    dgs = torch.empty((b, L // Q, Q, Q), dtype=torch.float32,
                      device=x.device)
    # N does not enter dgs; BWD_BOX stands in for it
    _bwd_tc_launch("dgs", (b, L, H, P, BWD_BOX, Q), x=x, dts=_f32(dts),
                   la=_f32(la), dy=dy.contiguous(), dgs=dgs)
    return dgs


def ssd_chunk_bwd_tc_dbdc(x, dts, la, B, C, dy, s_in, g, dgs, *,
                          chunk: int):
    """dbdc alone on CUDA tensors -> (dB, dC, qc, xg), as
    ``ssd_chunk_bwd_tc_dbdc_plain``."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    dims = (b, L, H, P, N, min(chunk, L))
    dB = torch.empty((b, L, N), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, L, N), dtype=C.dtype, device=x.device)
    qc = torch.empty((N // BWD_BOX, b, L, H), dtype=torch.float32,
                     device=x.device)
    xg = torch.empty_like(qc)
    _bwd_tc_launch("dbdc", dims, x=x, dts=_f32(dts), la=_f32(la), B=B, C=C,
                   dy=dy.contiguous(), st=_f32(s_in), g=_f32(g),
                   dgs=_f32(dgs), dB=dB, dC=dC, qc=qc, xg=xg)
    return dB, dC, qc, xg


def ssd_chunk_bwd_tc_head(x, dts, la, B, C, D, dy, g, dlep, qc, xg, *,
                          chunk: int):
    """head alone on CUDA tensors -> (dx, d dts, d da, D's partial sums
    (b, nc, H)), as ``ssd_chunk_bwd_tc_head_plain``."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    dims = (b, L, H, P, N, min(chunk, L))
    dx = torch.empty((b, L, H, P), dtype=x.dtype, device=x.device)
    ddts = torch.empty((b, L, H), dtype=torch.float32, device=x.device)
    dda = torch.empty_like(ddts)
    dDp = torch.empty((b, L // dims[5], H), dtype=torch.float32,
                      device=x.device)
    _bwd_tc_launch("head", dims, x=x, dts=_f32(dts), la=_f32(la), B=B, C=C,
                   D=_f32(D), dy=dy.contiguous(), g=_f32(g), dlep=_f32(dlep),
                   qc=_f32(qc), xg=_f32(xg), dx=dx, ddts=ddts, dda=dda,
                   dDp=dDp)
    return dx, ddts, dda, dDp


BWD_ENTRIES = ("ssd_chunk_bwd_dstate", "ssd_chunk_bwd_scan",
               "ssd_chunk_bwd_grads")
BWD_TC_ENTRIES = ("ssd_chunk_bwd_tc_scan", "ssd_chunk_bwd_tc_dgs",
                  "ssd_chunk_bwd_tc_dbdc", "ssd_chunk_bwd_tc_head")
_BWD_PLAIN = {
    "fma": (ssd_chunk_bwd_dstate_plain, ssd_chunk_bwd_scan_plain,
            ssd_chunk_bwd_grads_plain),
    "tc": (ssd_chunk_bwd_dstate_plain, ssd_chunk_bwd_tc_scan_plain,
           ssd_chunk_bwd_tc_dgs_plain, ssd_chunk_bwd_tc_dbdc_plain,
           ssd_chunk_bwd_tc_head_plain)}
# each route's launches in order; the tc route shares bK1 with the FMA one
_BWD_KERNELS = {"fma": (ssd_chunk_bwd_dstate, ssd_chunk_bwd_scan,
                        ssd_chunk_bwd_grads),
                "tc": (ssd_chunk_bwd_dstate, ssd_chunk_bwd_tc_scan,
                       ssd_chunk_bwd_tc_dgs, ssd_chunk_bwd_tc_dbdc,
                       ssd_chunk_bwd_tc_head)}
_BWD_ENTRY_FNS = {f.__name__: f for fs in _BWD_KERNELS.values() for f in fs}
_BWD_RUNS = {"fma": _bwd_stages, "tc": _bwd_tc_stages}


def bwd_run(route, x, dts, la, B, C, D, s_in, dy, dstate=None, *,
            chunk: int):
    """The launches of backward route ``route`` on CUDA tensors (the
    FMA route also takes bf16: ``chip_smoke.py`` times it on the tc
    route's input) -> (dx, d dts, d da, dB, dC, dD, d init_state)."""
    return _BWD_RUNS[route](_BWD_KERNELS[route], x, dts, la, B, C, D, s_in,
                            dy, dstate, min(chunk, x.shape[1]))


def bwd_work(b, L, H, P, N, Q, esize, part="all"):
    """(bytes, FLOPs) of the chunk scan's backward (``part`` "all") or of
    one of its launches (the FMA route's "dstate", "scan", "grads"; the
    tensor-core route's "tc_scan", "tc_dgs", "tc_dbdc", "tc_head") on x
    (b, L, H, P) and B, C (b, L, N) of element size ``esize``, chunk Q:
    the bytes of each input read once and each output written once (the
    whole: x, dy, B, C, dts, la and the entering states in, dx, dB, dC, d
    dts, d da and init_state's gradient out; a launch also its
    workspaces), against its products (bK1 dy^T C per head; bK3 C B^T,
    (sum_h dG) B and (sum_h dG)^T C on the causal triangle once per
    (batch, chunk), and per head dW and W^T dy on the triangle, C S^T, dy
    S, g B and x g; of these, tc_dgs dW per head, tc_dbdc the two dG
    products and dy S and x g, tc_head C B^T once per (batch, chunk), dW,
    W^T dy and g B per head)."""
    nc, tri = L // Q, Q * (Q + 1) // 2
    xs, bs, rows = b * L * H * P * esize, b * L * N * esize, b * L * H * 4
    st, fin = b * nc * H * P * N * 4, b * H * P * N * 4
    f1 = 2.0 * b * nc * H * Q * P * N
    f2 = 3.0 * b * nc * H * P * N
    f3 = 2.0 * b * nc * (3 * tri * N + H * (2 * tri * P + 4 * Q * P * N))
    nbox, nt = -(-N // BWD_BOX), Q // TC_STEP
    dgs = b * nc * (nt * (nt + 1) // 2) * 64 * 64 * 4  # causal tiles of dGs
    slices = b * nc * H * -(-P * N // BWD_SLICE) * 4
    return {
        "all": (3 * xs + 4 * bs + 4 * rows + st + fin, f1 + f2 + f3),
        "dstate": (xs + bs + rows + st, f1),
        "scan": (3 * st + fin + b * nc * H * 4 * 2, f2),
        "grads": (3 * xs + 4 * bs + 4 * rows + 2 * st, f3),
        # the tensor-core route's launches: its workspaces dGs, the row
        # sums qc and xg (nbox partials each) and the slices of <g, S>
        "tc_scan": (3 * st + fin + b * nc * H * 4 + slices, f2),
        "tc_dgs": (2 * xs + 2 * rows + dgs, 2.0 * b * nc * H * tri * P),
        "tc_dbdc": (2 * xs + 4 * bs + 2 * rows + 2 * st + dgs
                    + 2 * nbox * rows,
                    2.0 * b * nc * (2 * tri * N + 2 * H * Q * P * N)),
        "tc_head": (3 * xs + 2 * bs + 4 * rows + st + 2 * nbox * rows
                    + slices + b * nc * H * 4,
                    2.0 * b * nc * (tri * N + H * (2 * tri * P
                                                   + Q * P * N)))}[part]


def ssd_chunked_bwd(x, dts, la, B, C, D, s_in, dy, dstate=None, *,
                    chunk: int):
    """Backward of the chunk scan from the forward's inputs, its la (b, L,
    H) and the states entering the chunks ``s_in`` (b, nc, H, P, N) ->
    (dx, d dts, d da, dB, dC, dD, d init_state); ``dstate``, the final
    state's gradient, may be None (zero).

    On a CUDA tensor: the launches of the route that ``_bwd_route`` names,
    on the current stream (bf16: bK1, then the tensor-core scan, dgs, dbdc
    and head; float32: bK1, bK2 and bK3 on FMA; no atomics: two calls give
    the same bits). On a CPU tensor: the FMA route's three plain stages.
    On a meta tensor: the same launches' checks and allocations with no
    launch, one call of the route's work in the dry run's tally."""
    Q = min(chunk, x.shape[1])
    if x.device.type == "cpu":
        out = ssd_chunked_bwd_stages_plain(x, dts, la, B, C, D, s_in, dy,
                                           dstate, chunk=Q)
    elif x.device.type in ("cuda", "meta"):
        route = _bwd_route(x.dtype, x.shape[3], B.shape[-1], Q)
        out = bwd_run(route, x, dts, la, B, C, D, s_in, dy, dstate, chunk=Q)
        if x.is_meta:
            nbytes, flops = bwd_work(*x.shape, B.shape[-1], Q,
                                     x.element_size())
            tally.kernel(f"ssd_chunked_bwd_{route}", flops, nbytes)
        else:
            ssd_chunked_bwd.launches += 1
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out


class _SsdChunked(torch.autograd.Function):
    """The chunk scan with a gradient, from the discretised dts and da: the
    forward is ``ssd_chunked_fwd`` (the routed kernel, keeping la and the
    entering states), the backward ``ssd_chunked_bwd``. Both are looked up
    in this module when called, so a caller may stand the plain versions
    in for them. The chain from dts and da to dt and A_log stays with
    autograd (``_discretize``)."""

    @staticmethod
    def forward(ctx, chunk, x, dts, da, B, C, D, init_state):
        y, s_out, la, s_in = ssd_chunked_fwd(x, dts, da, B, C, D,
                                             chunk=chunk,
                                             init_state=init_state)
        ctx.save_for_backward(x, dts, B, C, D, la, s_in)
        ctx.chunk, ctx.has_init = chunk, init_state is not None
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dts, B, C, D, la, s_in = ctx.saved_tensors
        dx, ddts, dda, dB, dC, dD, dinit = ssd_chunked_bwd(
            x, dts, la, B, C, D, s_in, dy, dstate, chunk=ctx.chunk)
        return (None, dx, ddts, dda, dB, dC, dD.to(D.dtype),
                dinit if ctx.has_init else None)


def ssd_chunked(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """SSD chunk scan -> (y (b, L, H, P) in x's dtype, final state
    (b, H, P, N) float32).

    On a CUDA tensor: the route that ``_route`` names, on the current
    stream; under grad through ``_SsdChunked``, whose backward is the
    hand-written ``csrc/ssd_chunk_bwd.cu``. x, B and C may be strided
    views (last dimension contiguous, rows 16-byte aligned), as
    ``mamba_block`` slices them from the conv output; B and C must have
    x's dtype, float32 or bfloat16. On a CPU tensor:
    ``ssd_chunked_plain``, differentiable by autograd. On a meta tensor:
    the same route with no launch (the dry run)."""
    Q = _check(x, dt, B, C, A_log, D, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, B, C, A_log, D, chunk=chunk,
                                 init_state=init_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    _cuda_inputs("ssd_chunked", x, B, C)
    kernel = _KERNELS[_route(x.dtype, x.shape[3], B.shape[-1], Q)]
    inputs = (x, dt, B, C, A_log, D, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        _bwd_route(x.dtype, x.shape[3], B.shape[-1], Q)  # raise up front
        dts, da = _discretize(dt, A_log)
        out = _SsdChunked.apply(chunk, x, dts, da, B, C, D, init_state)
    else:
        out = kernel(x, dt, B, C, A_log, D, chunk=chunk,
                     init_state=init_state)
    if not x.is_meta:
        ssd_chunked.launches += 1
    return out


ssd_chunked.launches = 0
ssd_chunked_tc.launches = 0
ssd_chunked_fma.launches = 0
ssd_chunk_state.launches = 0
ssd_state_scan.launches = 0
ssd_chunk_out.launches = 0
ssd_chunked_bwd.launches = 0
ssd_chunk_bwd_dstate.launches = 0
ssd_chunk_bwd_scan.launches = 0
ssd_chunk_bwd_grads.launches = 0
ssd_chunk_bwd_tc_scan.launches = 0
ssd_chunk_bwd_tc_dgs.launches = 0
ssd_chunk_bwd_tc_dbdc.launches = 0
ssd_chunk_bwd_tc_head.launches = 0
