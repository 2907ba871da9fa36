#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Phases, each ending in ``torch.cuda.synchronize()``; any fault or mismatch
raises and the script exits non-zero:

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for sm_90a (one ``nvcc`` per source, started together);
2. hold the two SpMM kernels against their plain PyTorch versions on the
   card: the row-wise CSR kernel (the GCN path's) at the path's shape
   (ogbn-arxiv, 170,000 vertices, int32 CSR, N = 128), at N = 100 there,
   and at edge shapes (N = 64/100/256, empty rows and a row of 1,000
   non-zeros, one non-zero, M != K), also against ``torch.sparse.mm`` at
   the path's shape, with two calls bit for bit equal and the CSR compacted
   from the blocked-ELL operand giving the same product bit for bit; the
   blocked-ELL kernel (the TPU kernel's literal interface, off the path)
   at ogbn-arxiv (bm = bk = 16, N = 128 and 100) and at edge shapes. Each
   with its time at the path's shape, the plain version's, the bound of
   the work (the CSR's bytes) and one library call's as a yardstick
   (``torch.sparse.mm``, never used by the port);
3. drive the GCN path: DYPE-scheduled 2-layer GCN serving on ogbn-arxiv at
   full size, 8 requests through the 4-stage pipeline, with the launch
   counters set to 0 just before and read just after (16 launches of the
   CSR kernel, 0 of the blocked-ELL kernel);
4. check the served output against a CPU computation of the same GCN on the
   same inputs;
5. hold the two banded SWA kernels against their plain version: the
   wgmma kernel (bf16, D 64/128; the prefill path's) and the FMA kernel
   (float32, and bf16 with D 256), each where ``swa_attention`` routes,
   at the prefill path's shape (q (2, 32, 16384, 128), k/v (2, 8, 16384,
   128), window 4096, read in place from (B, S, H, D) activations;
   float32, then bf16) and at edge shapes (S/window (256,128), (384,128),
   (512,256), (256,256), (128,128); D 64/128; GQA group 1/4/8; float32
   and bf16; and D 256), with the same numbers; on the bf16 main-shape
   input the wgmma kernel, the FMA kernel and the yardstick, PyTorch's
   memory-efficient SDPA with the band as a mask, are timed, and the
   wgmma kernel's registers, spills and shared memory are recorded;
6. drive the SWA prefill path: qwen3-4b with sliding-window attention
   (window 4096) at full width and depth, 2 requests x 16,384 tokens,
   launch counters set to 0 just before and read just after (36 launches
   of the wgmma kernel, 0 of the FMA kernel, 0 of either SpMM kernel);
7. check the served prefill against the plain attention: rerun the served
   forward with every kernel call also computed by the plain version on
   the same inputs and held to it (one bf16 ulp), which must give the
   served logits bit for bit; then run a float32 copy of the model with
   the FMA kernel and with the plain attention, whose logits must agree
   to 1e-4 of the largest and give the same greedy tokens;
8. hold the SSD chunk scan against its plain version: first each of the
   three tensor-core kernels (K1 ``ssd_chunk_state``, K2
   ``ssd_state_scan``, K3 ``ssd_chunk_out``) against its plain stage on
   the plain stage's own inputs (L 512, chunk 128, bf16, normal and slow
   decay, with an initial state); then the route that ``ssd_chunked``
   takes (tensor cores for bf16 with P % 64 == 0 and Q % 64 == 0, the FMA
   kernel for float32 and other bf16 shapes) at the mamba2 prefill path's
   shape (x (4, 32768, 48, 64), B/C (4, 32768, 128), chunk 256, read in
   place as strided views of one (b, L, 3328) conv output; bf16, then
   float32), at edge shapes ((L, Q) and (P, N), float32 and bf16), with an
   initial state, and under two chunkings of the final state; on the bf16
   path-shape input the tensor-core route, each of its kernels, the FMA
   kernel and the plain version are timed, with the bound (no single
   PyTorch call computes the chunk scan, so there is no library
   yardstick), and the three kernels' registers, spills and shared memory
   are recorded;
9. drive the SSD prefill path: mamba2-780m at full width and depth under
   the prefill_32k shape, 4 requests x 32,768 tokens, launch counters set
   to 0 just before and read just after (48 SSD calls, all on the
   tensor-core route: 48 launches of each of its three kernels, 0 of the
   FMA kernel; 0 SWA, 0 of either SpMM kernel);
10. check the served mamba2 prefill against the plain SSD: rerun the served
   forward with every kernel call also computed by the plain version and
   held to it (one bf16 ulp on y), which must give the served logits bit
   for bit; then a float32 copy of the model with the FMA kernel and with
   the plain SSD, logits within 1e-4 of the largest and the same greedy
   tokens.

Then it prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.

Run from the root of a checkout:  python3 chip_smoke.py
"""
import json
import subprocess
from unittest import mock
import sys
import time
from pathlib import Path

ATOL = RTOL = 1e-4        # kernel vs plain version, float32 (sum order)
GCN_MAX_ERR = 1e-3        # served GCN vs a plain GCN (examples/serve_pipeline.py)
# SWA kernel vs plain version, (atol, rtol). Both compute in float32 and
# round the output to the input type once, so a bf16 output may differ by
# one bf16 ulp (at most 2**-7 of the value) and float32 sum-order noise;
# float32 keeps tests/test_kernels.py's 2e-5. (That file's bf16 2e-2 is
# as large as a typical output at the prefill shape, so it is used only
# for the library yardstick, which rounds p to bf16.)
SWA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 2 ** -7)}
YARDSTICK_TOL = 2e-2
# a float32 copy of the prefill model, kernel vs plain attention: the
# largest logit difference as a share of the largest logit
FP32_LOGITS_TOL = 1e-4
# SSD kernel vs plain version, (atol, rtol) on y: as SWA_TOL (float32
# keeps tests/test_kernels.py's 2e-5; both round a float32 y once); the
# float32 final state at 2e-5
SSD_TOL = SWA_TOL
STATE_TOL = 2e-5
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12              # H100 SXM, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12             # H100 SXM, dense bf16 tensor cores
PREFILL = {"arch": "qwen3-4b", "batch": 2, "prompt_len": 16384}
SSD_PREFILL = {"arch": "mamba2-780m", "shape": "prefill_32k", "batch": 4,
               "prompt_len": 32768}


def phase(name):
    print(f"\n== {name}", flush=True)


def time_ms(fn, iters, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def spmm_bound(a, x):
    """Least time for out = A @ x, whatever implements it: what these inputs
    need, the CSR operand ``a`` (int32 indptr and indices, float32 values)
    and x read once and the output written once, against the FMA of the
    stored non-zeros. The bound of both SpMM kernels."""
    M, N = a.shape[0], x.shape[1]
    nbytes = (a.nbytes + x.numel() * x.element_size()
              + M * N * x.element_size())
    flops = 2.0 * a.nnz * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def hold(label, out, plain):
    """Hold an SpMM kernel output to the plain version's (ATOL, RTOL);
    returns the max abs error."""
    import torch
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: kernel output is not finite")
    torch.testing.assert_close(out, plain, atol=ATOL, rtol=RTOL,
                               msg=lambda m: f"{label}: {m}")
    return float((out - plain).abs().max())


def check_csr(label, a, x, *, time_it=False):
    """Row-wise CSR kernel vs plain version on the card for one operand;
    with ``time_it`` also the times, the bound and the library call
    (``torch.sparse.mm`` on the same int32 CSR, held to the kernel too).
    Returns a dict of the numbers measured."""
    import torch
    from repro_torch.kernels import spmm_csr_rows, spmm_csr_rows_plain
    args = (a.indptr, a.indices, a.values, x)
    out = spmm_csr_rows(*args)
    plain = spmm_csr_rows_plain(*args)
    torch.cuda.synchronize()
    row = {"label": label, "shape": list(a.shape) + [x.shape[1]],
           "nnz": a.nnz, "max_abs_err": hold(label, out, plain)}
    if time_it:
        row["ms"] = time_ms(lambda: spmm_csr_rows(*args), 10)
        row["plain_ms"] = time_ms(lambda: spmm_csr_rows_plain(*args), 3)
        row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = \
            spmm_bound(a, x)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["gb_per_s"] = row["bytes"] / row["ms"] / 1e6
        lib = torch.sparse_csr_tensor(a.indptr, a.indices, a.values,
                                      size=a.shape)
        ref = torch.sparse.mm(lib, x)
        torch.cuda.synchronize()
        row["library_max_abs_err"] = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL,
                                   msg=lambda m: f"{label} vs library: {m}")
        row["library_ms"] = time_ms(lambda: torch.sparse.mm(lib, x), 10)
        row["library"] = "torch.sparse.mm, int32 CSR"
    del out, plain
    torch.cuda.synchronize()
    print(json.dumps(row), flush=True)
    return row


def check_spmm(label, a, x, *, time_it=False, work=None):
    """Blocked-ELL kernel vs plain version on the card for one operand;
    with ``time_it`` also the times and the bound of the work, from its
    CSR operand ``work``. Returns a dict of the numbers measured."""
    import torch
    from repro_torch.kernels import spmm_blocked_ell, spmm_blocked_ell_plain
    out = spmm_blocked_ell(a.blocks, a.idx, x)
    plain = spmm_blocked_ell_plain(a.blocks, a.idx, x)
    torch.cuda.synchronize()
    row = {"label": label, "shape": list(a.blocks.shape) + [x.shape[1]],
           "max_abs_err": hold(label, out, plain)}
    if time_it:
        row["ms"] = time_ms(lambda: spmm_blocked_ell(a.blocks, a.idx, x), 10)
        row["plain_ms"] = time_ms(
            lambda: spmm_blocked_ell_plain(a.blocks, a.idx, x), 3)
        row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = \
            spmm_bound(work, x)
        # the padded format's own bytes and FMA, for comparison only
        row["padded_bytes"] = (a.blocks.numel() + a.idx.numel()) * 4 \
            + (x.numel() + out.numel()) * 4
        row["padded_flops"] = 2.0 * a.blocks.numel() * x.shape[1]
        row["padded_tflop_per_s"] = row["padded_flops"] / row["ms"] / 1e9
    del out, plain
    torch.cuda.synchronize()
    print(json.dumps(row), flush=True)
    return row


def swa_bound(B, H, KV, S, D, window, esize):
    """Least time for the banded attention on these shapes: q, k, v read
    once and o written once, against the q.k and p.v products of the
    in-band (row, key) pairs only, at the dense bf16 tensor-core rate."""
    w = min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w             # per (b, h)
    flops = 4.0 * D * pairs * B * H
    nbytes = (2 * B * H + 2 * B * KV) * S * D * esize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def ptxas_info(log, kernel):
    """Registers, spills and stack of each instantiation of ``kernel`` in an
    ``nvcc -Xptxas -v`` log, keyed ``kernel<first template argument>``."""
    import re
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            if kernel in m.group(1):
                targs = re.search(r"ILi(\d+)E", m.group(1))
                name = f"{kernel}<{targs.group(1)}>" if targs else kernel
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            info.setdefault(name, {})["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                info[name]["static_smem"] = int(sm.group(1))
        elif name and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            info.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
    return info


def hold_swa(label, out, plain):
    """Hold an SWA kernel output to the plain version's on the same inputs
    (SWA_TOL); returns the max abs error."""
    import torch
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: kernel output is not finite")
    atol, rtol = SWA_TOL[str(out.dtype).removeprefix("torch.")]
    torch.testing.assert_close(out, plain, atol=atol, rtol=rtol,
                               msg=lambda m: f"{label}: {m}")
    return float((out.float() - plain.float()).abs().max())


def check_swa(label, q, k, v, window, *, time_it=False):
    """The SWA kernel that ``swa_attention`` routes this input to vs the
    plain version on the card; with ``time_it`` (a bf16 input, which the
    wgmma kernel takes) also the FMA kernel on the same input, held to the
    plain version too, and the times of both kernels, the plain version
    and the library yardstick, with the bound. Returns a dict of the
    numbers measured."""
    import torch
    from repro_torch.kernels import (swa, swa_attention, swa_attention_fma,
                                     swa_attention_plain)
    D = q.shape[-1]
    scale = D ** -0.5
    route = swa._route(q.dtype, D)
    kernel = swa._KERNELS[route]
    n0 = kernel.launches
    out = swa_attention(q, k, v, window=window, scale=scale)
    plain = swa_attention_plain(q, k, v, window=window, scale=scale)
    torch.cuda.synchronize()
    if kernel.launches != n0 + 1:
        raise AssertionError(f"{label}: swa_attention did not launch the "
                             f"{route} kernel")
    err = hold_swa(label, out, plain)
    row = {"label": label, "kernel": route, "q": list(q.shape),
           "kv": list(k.shape), "window": window, "dtype": str(q.dtype),
           "max_abs_err": err}
    if time_it:
        B, H, S, _ = q.shape
        fma = swa_attention_fma(q, k, v, window=window, scale=scale)
        torch.cuda.synchronize()
        row["fma_max_abs_err"] = hold_swa(f"{label} (FMA kernel)", fma, plain)
        del fma
        row["ms"] = time_ms(
            lambda: kernel(q, k, v, window=window, scale=scale), 10)
        row["fma_ms"] = time_ms(
            lambda: swa_attention_fma(q, k, v, window=window, scale=scale),
            10)
        row["plain_ms"] = time_ms(
            lambda: swa_attention_plain(q, k, v, window=window, scale=scale),
            3)
        row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = \
            swa_bound(B, H, k.shape[1], S, D, window, q.element_size())
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflop_per_s"] = row["flops"] / row["ms"] / 1e9
        # the wgmma kernel issues p.v twice (hi and lo parts of P)
        row["issued_tflop_per_s"] = 1.5 * row["tflop_per_s"]
        row["fma_tflop_per_s"] = row["flops"] / row["fma_ms"] / 1e9
        row.update(sdpa_yardstick(q, k, v, window, scale, out))
    torch.cuda.synchronize()
    print(json.dumps(row), flush=True)
    return row


def sdpa_yardstick(q, k, v, window, scale, out):
    """One library call for the same function: PyTorch's memory-efficient
    scaled_dot_product_attention with the band as an additive mask (it
    computes every (row, key) pair; K/V are repeated to H heads before
    the timed call). Used nowhere in the port."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    S, G = q.shape[2], q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (k, v))
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    bias = torch.zeros((S, S), dtype=q.dtype, device=q.device).masked_fill(
        (rel < 0) | (rel >= window), float("-inf"))

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=bias,
                                                  scale=scale)

    lib = call()
    torch.cuda.synchronize()
    err = float((lib.float() - out.float()).abs().max())
    torch.testing.assert_close(lib, out, atol=YARDSTICK_TOL,
                               rtol=YARDSTICK_TOL,
                               msg=lambda m: f"SDPA yardstick: {m}")
    ms = time_ms(call, 10)
    del kr, vr, bias, lib
    return {"library_ms": ms, "library": "SDPA memory-efficient, band mask",
            "library_max_abs_err": err}


def holding_kernel(errs):
    """A stand-in for ``ops.swa_attention`` that launches the kernel, holds
    its output to the plain version's on the same inputs and returns the
    kernel's, so the forward it runs in is the served one. Each call's
    max abs error is appended to ``errs``."""
    from repro_torch.kernels import swa_attention, swa_attention_plain

    def call(q, k, v, *, window, scale):
        out = swa_attention(q, k, v, window=window, scale=scale)
        plain = swa_attention_plain(q, k, v, window=window, scale=scale)
        errs.append(hold_swa(f"layer {len(errs)}", out, plain))
        return out
    return call


def ssd_inputs(gen, dev, b, L, H, P, N, dtype, slow=False):
    """SSD inputs laid out as ``mamba_block`` feeds them: x, B and C are
    strided views of one (b, L, H*P + 2N) tensor (the conv output), dt a
    (b, L, H) tensor of the same dtype; A_log and D (H,) float32. The
    distributions of tests/test_kernels.py:_ssd_inputs, where a chunk of
    256 decays the state by about e^-180; ``slow`` shifts dt by -4 and
    A_log by -3 (a chunk decays it by about e^-0.2), so that the state
    carried across chunks counts."""
    import torch
    packed = torch.empty((b, L, H * P + 2 * N), device=dev, dtype=dtype)
    packed[..., :H * P] = torch.randn((b, L, H * P), generator=gen,
                                      device=dev)
    packed[..., H * P:] = torch.randn((b, L, 2 * N), generator=gen,
                                      device=dev) * N ** -0.5
    dt = (torch.randn((b, L, H), generator=gen, device=dev) * 0.5
          - 4 * slow).to(dtype)
    return (packed[..., :H * P].reshape(b, L, H, P), dt,
            packed[..., H * P:H * P + N], packed[..., H * P + N:],
            torch.randn((H,), generator=gen, device=dev) * 0.3 - 3 * slow,
            torch.randn((H,), generator=gen, device=dev) * 0.1)


def ssd_bound(args, chunk, init_state=None):
    """Least time for the SSD scan of these inputs: every input read once
    and y and the final state written once, against its products with
    C B^T counted once per (batch, chunk) (B and C are shared by the
    heads) and only the causal triangle of C B^T and W x, at the dense
    bf16 tensor-core rate for bf16 inputs (the CUDA cores' float32 rate
    for float32)."""
    import torch
    x, B = args[0], args[2]
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    nc = L // Q
    tri = Q * (Q + 1) // 2
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + x.numel() * x.element_size() + b * H * P * N * 4
    if init_state is not None:
        nbytes += init_state.numel() * init_state.element_size()
    flops = 2.0 * b * nc * (tri * N + H * (tri * P + 2 * Q * P * N))
    rate = BF16_FLOP_PER_S if x.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def ssd_tc_issued_flops(args, chunk, parts=3):
    """The tensor work the tensor-core route issues on these inputs: per
    (batch, chunk, head, 64-column P slice), K1's u^T B and K3's C S^T,
    each once a bf16 part of u and S, and per pair of 64-row tiles of the
    causal triangle C B^T once and W x once a part of W
    (csrc/ssd_chunk_tc.cu)."""
    x, B = args[0], args[2]
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    pairs = (Q // 64) * (Q // 64 + 1) // 2
    per = 2 * parts * (2 * Q * 64 * N) + pairs * (
        2 * 64 * 64 * N + parts * 2 * 64 * 64 * 64)
    return float(per) * b * (L // Q) * H * (P // 64)


def hold_ssd(label, y, state, py, pstate):
    """Hold an SSD kernel result to the plain version's on the same inputs
    (SSD_TOL on y, STATE_TOL on the state); returns the max abs errors."""
    import torch
    if not (torch.isfinite(y).all() and torch.isfinite(state).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    atol, rtol = SSD_TOL[str(y.dtype).removeprefix("torch.")]
    torch.testing.assert_close(y, py, atol=atol, rtol=rtol,
                               msg=lambda m: f"{label} y: {m}")
    torch.testing.assert_close(state, pstate, atol=STATE_TOL, rtol=STATE_TOL,
                               msg=lambda m: f"{label} state: {m}")
    return (float((y.float() - py.float()).abs().max()),
            float((state - pstate).abs().max()))


def check_ssd(label, args, chunk, *, init_state=None, time_it=False):
    """The SSD route that ``ssd_chunked`` takes for this input vs the plain
    version on the card; with ``time_it`` (a bf16 input of the tensor-core
    route) also the FMA kernel on the same input, held to the plain version
    too, and the times of the route, of each of its three kernels, of the
    FMA kernel and of the plain version, with the bound. Returns a dict of
    the numbers measured."""
    import torch
    from repro_torch.kernels import (ssd, ssd_chunk_out, ssd_chunk_state,
                                     ssd_chunked, ssd_chunked_fma,
                                     ssd_chunked_plain, ssd_state_scan)
    x, B = args[0], args[2]
    route = ssd._route(x.dtype, x.shape[3], B.shape[-1],
                       min(chunk, x.shape[1]))
    kernel = ssd._KERNELS[route]
    kw = {"chunk": chunk, "init_state": init_state}
    n0 = kernel.launches
    y, state = ssd_chunked(*args, **kw)
    py, pstate = ssd_chunked_plain(*args, **kw)
    torch.cuda.synchronize()
    if kernel.launches != n0 + 1:
        raise AssertionError(f"{label}: ssd_chunked did not take the {route} "
                             f"route")
    err, state_err = hold_ssd(label, y, state, py, pstate)
    row = {"label": label, "kernel": route, "x": list(x.shape),
           "N": B.shape[-1], "chunk": chunk, "dtype": str(x.dtype),
           "max_abs_err": err, "state_max_abs_err": state_err}
    if time_it:
        fy, fstate = ssd_chunked_fma(*args, **kw)
        torch.cuda.synchronize()
        row["fma_max_abs_err"] = hold_ssd(f"{label} (FMA kernel)", fy, fstate,
                                          py, pstate)[0]
        del fy, fstate
        row["ms"] = time_ms(lambda: kernel(*args, **kw), 10)
        row["fma_ms"] = time_ms(lambda: ssd_chunked_fma(*args, **kw), 10)
        row["plain_ms"] = time_ms(lambda: ssd_chunked_plain(*args, **kw), 3)
        row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = \
            ssd_bound(args, chunk, init_state)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflop_per_s"] = row["flops"] / row["ms"] / 1e9
        row["fma_tflop_per_s"] = row["flops"] / row["fma_ms"] / 1e9
        row["issued_flops"] = ssd_tc_issued_flops(args, chunk)
        row["issued_tflop_per_s"] = row["issued_flops"] / row["ms"] / 1e9
        dts, da = ssd._discretize(args[1], args[4])
        la, st = ssd_chunk_state(x, dts, da, B, chunk=chunk)
        row["stage_ms"] = {
            "ssd_chunk_state": time_ms(
                lambda: ssd_chunk_state(x, dts, da, B, chunk=chunk), 10),
            "ssd_state_scan": time_ms(
                lambda: ssd_state_scan(la, st, chunk=chunk), 10),
            "ssd_chunk_out": time_ms(
                lambda: ssd_chunk_out(x, dts, la, B, args[3], args[5], st,
                                      chunk=chunk), 10)}
        row["library_ms"] = None
        del dts, da, la, st
    del y, state, py, pstate
    torch.cuda.synchronize()
    print(json.dumps(row), flush=True)
    return row


def check_ssd_stages(label, args, chunk, init_state):
    """Each of the tensor-core route's three kernels vs its plain stage,
    on the plain stage's own inputs: la and ds (K1), the states entering
    the chunks and the final state (K2) at STATE_TOL, y (K3) at SSD_TOL.
    Returns a dict of the max abs errors."""
    import torch
    from repro_torch.kernels import (ssd, ssd_chunk_out, ssd_chunk_out_plain,
                                     ssd_chunk_state, ssd_chunk_state_plain,
                                     ssd_state_scan, ssd_state_scan_plain)
    x, dt, B, C, A_log, D = args
    dts, da = ssd._discretize(dt, A_log)

    def close(name, out, ref, tol):
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {name}: not finite")
        torch.testing.assert_close(out, ref, atol=tol[0], rtol=tol[1],
                                   msg=lambda m: f"{label} {name}: {m}")
        return float((out.float() - ref.float()).abs().max())

    row = {"label": label}
    la, ds = ssd_chunk_state(x, dts, da, B, chunk=chunk)
    pla, pds = ssd_chunk_state_plain(x, dts, da, B, chunk=chunk)
    torch.cuda.synchronize()
    row["ssd_chunk_state"] = max(close("la", la, pla, (STATE_TOL,) * 2),
                                 close("ds", ds, pds, (STATE_TOL,) * 2))
    st = pds.clone()
    s_out = ssd_state_scan(pla, st, chunk=chunk, init_state=init_state)
    s_in, pstate = ssd_state_scan_plain(pla, pds, chunk=chunk,
                                        init_state=init_state)
    torch.cuda.synchronize()
    row["ssd_state_scan"] = max(close("s_in", st, s_in, (STATE_TOL,) * 2),
                                close("state", s_out, pstate,
                                      (STATE_TOL,) * 2))
    y = ssd_chunk_out(x, dts, pla, B, C, D, s_in, chunk=chunk)
    py = ssd_chunk_out_plain(x, dts, pla, B, C, D, s_in, chunk=chunk)
    torch.cuda.synchronize()
    row["ssd_chunk_out"] = close("y", y, py, SSD_TOL["bfloat16"])
    print(json.dumps(row), flush=True)
    return row


def holding_ssd(errs):
    """A stand-in for ``models.ssm.ssd_chunked`` that launches the kernel,
    holds its result to the plain version's on the same inputs and
    returns the kernel's, so the forward it runs in is the served one.
    Each call's max abs error on y is appended to ``errs``."""
    from repro_torch.kernels import ssd_chunked, ssd_chunked_plain

    def call(*args, **kw):
        y, state = ssd_chunked(*args, **kw)
        py, pstate = ssd_chunked_plain(*args, **kw)
        errs.append(hold_ssd(f"layer {len(errs)}", y, state, py, pstate)[0])
        return y, state
    return call


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a machine with an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.data import table1_graph
    from repro_torch.kernels import (BlockedEll, CsrOperand, _build,
                                     csr_to_blocked_ell, ops,
                                     spmm_blocked_ell, spmm_csr_rows, ssd,
                                     ssd_chunk_out, ssd_chunk_state,
                                     ssd_chunked, ssd_chunked_fma,
                                     ssd_chunked_plain, ssd_chunked_tc,
                                     ssd_state_scan, swa, swa_attention,
                                     swa_attention_fma, swa_attention_plain,
                                     swa_attention_wgmma)
    from repro_torch.launch.serve_prefill import serve_prefill
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.launch.serve_pipeline import gcn_plain, serve
    from repro_torch.models import ssm as ssm_model
    from repro_torch.models.common import tree_map
    from repro_torch.sparse import csr_from_dense

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 1) build
    phase("1. build the kernels")
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        print(f"[{name}] ptxas:")
        print("\n".join(l for l in log.splitlines() if "ptxas" in l))
    print(f"built {sorted(logs) or 'nothing (already built)'} of "
          f"{_build.sources()} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 2) SpMM kernels vs plain on the card
    phase("2. SpMM kernels vs their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    graph = table1_graph("OA", device=dev)
    V = graph.shape[0]
    csr = CsrOperand.from_csr(graph, device=dev)
    blocks, idx = csr_to_blocked_ell(graph, 16, 16)
    adj = BlockedEll.from_numpy(blocks, idx, V, device=dev)
    compact = CsrOperand.from_blocked_ell(blocks, idx, V, device=dev)
    del blocks, idx
    torch.cuda.synchronize()
    print(f"ogbn-arxiv graph V={V} nnz={graph.nnz}: CSR operand "
          f"{csr.nbytes} bytes, blocked-ELL {tuple(adj.blocks.shape)} "
          f"({adj.blocks.numel() * 4} bytes of tiles); built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    x = torch.randn((V, 128), generator=gen, device=dev)
    x100 = torch.randn((V, 100), generator=gen, device=dev)
    csr_rows = [check_csr("OA N=128", csr, x, time_it=True)]
    oa_csr = csr_rows[0]
    first, again, from_ell = csr @ x, csr @ x, compact @ x
    torch.cuda.synchronize()
    if not (torch.equal(first, again) and torch.equal(first, from_ell)):
        raise AssertionError("spmm_csr_rows: repeat calls, or the CSR "
                             "compacted from blocked-ELL, differ at OA")
    print("[check] OA: two calls bit for bit equal; from_blocked_ell and "
          "from_csr give the same product bit for bit", flush=True)
    del first, again, from_ell, compact
    csr_rows.append(check_csr("OA N=100", csr, x100))
    rows = [check_spmm("OA bm=bk=16 N=128", adj, x, time_it=True, work=csr)]
    oa = rows[0]
    rows.append(check_spmm("OA bm=bk=16 N=100", adj, x100))
    del adj, csr, x, x100
    rng = np.random.default_rng(7)
    a = rng.normal(size=(256, 384)).astype(np.float32)
    a[rng.random(a.shape) > 0.08] = 0.0
    for n in (64, 100, 256):
        csr_rows.append(check_csr(
            f"256x384 8% N={n}", CsrOperand.from_csr(
                csr_from_dense(a, device=dev), device=dev),
            torch.randn((384, n), generator=gen, device=dev)))
    ragged = rng.normal(size=(512, 2048)).astype(np.float32)
    ragged[rng.random(ragged.shape) > 0.02] = 0.0
    ragged[:100] = 0.0                    # empty rows
    ragged[300] = 0.0
    ragged[300, rng.choice(2048, 1000, replace=False)] = \
        rng.normal(size=1000)             # one row of 1,000 non-zeros
    one = np.zeros((64, 64), np.float32)
    one[13, 42] = 3.0
    rect = rng.normal(size=(1003, 257)).astype(np.float32)
    rect[rng.random(rect.shape) > 0.05] = 0.0
    for label, m, n in (("empty rows, a row of 1000 N=128", ragged, 128),
                        ("empty rows, a row of 1000 N=100", ragged, 100),
                        ("one non-zero N=128", one, 128),
                        ("1003x257 5% N=128", rect, 128),
                        ("1003x257 5% N=100", rect, 100)):
        csr_rows.append(check_csr(
            label, CsrOperand.from_csr(csr_from_dense(m, device=dev),
                                       device=dev),
            torch.randn((m.shape[1], n), generator=gen, device=dev)))
    for b in (128, 16):
        for n in (64, 100, 256):
            op = BlockedEll.from_csr(csr_from_dense(a, device=dev), b, b,
                                     device=dev)
            rows.append(check_spmm(f"256x384 8% bm=bk={b} N={n}", op,
                                   torch.randn((384, n), generator=gen,
                                               device=dev)))
    empty = np.zeros((256, 256), np.float32)
    empty[200, 5] = 3.0                   # block-row 0 of 2 is empty
    op = BlockedEll.from_csr(csr_from_dense(empty, device=dev), 128, 128,
                             device=dev)
    rows.append(check_spmm("empty block-row bm=bk=128 N=64", op,
                           torch.ones((256, 64), device=dev)))
    diag = np.diag(rng.normal(size=512)).astype(np.float32)
    op = BlockedEll.from_csr(csr_from_dense(diag, device=dev), 16, 16,
                             device=dev)
    if op.blocks.shape[1] != 1:
        raise AssertionError(f"want ell = 1, got {tuple(op.blocks.shape)}")
    rows.append(check_spmm("ell=1 bm=bk=16 N=128", op,
                           torch.randn((512, 128), generator=gen,
                                       device=dev)))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # 3) main path
    phase("3. main path: serve_pipeline on ogbn-arxiv, 8 requests")
    spmm_csr_rows.launches = 0
    spmm_blocked_ell.launches = 0
    with torch.inference_mode():
        res = serve("OA", 8, device=dev)
    torch.cuda.synchronize()
    launches = spmm_csr_rows.launches
    ell_launches = spmm_blocked_ell.launches
    print(f"[main] {res.out.shape[0]} requests in {res.seconds * 1e3:.3f} ms "
          f"({res.inf_per_s:.3f} inf/s), max err vs plain GCN "
          f"{res.max_err:.3e}; schedule {res.schedule} -> {res.rescheduled} "
          f"after drift; spmm_csr_rows launches {launches}, "
          f"spmm_blocked_ell launches {ell_launches}", flush=True)
    if launches != 2 * 8 or ell_launches != 0:
        raise AssertionError(f"expected 16 spmm_csr_rows and 0 "
                             f"spmm_blocked_ell launches, saw {launches} and "
                             f"{ell_launches}")
    if tuple(res.out.shape) != (8, 170_000, 128) \
            or not torch.isfinite(res.out).all() \
            or not res.max_err < GCN_MAX_ERR:
        raise AssertionError("served GCN output is wrong")

    # 4) the served output against the same GCN computed on the CPU
    phase("4. served request 0 vs a CPU computation")
    cpu_graph = table1_graph("OA", device="cpu")
    cpu_params = [{"theta": p["theta"].cpu()} for p in res.params]
    exp = gcn_plain(cpu_params, cpu_graph, res.micro[0].cpu())
    cpu_err = float((res.out[0].cpu() - exp).abs().max())
    print(f"[check] request 0, card vs CPU max err {cpu_err:.3e}", flush=True)
    if not cpu_err < GCN_MAX_ERR:
        raise AssertionError(f"card and CPU disagree: {cpu_err}")
    torch.cuda.synchronize()
    del res, cpu_graph, cpu_params, exp
    torch.cuda.empty_cache()

    # 5) SWA kernel vs plain on the card
    phase("5. SWA kernel vs its plain version")
    B, S, H, KV, D, W = 2, 16384, 32, 8, 128, 4096
    base = [torch.randn((B, S, n, D), generator=gen, device=dev)
            for n in (H, KV, KV)]
    q, k, v = (t.transpose(1, 2) for t in base)
    swa_rows = [check_swa(f"prefill S={S} window={W} float32 (B,S,H,D) "
                          f"views", q, k, v, W)]
    q, k, v = (t.to(torch.bfloat16).transpose(1, 2) for t in base)
    del base
    swa_rows.append(check_swa(f"prefill S={S} window={W} bf16 (B,S,H,D) "
                              f"views", q, k, v, W, time_it=True))
    main_swa = swa_rows[-1]
    if main_swa["kernel"] != "wgmma":
        raise AssertionError("the bf16 prefill shape is not routed to the "
                             "wgmma kernel")
    del q, k, v
    wgmma_build = {
        "ptxas": ptxas_info(logs.get("swa_attention_wgmma", ""),
                           "swa_attention_wgmma_kernel"),
        "dynamic_smem_bytes": {d_: swa.wgmma_smem_bytes(d_)
                               for d_ in swa.WGMMA_D}}
    print(json.dumps({"swa_attention_wgmma build": wgmma_build}), flush=True)
    edges = [(s_, w_, d_, g_) for s_, w_ in ((256, 128), (384, 128),
                                             (512, 256), (256, 256),
                                             (128, 128))
             for d_ in (64, 128) for g_ in (1, 4, 8)] + [(512, 256, 256, 8)]
    for dtype in (torch.float32, torch.bfloat16):
        for s_, w_, d_, g_ in edges:
            q = torch.randn((2, 2 * g_, s_, d_), generator=gen, device=dev,
                            dtype=dtype)
            k, v = (torch.randn((2, 2, s_, d_), generator=gen, device=dev,
                                dtype=dtype) for _ in range(2))
            swa_rows.append(check_swa(
                f"S={s_} window={w_} D={d_} G={g_} {dtype}", q, k, v, w_))
    torch.cuda.empty_cache()

    # 6) SWA prefill path
    phase(f"6. main path: serve_prefill {PREFILL['arch']} (SWA 4096), "
          f"{PREFILL['batch']} x {PREFILL['prompt_len']} tokens")
    spmm_csr_rows.launches = 0
    spmm_blocked_ell.launches = 0
    swa_attention.launches = 0
    swa_attention_wgmma.launches = 0
    swa_attention_fma.launches = 0
    pre = serve_prefill(PREFILL["arch"], batch=PREFILL["batch"],
                        prompt_len=PREFILL["prompt_len"], device=dev)
    torch.cuda.synchronize()
    swa_launches = swa_attention.launches
    wgmma_launches = swa_attention_wgmma.launches
    fma_launches = swa_attention_fma.launches
    cfg = pre.cfg
    print(f"[prefill] {pre.tokens.numel()} tokens in "
          f"{pre.seconds * 1e3:.3f} ms ({pre.tok_per_s:.3f} tok/s); "
          f"swa_attention launches {swa_launches} (swa_attention_wgmma "
          f"{wgmma_launches}, swa_attention_fma {fma_launches}), "
          f"spmm_csr_rows launches "
          f"{spmm_csr_rows.launches}, spmm_blocked_ell launches "
          f"{spmm_blocked_ell.launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if (cfg.attention, cfg.window, cfg.n_layers, cfg.d_model) != \
            ("swa", 4096, 36, 2560):
        raise AssertionError(f"not the full qwen3-4b SWA config: {cfg}")
    if swa_launches != cfg.n_layers or wgmma_launches != cfg.n_layers \
            or fma_launches or spmm_csr_rows.launches \
            or spmm_blocked_ell.launches:
        raise AssertionError(f"expected {cfg.n_layers} launches of the "
                             f"wgmma SWA kernel, none of the FMA one and no "
                             f"SpMM launch, saw {wgmma_launches} and "
                             f"{fma_launches} of {swa_launches}, "
                             f"{spmm_csr_rows.launches} and "
                             f"{spmm_blocked_ell.launches}")
    if tuple(pre.logits.shape) != (PREFILL["batch"], 1, 152064) \
            or not torch.isfinite(pre.logits).all():
        raise AssertionError(f"prefill logits are wrong: "
                             f"{tuple(pre.logits.shape)}")

    # 7) the served prefill vs the plain attention
    phase("7. served prefill vs the plain attention: every kernel call, "
          "and a float32 copy of the model")
    t0 = time.perf_counter()
    errs = []
    with mock.patch.object(ops, "swa_attention", holding_kernel(errs)), \
            torch.inference_mode():
        held = make_prefill_step(cfg, device=dev)(pre.params,
                                                  {"tokens": pre.tokens})
    torch.cuda.synchronize()
    print(f"[check] served forward, {len(errs)} kernel calls held to the "
          f"plain version: {time.perf_counter() - t0:.1f} s; max abs err "
          f"per layer {errs}", flush=True)
    if len(errs) != cfg.n_layers or not torch.equal(held, pre.logits):
        raise AssertionError("the held forward does not reproduce the "
                             "served logits")
    t0 = time.perf_counter()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), pre.params)
    step32 = make_prefill_step(cfg32, device=dev)
    n0 = swa_attention_fma.launches
    with torch.inference_mode():
        kern = step32(params32, {"tokens": pre.tokens})
        if swa_attention_fma.launches != n0 + cfg.n_layers:
            raise AssertionError("the float32 forward missed the FMA kernel")
        with mock.patch.object(ops, "swa_attention", swa_attention_plain):
            plain = step32(params32, {"tokens": pre.tokens})
    torch.cuda.synchronize()
    del params32
    logit_err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    greedy, plain_greedy = (t[:, -1].argmax(dim=-1) for t in (kern, plain))
    print(f"[check] float32 forward, kernel vs plain attention: "
          f"{time.perf_counter() - t0:.1f} s; max |logit diff| "
          f"{logit_err:.4e} of max |logit| {scale:.4f} "
          f"({logit_err / scale:.4e}, limit {FP32_LOGITS_TOL}); greedy "
          f"{greedy.tolist()} vs plain {plain_greedy.tolist()}", flush=True)
    if not (logit_err <= FP32_LOGITS_TOL * scale
            and torch.equal(greedy, plain_greedy)):
        raise AssertionError("the float32 forward's logits differ between "
                             "the kernel and the plain attention")
    torch.cuda.synchronize()
    del pre, held, kern, plain
    torch.cuda.empty_cache()

    # 8) SSD kernels vs plain on the card
    phase("8. SSD kernels vs their plain versions")
    stage_rows = []
    for slow in (False, True):
        args = ssd_inputs(gen, dev, 2, 512, 3, 64, 128, torch.bfloat16, slow)
        s0 = torch.randn((2, 3, 64, 128), generator=gen, device=dev)
        stage_rows.append(check_ssd_stages(
            f"K1-K3 vs plain stages slow={slow} L=512 chunk=128 bf16", args,
            128, s0))
    b, L, H, P, N, Qc = 4, 32768, 48, 64, 128, 256
    ssd_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        args = ssd_inputs(gen, dev, b, L, H, P, N, dtype)
        ssd_rows.append(check_ssd(
            f"prefill L={L} chunk={Qc} {dtype} strided views", args, Qc,
            time_it=dtype == torch.bfloat16))
        del args
    main_ssd = ssd_rows[0]
    if main_ssd["kernel"] != "tc":
        raise AssertionError("the bf16 prefill shape is not routed to the "
                             "tensor-core kernels")
    tc_build = {
        "ptxas": {k: ptxas_info(logs.get("ssd_chunk_tc", ""), k)
                  for k in ("ssd_chunk_state_kernel", "ssd_state_scan_kernel",
                            "ssd_chunk_out_kernel")},
        "ssd_chunk_out_dynamic_smem_bytes": {
            f"Q={q_} N={n_}": ssd.tc_smem_bytes(q_, n_)
            for q_ in (64, 128, 256) for n_ in ssd.KERNEL_N}}
    print(json.dumps({"ssd_chunk_tc build": tc_build}), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for l_, q_ in ((256, 128), (512, 128), (512, 256), (128, 128),
                       (96, 256)):
            for p_, n_ in ((64, 128), (128, 128), (64, 64)):
                args = ssd_inputs(gen, dev, 2, l_, 3, p_, n_, dtype)
                ssd_rows.append(check_ssd(
                    f"L={l_} chunk={q_} P={p_} N={n_} {dtype}", args, q_))
        for slow in (False, True):
            args = ssd_inputs(gen, dev, 2, 512, 3, 64, 128, dtype, slow)
            ssd_rows.append(check_ssd(f"slow={slow} L=512 chunk=128 {dtype}",
                                      args, 128))
            s0 = torch.randn((2, 3, 64, 128), generator=gen, device=dev)
            ssd_rows.append(check_ssd(
                f"init_state slow={slow} L=512 chunk=128 {dtype}", args, 128,
                init_state=s0))
        # the final state under two chunkings (tests/test_kernels.py)
        _, s128 = ssd_chunked(*args, chunk=128)
        _, s64 = ssd_chunked(*args, chunk=64)
        torch.testing.assert_close(s128, s64, atol=STATE_TOL, rtol=STATE_TOL)
        print(f"[check] final state, chunk 128 vs 64 {dtype}: max abs diff "
              f"{float((s128 - s64).abs().max()):.3e}", flush=True)
    torch.cuda.empty_cache()

    # 9) SSD prefill path
    phase(f"9. main path: serve_prefill {SSD_PREFILL['arch']} "
          f"({SSD_PREFILL['shape']}), {SSD_PREFILL['batch']} x "
          f"{SSD_PREFILL['prompt_len']} tokens")
    torch.cuda.reset_peak_memory_stats()
    spmm_csr_rows.launches = 0
    spmm_blocked_ell.launches = 0
    swa_attention.launches = 0
    swa_attention_wgmma.launches = 0
    swa_attention_fma.launches = 0
    ssd_chunked.launches = 0
    ssd_chunked_tc.launches = 0
    ssd_chunked_fma.launches = 0
    ssd_stages = (ssd_chunk_state, ssd_state_scan, ssd_chunk_out)
    for f in ssd_stages:
        f.launches = 0
    mam = serve_prefill(SSD_PREFILL["arch"], shape=SSD_PREFILL["shape"],
                        batch=SSD_PREFILL["batch"],
                        prompt_len=SSD_PREFILL["prompt_len"], device=dev)
    torch.cuda.synchronize()
    ssd_launches = ssd_chunked.launches
    tc_calls, fma_calls = ssd_chunked_tc.launches, ssd_chunked_fma.launches
    stage_launches = {f.__name__: f.launches for f in ssd_stages}
    mcfg = mam.cfg
    print(f"[prefill] {mam.tokens.numel()} tokens in "
          f"{mam.seconds * 1e3:.3f} ms ({mam.tok_per_s:.3f} tok/s); "
          f"ssd_chunked calls {ssd_launches} (ssd_chunked_tc {tc_calls}, "
          f"ssd_chunked_fma {fma_calls}); kernel launches {stage_launches}; "
          f"swa_attention launches "
          f"{swa_attention.launches}, spmm_csr_rows launches "
          f"{spmm_csr_rows.launches}, spmm_blocked_ell launches "
          f"{spmm_blocked_ell.launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if (mcfg.family, mcfg.n_layers, mcfg.d_model, mcfg.ssm_state,
            mcfg.ssm_chunk, mcfg.ssm_heads, mcfg.ssm_head_dim) != \
            ("ssm", 48, 1536, 128, 256, 48, 64):
        raise AssertionError(f"not the full mamba2-780m config: {mcfg}")
    if ssd_launches != mcfg.n_layers or tc_calls != mcfg.n_layers \
            or fma_calls or any(n != mcfg.n_layers
                                for n in stage_launches.values()) \
            or swa_attention.launches or spmm_csr_rows.launches \
            or spmm_blocked_ell.launches:
        raise AssertionError(f"expected {mcfg.n_layers} SSD calls, all on "
                             f"the tensor-core route ({mcfg.n_layers} "
                             f"launches of each of its kernels), and no SWA "
                             f"or SpMM kernel launches, saw {ssd_launches} "
                             f"({tc_calls} tc, {fma_calls} fma), "
                             f"{stage_launches}, {swa_attention.launches}, "
                             f"{spmm_csr_rows.launches} and "
                             f"{spmm_blocked_ell.launches}")
    if tuple(mam.logits.shape) != (SSD_PREFILL["batch"], 1, 50432) \
            or not torch.isfinite(mam.logits).all():
        raise AssertionError(f"prefill logits are wrong: "
                             f"{tuple(mam.logits.shape)}")

    # 10) the served mamba2 prefill vs the plain SSD
    phase("10. served mamba2 prefill vs the plain SSD: every kernel call, "
          "and a float32 copy of the model")
    t0 = time.perf_counter()
    ssd_errs = []
    with mock.patch.object(ssm_model, "ssd_chunked",
                           holding_ssd(ssd_errs)), torch.inference_mode():
        held = make_prefill_step(mcfg, device=dev)(mam.params,
                                                   {"tokens": mam.tokens})
    torch.cuda.synchronize()
    print(f"[check] served forward, {len(ssd_errs)} kernel calls held to the "
          f"plain version: {time.perf_counter() - t0:.1f} s; max abs err "
          f"per layer {ssd_errs}", flush=True)
    if len(ssd_errs) != mcfg.n_layers or not torch.equal(held, mam.logits):
        raise AssertionError("the held forward does not reproduce the "
                             "served logits")
    t0 = time.perf_counter()
    mcfg32 = mcfg.replace(param_dtype="float32", compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), mam.params)
    step32 = make_prefill_step(mcfg32, device=dev)
    n0 = ssd_chunked_fma.launches
    with torch.inference_mode():
        kern = step32(params32, {"tokens": mam.tokens})
        if ssd_chunked_fma.launches != n0 + mcfg.n_layers:
            raise AssertionError("the float32 forward missed the FMA kernel")
        with mock.patch.object(ssm_model, "ssd_chunked", ssd_chunked_plain):
            plain = step32(params32, {"tokens": mam.tokens})
    torch.cuda.synchronize()
    del params32
    ssd_logit_err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    greedy, plain_greedy = (t[:, -1].argmax(dim=-1) for t in (kern, plain))
    print(f"[check] float32 forward, kernel vs plain SSD: "
          f"{time.perf_counter() - t0:.1f} s; max |logit diff| "
          f"{ssd_logit_err:.4e} of max |logit| {scale:.4f} "
          f"({ssd_logit_err / scale:.4e}, limit {FP32_LOGITS_TOL}); greedy "
          f"{greedy.tolist()} vs plain {plain_greedy.tolist()}", flush=True)
    if not (ssd_logit_err <= FP32_LOGITS_TOL * scale
            and torch.equal(greedy, plain_greedy)):
        raise AssertionError("the float32 forward's logits differ between "
                             "the kernel and the plain SSD")
    torch.cuda.synchronize()

    kernels = [{
        "name": "spmm_csr_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_csr_rows.cu",
        "replaces": "src/repro/kernels/spmm.py:72", "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in csr_rows),
        "ms": oa_csr["ms"], "plain_ms": oa_csr["plain_ms"],
        "bound_ms": oa_csr["bound_ms"], "bound_by": oa_csr["bound_by"],
        "library_ms": oa_csr["library_ms"]}, {
        "name": "spmm_blocked_ell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_blocked_ell.cu",
        "replaces": "src/repro/kernels/spmm.py:72",
        "launches": ell_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": oa["ms"], "plain_ms": oa["plain_ms"],
        "bound_ms": oa["bound_ms"], "bound_by": oa["bound_by"],
        "library_ms": oa_csr["library_ms"]}, {
        "name": "swa_attention_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention_wgmma.cu",
        "replaces": "src/repro/kernels/swa.py:81",
        "launches": wgmma_launches,
        "max_abs_err": max([r["max_abs_err"] for r in swa_rows
                            if r["kernel"] == "wgmma"] + errs),
        "ms": main_swa["ms"], "plain_ms": main_swa["plain_ms"],
        "bound_ms": main_swa["bound_ms"], "bound_by": main_swa["bound_by"],
        "library_ms": main_swa["library_ms"]}, {
        "name": "swa_attention_fma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa.py:81", "launches": fma_launches,
        "max_abs_err": max([r["max_abs_err"] for r in swa_rows
                            if r["kernel"] == "fma"]
                           + [main_swa["fma_max_abs_err"]]),
        "ms": main_swa["fma_ms"], "plain_ms": main_swa["plain_ms"],
        "bound_ms": main_swa["bound_ms"], "bound_by": main_swa["bound_by"],
        "library_ms": main_swa["library_ms"]}, {
        # three launches a call: K1, K2 and K3, one each
        "name": "ssd_chunk_tc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_tc.cu",
        "replaces": "src/repro/kernels/ssd.py:74",
        "launches": sum(stage_launches.values()), "calls": tc_calls,
        "kernel_launches": stage_launches,
        "max_abs_err": max([r["max_abs_err"] for r in ssd_rows
                            if r["kernel"] == "tc"] + ssd_errs
                           + [r["ssd_chunk_out"] for r in stage_rows]),
        "ms": main_ssd["ms"], "stage_ms": main_ssd["stage_ms"],
        "plain_ms": main_ssd["plain_ms"],
        "bound_ms": main_ssd["bound_ms"], "bound_by": main_ssd["bound_by"],
        "tflop_per_s": main_ssd["tflop_per_s"],
        "issued_tflop_per_s": main_ssd["issued_tflop_per_s"],
        "library_ms": None}, {
        "name": "ssd_chunked_fma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunked.cu",
        "replaces": "src/repro/kernels/ssd.py:74", "launches": fma_calls,
        "max_abs_err": max([r["max_abs_err"] for r in ssd_rows
                            if r["kernel"] == "fma"]
                           + [main_ssd["fma_max_abs_err"]]),
        "ms": main_ssd["fma_ms"], "plain_ms": main_ssd["plain_ms"],
        "bound_ms": main_ssd["bound_ms"], "bound_by": main_ssd["bound_by"],
        "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
