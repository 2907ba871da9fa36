#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Phases, each ending in ``torch.cuda.synchronize()``; any fault or mismatch
raises and the script exits non-zero:

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for sm_90a (one ``nvcc`` per source, started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (ogbn-arxiv, 170,000 vertices, bm = bk = 16, N = 128)
   and at edge shapes, with its time, the plain version's, the bound, and
   one library call's as a yardstick (never used by the port);
3. drive the main path: DYPE-scheduled 2-layer GCN serving on ogbn-arxiv at
   full size, 8 requests through the 4-stage pipeline, with the launch
   counters set to 0 just before and read just after;
4. check the served output against a CPU computation of the same GCN on the
   same inputs.

Then it prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.

Run from the root of a checkout:  python3 chip_smoke.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ATOL = RTOL = 1e-4        # kernel vs plain version, float32 (sum order)
GCN_MAX_ERR = 1e-3        # served GCN vs a plain GCN (examples/serve_pipeline.py)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12              # H100 SXM, fp32 outside the tensor cores


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


def spmm_bound(blocks, idx, x):
    """Least time for out = A @ x from these inputs: every byte of blocks,
    idx and x read once and the output written once, against the FMA of the
    stored non-zeros only (padding and zeros inside tiles need none)."""
    import torch
    N = x.shape[1]
    out_bytes = blocks.shape[0] * blocks.shape[2] * N * 4
    nbytes = (blocks.numel() * 4 + idx.numel() * 4 + x.numel() * 4
              + out_bytes)
    flops = 2.0 * int(torch.count_nonzero(blocks)) * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def check_spmm(label, a, x, *, time_it=False, csr=None):
    """Kernel vs plain version on the card for one operand; returns a dict
    of the numbers measured."""
    import torch
    from repro_torch.kernels import spmm_blocked_ell, spmm_blocked_ell_plain
    out = spmm_blocked_ell(a.blocks, a.idx, x)
    plain = spmm_blocked_ell_plain(a.blocks, a.idx, x)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: kernel output is not finite")
    err = float((out - plain).abs().max())
    torch.testing.assert_close(out, plain, atol=ATOL, rtol=RTOL,
                               msg=lambda m: f"{label}: {m}")
    row = {"label": label, "shape": list(a.blocks.shape) + [x.shape[1]],
           "max_abs_err": err}
    if time_it:
        row["ms"] = time_ms(lambda: spmm_blocked_ell(a.blocks, a.idx, x), 10)
        row["plain_ms"] = time_ms(
            lambda: spmm_blocked_ell_plain(a.blocks, a.idx, x), 3)
        row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = \
            spmm_bound(a.blocks, a.idx, x)
        row["padded_flops"] = 2.0 * a.blocks.numel() * x.shape[1]
        row["padded_tflop_per_s"] = row["padded_flops"] / row["ms"] / 1e9
        row["library_ms"] = None
        if csr is not None:
            # the same product's bound from the CSR form: no padding
            csr_bytes = sum(t.numel() * t.element_size() for t in
                            (csr.indptr, csr.indices, csr.data, x)) \
                + out.numel() * out.element_size()
            row["csr_bytes"] = csr_bytes
            row["csr_bound_ms"] = max(csr_bytes / HBM_BYTES_PER_S,
                                      row["flops"] / FP32_FLOP_PER_S) * 1e3
            lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                          size=csr.shape)
            ref = torch.sparse.mm(lib, x)
            torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
            row["library_ms"] = time_ms(lambda: torch.sparse.mm(lib, x), 10)
    torch.cuda.synchronize()
    print(json.dumps(row), flush=True)
    return row


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a machine with an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.data import table1_graph
    from repro_torch.kernels import BlockedEll, _build, spmm_blocked_ell
    from repro_torch.launch.serve_pipeline import gcn_plain, serve
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

    # 2) kernel vs plain on the card
    phase("2. kernels vs their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    graph = table1_graph("OA", device=dev)
    adj = BlockedEll.from_csr(graph, 16, 16, device=dev)
    torch.cuda.synchronize()
    print(f"ogbn-arxiv graph V={graph.shape[0]} nnz={graph.nnz}, blocked-ELL "
          f"{tuple(adj.blocks.shape)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    x = torch.randn((graph.shape[0], 128), generator=gen, device=dev)
    rows = [check_spmm("OA bm=bk=16 N=128", adj, x, time_it=True, csr=graph)]
    oa = rows[0]
    rows.append(check_spmm("OA bm=bk=16 N=100", adj,
                           torch.randn((graph.shape[0], 100), generator=gen,
                                       device=dev)))
    del adj, x
    rng = np.random.default_rng(7)
    a = rng.normal(size=(256, 384)).astype(np.float32)
    a[rng.random(a.shape) > 0.08] = 0.0
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
    spmm_blocked_ell.launches = 0
    with torch.inference_mode():
        res = serve("OA", 8, device=dev)
    torch.cuda.synchronize()
    launches = spmm_blocked_ell.launches
    print(f"[main] {res.out.shape[0]} requests in {res.seconds * 1e3:.3f} ms "
          f"({res.inf_per_s:.3f} inf/s), max err vs plain GCN "
          f"{res.max_err:.3e}; schedule {res.schedule} -> {res.rescheduled} "
          f"after drift; spmm_blocked_ell launches {launches}", flush=True)
    if launches != 2 * 8:
        raise AssertionError(f"expected 16 kernel launches, saw {launches}")
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

    kernels = [{
        "name": "spmm_blocked_ell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_blocked_ell.cu",
        "replaces": "src/repro/kernels/spmm.py:71", "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": oa["ms"], "plain_ms": oa["plain_ms"],
        "bound_ms": oa["bound_ms"], "bound_by": oa["bound_by"],
        "library_ms": oa["library_ms"]}]
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
