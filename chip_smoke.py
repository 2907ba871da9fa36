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
   wgmma kernel (bf16, D 64/128/256; the prefill paths') and the FMA
   kernel (float32), each where ``swa_attention`` routes, at the prefill
   path's shape (q (2, 32, 16384, 128), k/v (2, 8, 16384, 128), window
   4096, read in place from (B, S, H, D) activations; float32, then bf16)
   and at edge shapes (S/window (256,128), (384,128), (512,256),
   (256,256), (128,128); D 64/128; GQA group 1/4/8; float32 and bf16; and
   D 256 at (512,256), group 8), with the same numbers, and at D 256 in
   bf16 on the wgmma kernel's 64-key tiles (S/window (128,128),
   (256,128), (384,128), (512,256), (1024,128), (1024,512); group 1 and
   4 of 2 KV heads, and 8 of 1, paligemma's MQA); on the bf16 main-shape
   input a second call of the wgmma kernel must give the same bits, and
   the wgmma kernel, the FMA kernel and the yardstick, PyTorch's
   memory-efficient SDPA with the band as a mask, are timed; the wgmma
   kernel's registers, spills and shared memory are recorded for each of
   its instantiations (``<64>``, ``<128>``, ``<256>``);
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
   tokens;
11. drive DyPe's streaming serving path: ``repro_torch.launch.serve
   --stream --backend torch`` in process (TrafficSim's four-signature mix,
   120 s of traffic at peak 10 req/s, two FPGAs failing at 40 s and
   rejoining at 80 s, wall-clock calibration over 4 reports, async
   dispatch) through Router -> Engine -> DP -> ``TorchPipelineBackend``,
   whose spmm stages run the row-wise CSR SpMM kernel; launch counters set
   to 0 just before and read just after (more than 0 ``spmm_csr_rows``
   launches, none of the other kernels). The same stream on the analytic
   backend must give the same completed, dropped, reschedules, sorted
   latencies and schedules; every spmm product of every payload the stream
   prepared, at each microbatch count, is held bit for bit to the plain
   version and to 0.5 * roll; one microbatch through each card payload is
   held to the same payload built on the CPU (1e-5); the calibrator must
   have locked at least one (cell, stage) scale. It prints the stream's
   wall seconds, simulated req/s, batches, the mean and p50 device ms a
   batch (CUDA events), and the card's busy share of a second, profiled
   run of the stream;
12. drive DyPe's multi-host control plane: ``serve --stream --cluster 2
   --backend torch`` in process, two in-process workers, each a
   ``TorchPipelineBackend`` on the card, behind the Controller and
   ``ClusterBackend``, in the documented scenarios (120 s at peak 10
   req/s, calibration over 4 reports): a worker killed at 40 s, a
   declared 60x host with stealing, hot-cell replication with migration,
   learned profiles of an undeclared 60x host (peak 24), predictive
   autoscaling, and the Pareto governor under a 700 W cap of the DyPe
   energy model with a 30 J SLO (60 s). Launch counters set to 0 just
   before each torch run and read just after (more than 0
   ``spmm_csr_rows`` launches, none of the other kernels); every worker's
   backend on the card; every report event-timed. Each torch run is paired
   with the same command on the analytic backend: the cluster event log's
   JSONL byte-identical (all but the learned-profile run, which learns
   from card time and prints both runs' learned profiles), and in the
   kill run equal completed, dropped, requeued, sorted latencies and
   schedules, no request lost, and a replay of the recorded log on the
   card recording the same log again; the governor's watts, joules a
   request and operating-point switches equal. Then one remote worker, a
   spawned process running the torch backend on the card: ping, prepare
   and a submit of 2, whose report's finishes equal the analytic ones and
   whose stage times are event-timed; it prints the spawn-to-report wall.
   It prints a ``{"cluster": {...}}`` line;
13. drive DyPe's multi-tenant serving and observability on the card:
   (a) phase 11's stream with two tenants (gold band 0 with a 2.5 s SLO,
   bronze band 2 with 9x the share and a 15 s SLO: the TENANTS_SLO grid
   of benchmarks/scenario_matrix.py), a span trace and the HTML
   dashboard, on ``--backend torch`` in process and on the analytic
   backend: equal completed, dropped, preemptions, preempted requests,
   tenant rows and sorted latencies, no request lost, at least one
   preemption, more than 0 ``spmm_csr_rows`` launches and none of the
   other kernels, a trace that ``obs.schema.validate`` passes at chain
   coverage 1.0, and every preempted batch's future dropped unread and
   freed; (b) the documented tenancy command (docs/tenancy.md:136-138,
   the Azure LLM excerpt, ``--tenants gold:0:1,bronze:2:3``), torch
   against analytic, equal output but the wall lines (LLM signatures
   only: its launch count is printed as it is); (c) the observability
   quickstart (docs/observability.md:29-34) with two torch workers on the
   card against its analytic twin: the event log byte-identical, the
   trace valid at coverage 1.0, the dashboard frames equal but the
   wall-clock placement times and the workers' measured occupancy; (d)
   ``obs.DashboardServer`` on 127.0.0.1 with an ephemeral port: one
   frame pushed, read back over HTTP and over server-sent events, then
   closed. It prints a ``{"tenancy": {...}}`` line with the card's name
   and power limit;
14. drive the decode mode of ``repro_torch.launch.serve`` and the hybrid
   family: (a) the decode CLI in process at full width and depth, 8
   sequences x (128 prompt + 128 generated) tokens, for gemma-2b, gemma-2b
   with ``--int8`` (every eligible leaf a ``QuantizedArray``), mamba2-780m
   and zamba2-7b, each with its tok/s, ms a step and peak memory, and
   with every kernel's launch counter set to 0 just before and read just
   after (the decode steps launch none); (b) the SWA ring buffer against
   B2: qwen3-4b under long_500k (window 4096) at full width with its
   depth cut to 4 layers (phase 6 serves the full depth), one seeded
   8192-token prompt prefilled through ``lm.forward`` (4
   ``swa_attention_wgmma`` launches) and decoded teacher-forced through
   ``make_serve_step`` up to position 4223 (the ring of 4096 slots wraps
   at 4096); (c) the
   recurrence against B3: mamba2-780m, 2 x 512 tokens, prefilled on the
   tensor-core route (48 calls) and decoded teacher-forced; in (b) and (c)
   each token mixer's decode output at every position is held to its
   prefill (the served kernel) on the same inputs within 2e-2 of its
   largest output, and the logits are compared at positions 4095..4223
   and at every position; (c) is repeated on a float32 copy of the model
   (prefill on the FMA SSD kernel), each mixer held at 1e-4; (d)
   zamba2-7b at full width and depth, 2 x 8,192
   tokens through ``serve_prefill`` (54 SSD calls on the tensor-core
   route: 54 launches of each of K1/K2/K3, no other kernel), every call
   held to the plain version at one bf16 ulp, the route timed at
   zamba2's shape (N 64, 112 heads), and (c)'s comparisons on zamba2 (its
   float32 copy over the first 256 tokens). It prints a ``{"decode":
   {...}}`` line with the card's name and power limit. In bfloat16 the
   rounding differences between the prefill's and the decode's products
   grow with depth, so the end-to-end logits are held within 2e-2 of the
   largest on the float32 copies, with the same argmax where the
   prefill's top two differ by more; in bfloat16 the ring's argmax is
   held so.

15. drive the rest of the LM zoo, each family at full width: (a) the
   decode CLI in process at phase 14's sizes (8 x (128 + 128) tokens,
   every launch counter set to 0 just before and read just after: none
   launches) for paligemma-3b and seamless-m4t-large-v2 at full depth
   (the encoder output a tensor of ones, as the reference's decode mode
   has it) and for deepseek-v2-236b with its depth cut to 3 layers (its
   own 1 dense + 2 MoE; one MoE layer is 3.97 B parameters, so the full
   model does not fit one card) through ``serve.decode``; (b)
   ``serve_prefill`` of paligemma-3b under long_500k, 2 x 16,384
   positions (256 seeded image-prefix embeddings + 16,128 text tokens;
   18 launches of the wgmma SWA kernel, the route of bf16 with D 256, and
   none of any other, the FMA kernel's included), every kernel call held
   to the plain version at one bf16 ulp in a rerun of the forward that
   must give the served logits bit for bit, and the route at that shape
   held, called twice for the same bits, and timed with its bound, the
   FMA kernel, the plain version and SDPA as the yardstick;
   seamless-m4t-large-v2, 2 x 8,192 (source frames and
   tokens), and deepseek-v2-236b at 3 layers, 2 x 4,096, both launching
   no kernel; two MoE calls on one input giving the same bits; (c) each
   MLA and each self- and cross-attention mixer's decode held to its
   prefill on the same inputs at every position of 2 x 256 tokens
   (deepseek at 3 layers, seamless), within 2e-2 of its largest output;
   and a float32 copy of deepseek at 2 layers, its capacity factor raised
   so that the prefill drops no assignment, whose logits must agree
   within 2e-2 of the largest with the same argmax where the top two are
   clear. It prints a ``{"zoo": {...}}`` line with the card's name and
   power limit.

Then it prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.

Run from the root of a checkout:  python3 chip_smoke.py
"""
import gc
import json
import subprocess
import weakref
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
# the reference launcher's documented stream (repro/launch/serve.py:6-8)
STREAM_ARGV = ["--stream", "--duration", "120", "--day", "120",
               "--peak-rate", "10", "--trough-rate", "0.5", "--fail-at", "40",
               "--rejoin-at", "80", "--fail-count", "2", "--calibrate-wall",
               "4", "--seed", "0"]
PAYLOAD_TOL = 1e-5        # card payload vs CPU payload (tests' tolerance)
# phase 12: the documented cluster, fleet and governor commands
# (docs/cluster.md:233-236, docs/heterogeneity.md:192, docs/fleet.md:203-209,
# docs/energy.md:130-131) on the phase-11 traffic; later flags win
CLUSTER_ARGV = ["--stream", "--duration", "120", "--day", "120",
                "--peak-rate", "10", "--trough-rate", "0.5",
                "--calibrate-wall", "4", "--seed", "0", "--cluster", "2"]
CLUSTER_SCENARIOS = {
    "kill": ["--kill-worker", "40"],
    "steal": ["--host-profiles", "w1=60", "--steal"],
    "replicate": ["--replicate-hot", "2", "--forecast-horizon", "5",
                  "--migrate"],
    "learn": ["--peak-rate", "24", "--true-host-profiles", "w1=60",
              "--learn-profiles", "--steal"],
    "autoscale": ["--autoscale", "--forecast-horizon", "5",
                  "--mode-cooldown", "5"],
    "governor": ["--duration", "60", "--governor", "--forecast-horizon", "5",
                 "--power-cap-w", "700", "--energy-slo-j", "30"],
}

# phase 13: phase 11's stream with tenants (TENANTS_SLO of
# benchmarks/scenario_matrix.py:52), the documented tenancy command
# (docs/tenancy.md:136-138) and the observability quickstart
# (docs/observability.md:29-34)
TENANT_ARGV = STREAM_ARGV + ["--tenants", "gold:0:1:2.5,bronze:2:9:15"]
AZURE_ARGV = ["--stream", "--trace-in",
              str(Path(__file__).resolve().parent / "examples" / "traces"
                  / "azure_llm_excerpt.jsonl"),
              "--tenants", "gold:0:1,bronze:2:3"]
OBS_ARGV = ["--stream", "--duration", "60", "--cluster", "2",
            "--host-profiles", "w1=60", "--steal", "--peak-rate", "24",
            "--dashboard", "--dashboard-every", "5"]
# a dashboard frame's wall-clock fields (placement latency)
FRAME_WALL = ("place_ms_p50", "place_ms_p99")
# phase 14: the decode CLI at full width and depth (the verify skill's
# "--arch gemma-2b --smoke --batch 2 --prompt-len 8 --gen 8" at a card's
# size), and the decode held to the B2 and B3 prefills of the same tokens
DECODE_ARGV = ["--batch", "8", "--prompt-len", "128", "--gen", "128"]
DECODE_RUNS = {"gemma-2b": ["--arch", "gemma-2b"],
               "gemma-2b --int8": ["--arch", "gemma-2b", "--int8"],
               "mamba2-780m": ["--arch", "mamba2-780m"],
               "zamba2-7b": ["--arch", "zamba2-7b"]}
# decode vs prefill in bfloat16, as a share of the largest logit (or of a
# mixer's largest output): the port's bf16 prefill parity bound
DECODE_LOGIT_TOL = 2e-2
# (b) qwen3-4b under long_500k (window 4096) at full width, its depth cut
# to 4 layers: one 8192-token prompt, the ring of 4096 slots wrapping at
# 4096, logits compared at 4095..4223 (the decode is host-bound, ~80 ms a
# step at full depth, so 128 positions past the wrap; the depth cut takes
# the 4,224 steps from ~190-360 s to a ninth of it; phase 6 keeps the
# full-depth prefill on B2)
RING = {"arch": "qwen3-4b", "n_layers": 4, "prompt_len": 8192,
        "first": 4095, "last": 4223}
# (c) mamba2-780m and (d) zamba2-7b: decode vs prefill of 2 x 512 tokens;
# zamba2's float32 copy over the first 256 of them (~130 ms a step)
RECUR = {"batch": 2, "prompt_len": 512}
HYBRID_FP32_LEN = 256
HYBRID_PREFILL = {"arch": "zamba2-7b", "shape": "prefill_32k", "batch": 2,
                  "prompt_len": 8192}
# phase 15: the rest of the zoo at full width. paligemma-3b and
# seamless-m4t-large-v2 at full depth; deepseek-v2-236b cut to 3 layers
# (its own 1 dense + 2 MoE: 9,330,795,520 parameters, 18.7 GB in bf16; one
# MoE layer holds 3.97 B), its float32 copy to 2 (1 + 1, 21.4 GB)
ZOO_DECODE = {"paligemma-3b": ["--arch", "paligemma-3b"],
              "seamless-m4t-large-v2": ["--arch", "seamless-m4t-large-v2"]}
ZOO_MOE = {"arch": "deepseek-v2-236b", "n_layers": 3, "fp32_layers": 2}
# (b) prefills: paligemma under long_500k (SWA 4096 with D 256 and MQA: the
# wgmma kernel, one launch a layer) over 256 image-prefix embeddings and
# 16,128 text tokens; seamless over 8,192 source frames and tokens
ZOO_PREFILL = {
    "paligemma-3b": {"shape": "long_500k", "batch": 2, "prompt_len": 16384},
    "seamless-m4t-large-v2": {"shape": "prefill_32k", "batch": 2,
                              "prompt_len": 8192},
    "deepseek-v2-236b": {"shape": "prefill_32k", "batch": 2,
                         "prompt_len": 4096}}
# (c) decode vs prefill of 2 x 256 tokens
ZOO_RECUR = {"batch": 2, "prompt_len": 256}


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
    wgmma kernel takes) also a second call of that kernel, which must give
    the same bits, the FMA kernel on the same input, held to the plain
    version too, and the times of both kernels, the plain version and the
    library yardstick, with the bound. Returns a dict of the numbers
    measured."""
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
        again = kernel(q, k, v, window=window, scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(again, out):
            raise AssertionError(f"{label}: two calls of the {route} kernel "
                                 f"differ")
        row["bit_repeatable"] = True
        del again
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


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def holding_spmm(shapes, act_batch):
    """A stand-in for ``ops.spmm_csr_rows`` on the stream's ring graph:
    launches the kernel, holds its output bit for bit to the plain version
    on the same card tensors and to 0.5 * roll along each microbatch's
    rows, and returns the kernel's. Each call's x shape goes to
    ``shapes``."""
    import torch
    from repro_torch.kernels import spmm_csr_rows, spmm_csr_rows_plain

    def call(indptr, indices, values, x):
        out = spmm_csr_rows(indptr, indices, values, x)
        plain = spmm_csr_rows_plain(indptr, indices, values, x)
        m, f = x.shape[0] // act_batch, x.shape[1]
        roll = (0.5 * torch.roll(x.reshape(m, act_batch, f), 1, dims=1)) \
            .reshape(x.shape)
        torch.cuda.synchronize()
        if not (torch.equal(out, plain) and torch.equal(out, roll)):
            raise AssertionError(f"spmm_csr_rows on the stream's ring graph, "
                                 f"x {tuple(x.shape)}: differs from the "
                                 f"plain version or from 0.5 * roll")
        shapes.append(tuple(x.shape))
        return out
    return call


def stream(argv):
    """Run ``repro_torch.launch.serve --stream`` in process; returns
    ``(router, snapshot, wall seconds, summary lines)``. The per-batch log
    lines are counted, not printed."""
    import contextlib
    import io
    from repro_torch.launch.serve import parse_args, run_stream
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        router, _, snap, wall = run_stream(parse_args(argv))
    lines = out.getvalue().splitlines()
    summary = [l for l in lines if not l.startswith("[serve]   ")]
    summary.append(f"[serve] ({len(lines) - len(summary)} router and engine "
                   f"log lines)")
    return router, snap, wall, summary


def lost_requests(router, snap):
    """Admitted requests neither completed nor dropped, plus what is left
    queued or in flight after the drain."""
    return (router.queue.stats.admitted - snap.completed - snap.dropped
            + len(router.queue) + len(router.engine.inflight))


def cluster_scenario(name, extra, counters, base=CLUSTER_ARGV,
                     per_backend=lambda backend: []):
    """Phase 12 (and 13 c), one scenario: ``serve --stream --cluster 2``
    (``base + extra``) on the torch backend (the card) and on the analytic
    backend with the same argv (but ``per_backend(backend)``'s output
    paths), held to each other; returns (its row, spmm_csr_rows
    launches)."""
    import torch
    from repro_torch.kernels import spmm_csr_rows
    from repro_torch.runtime import TorchPipelineBackend

    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    logs = {b: out / f"cluster_{name}_{b}.jsonl"
            for b in ("torch", "analytic", "replay")}
    reports = []
    real_execute = TorchPipelineBackend.execute

    def recording_execute(self, handle, batch, t0):
        rep = real_execute(self, handle, batch, t0)
        reports.append(rep)
        return rep

    argv = base + extra
    with mock.patch.object(TorchPipelineBackend, "execute",
                           recording_execute):
        spmm_csr_rows.launches = 0
        for f in counters:
            f.launches = 0
        router, snap, wall, summary = stream(
            argv + per_backend("torch") + [
                "--backend", "torch", "--record-cluster-events",
                str(logs["torch"])])
        torch.cuda.synchronize()
        launches = spmm_csr_rows.launches
        others = {f.__name__: f.launches for f in counters if f.launches}
    a_router, a_snap, a_wall, a_summary = stream(
        argv + per_backend("analytic") + ["--record-cluster-events",
                                          str(logs["analytic"])])
    ctrl = router.engine.backend.controller
    devices = {wid: (link.peer.core.backend.name,
                     str(link.peer.core.backend.device))
               for wid, link in ctrl.links.items()}
    batch_ms = sorted(sum(r.measured_stage_times) * 1e3 for r in reports)
    row = {"wall_s": wall, "analytic_wall_s": a_wall,
           "completed": snap.completed, "dropped": snap.dropped,
           "requeued": snap.requeued, "steals": snap.steals,
           "events": len(ctrl.events), "batches": len(reports),
           "spmm_csr_rows_launches": launches,
           "device_ms_per_batch_mean": sum(batch_ms) / max(len(batch_ms), 1),
           "device_ms_per_batch_p50": (batch_ms[(len(batch_ms) - 1) // 2]
                                       if batch_ms else None),
           "host_ms_per_batch": wall * 1e3 / max(len(reports), 1),
           "lost": lost_requests(router, snap), "workers": devices}
    same_log = logs["torch"].read_bytes() == logs["analytic"].read_bytes()
    row["log_equal"] = same_log
    print("\n".join(summary), flush=True)
    print(f"[cluster {name}] torch: {snap.completed} completed, "
          f"{snap.dropped} dropped, {snap.requeued} requeued, "
          f"{snap.steals} steals, {row['events']} events in {wall:.3f} s "
          f"wall ({row['host_ms_per_batch']:.4f} host ms a batch); "
          f"{len(reports)} batches, device ms a batch (events) mean "
          f"{row['device_ms_per_batch_mean']:.4f}, p50 "
          f"{row['device_ms_per_batch_p50']}; spmm_csr_rows launches "
          f"{launches}; other kernels {others or 'none'}; workers "
          f"{devices}; event log "
          f"{'equal to' if same_log else 'DIFFERS from'} the analytic "
          f"run's", flush=True)
    if any(d != ("torch", str(torch.device("cuda", 0)))
           for d in devices.values()):
        raise AssertionError(f"{name}: a worker is not torch on the card: "
                             f"{devices}")
    if launches <= 0 or others:
        raise AssertionError(f"{name}: expected spmm_csr_rows launches and "
                             f"no other kernel's, saw {launches} and "
                             f"{others}")
    if not reports or not all(len(r.measured_stage_times) and all(
            t > 0 for t in r.measured_stage_times) for r in reports):
        raise AssertionError(f"{name}: a cluster batch has no event timing")
    if row["lost"] or lost_requests(a_router, a_snap):
        raise AssertionError(f"{name}: requests lost: torch {row['lost']}, "
                             f"analytic {lost_requests(a_router, a_snap)}")
    if name == "learn":
        # learned from card time here, from the schedule model there
        for backend, lines in (("torch", summary), ("analytic", a_summary)):
            row[f"learned_{backend}"] = [
                l for l in lines if "learned profile" in l or "gated" in l]
        print(f"[cluster learn] learned on torch: {row['learned_torch']}; "
              f"on analytic: {row['learned_analytic']}", flush=True)
        return row, launches
    if not same_log:
        raise AssertionError(f"{name}: the torch run's cluster event log "
                             f"differs from the analytic run's")
    same = {"completed": (snap.completed, a_snap.completed),
            "dropped": (snap.dropped, a_snap.dropped),
            "requeued": (snap.requeued, a_snap.requeued),
            "steals": (snap.steals, a_snap.steals),
            "latencies": (sorted(router.metrics.latencies),
                          sorted(a_router.metrics.latencies)),
            "schedules": (sorted({d.mnemonic for d in router.dispatches}),
                          sorted({d.mnemonic for d in a_router.dispatches})),
            "watts_mean": (snap.watts_mean, a_snap.watts_mean),
            "joules_per_req": (snap.joules_per_req, a_snap.joules_per_req),
            "opoint_switches": (snap.opoint_switches,
                                a_snap.opoint_switches)}
    differ = [k for k, (a, b) in same.items() if a != b]
    if differ:
        raise AssertionError(f"{name}: torch vs analytic differ in {differ}")
    if name == "kill":
        if not snap.requeued or "failure" not in ctrl.events.kinds():
            raise AssertionError("kill: no worker loss, or nothing requeued")
        # the recorded log replayed on the card records the same log
        r_router, r_snap, _, _ = stream(
            CLUSTER_ARGV + ["--backend", "torch", "--replay-cluster-events",
                            str(logs["torch"]), "--record-cluster-events",
                            str(logs["replay"])])
        if logs["replay"].read_bytes() != logs["torch"].read_bytes():
            raise AssertionError("kill: the replay on the card recorded "
                                 "another log")
        row["replay_log_equal"] = True
    if name == "steal" and not snap.steals:
        raise AssertionError("steal: no batch was stolen")
    if name == "governor":
        row.update(watts_mean=snap.watts_mean,
                   joules_per_req=snap.joules_per_req,
                   opoint_switches=snap.opoint_switches)
    print(f"[check] {name}: torch vs analytic event log byte for byte, "
          f"{', '.join(same)} equal"
          + ("; the replay records the same log" if name == "kill" else ""),
          flush=True)
    return row, launches


def remote_torch_worker():
    """Phase 12: one spawned worker process running the torch backend on
    the card (tests/test_cluster.py:61 with backend="torch"); returns its
    row with the spawn-to-first-report wall."""
    from repro_torch.cluster import mp_worker
    from repro_torch.core import (DATASETS, DynamicScheduler, PerfModel,
                                  gcn_workload, paper_system)
    from repro_torch.runtime import AnalyticBackend

    wl = gcn_workload(DATASETS["OA"])
    dyn = DynamicScheduler(paper_system("pcie4"), PerfModel(), mode="perf")
    res = dyn.submit(wl)
    t0 = time.perf_counter()
    chan, proc = mp_worker("mp0", {"FPGA": 3, "GPU": 2}, backend="torch")
    try:
        chan.send({"op": "ping", "echo": 42})
        pong = chan.recv_wait(timeout=300.0)
        t_pong = time.perf_counter() - t0
        chan.send({"op": "prepare", "hid": 0, "schedule": res,
                   "workload": wl, "epoch": dyn.epoch})
        prepared = chan.recv_wait(timeout=120.0)
        chan.send({"op": "submit", "hid": 0, "sid": 7, "n": 2, "t0": 1.0})
        acc = chan.recv_wait(timeout=120.0)
        rep = chan.recv_wait(timeout=120.0)
        t_report = time.perf_counter() - t0
        chan.send({"op": "stop"})
    finally:
        proc.join(timeout=120.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
    want = AnalyticBackend().execute(AnalyticBackend().prepare(res, wl), 2,
                                     1.0)
    report = rep["report"] if rep else None
    row = {"spawn_to_pong_s": t_pong, "spawn_to_report_s": t_report,
           "exitcode": proc.exitcode,
           "measured_stage_times": (list(report.measured_stage_times)
                                    if report else None)}
    print(f"[remote] spawned torch worker: pong after {t_pong:.3f} s, first "
          f"report after {t_report:.3f} s; measured stage times "
          f"{row['measured_stage_times']}; exit code {proc.exitcode}",
          flush=True)
    if pong != {"op": "pong", "wid": "mp0", "echo": 42} or \
            prepared["op"] != "prepared" or acc["op"] != "accepted":
        raise AssertionError(f"remote worker protocol: {pong}, {prepared}, "
                             f"{acc}")
    if rep["op"] != "report" or report.finishes != want.finishes:
        raise AssertionError(f"remote worker report {rep} differs from the "
                             f"analytic finishes {want.finishes}")
    if not report.measured_stage_times or not all(
            t > 0 for t in report.measured_stage_times):
        raise AssertionError("the remote report has no event timing")
    if proc.exitcode != 0:
        raise AssertionError(f"remote worker exited {proc.exitcode}")
    print("[check] remote torch worker: finishes equal the analytic "
          "backend's; stage times event-timed; exit 0", flush=True)
    return row


def mask_frame(frame):
    """A dashboard frame without its wall-clock fields and each worker's
    occupancy, which on torch workers reads card seconds (the heartbeats'
    measured ``stage_s``)."""
    out = {k: v for k, v in frame.items() if k not in FRAME_WALL}
    out["workers"] = [{k: v for k, v in w.items() if k != "busy_frac"}
                      for w in frame["workers"]]
    return out


def html_frames(path):
    """The frames a ``--dashboard-html`` page embeds."""
    html = Path(path).read_text()
    return json.loads(html.split("const FRAMES = ", 1)[1].split(";\n", 1)[0])


def validated(path):
    """``obs.schema.validate`` of a span JSONL; raises on any error or on
    chain coverage below 1.0. Returns (spans, coverage)."""
    from repro_torch.obs import read_jsonl, validate
    errors, stats = validate(read_jsonl(path))
    if errors or stats["coverage"] != 1.0:
        raise AssertionError(f"{path}: {len(errors)} schema errors "
                             f"{errors[:3]}, coverage {stats['coverage']}")
    return stats["spans"], stats["coverage"]


def summary_minus_wall(lines, out_dir=None):
    """Summary lines but those holding "wall" or (with ``out_dir``) an
    output path, with the backend's name blanked."""
    return [l.replace("backend=torch ", "backend=analytic ") for l in lines
            if "wall" not in l
            and (out_dir is None or str(out_dir) not in l)]


def tenant_stream(counters):
    """Phase 13 (a): phase 11's stream with two tenants on the card and on
    the analytic backend; returns (its row, spmm_csr_rows launches)."""
    import torch
    from repro_torch.kernels import spmm_csr_rows
    from repro_torch.runtime import TorchPipelineBackend

    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    files = {b: (out / f"tenant_{b}.jsonl", out / f"tenant_{b}.html")
             for b in ("torch", "analytic")}
    futures = []
    real_submit = TorchPipelineBackend.submit

    def recording_submit(self, handle, batch, t0):
        fut = real_submit(self, handle, batch, t0)
        futures.append(fut)
        return fut

    def argv(backend):
        spans, html = files[backend]
        return TENANT_ARGV + ["--backend", backend, "--trace-out",
                              str(spans), "--dashboard-html", str(html)]
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    with mock.patch.object(TorchPipelineBackend, "submit",
                           recording_submit):
        spmm_csr_rows.launches = 0
        for f in counters:
            f.launches = 0
        router, snap, wall, summary = stream(argv("torch"))
        torch.cuda.synchronize()
        launches = spmm_csr_rows.launches
        others = {f.__name__: f.launches for f in counters if f.launches}
    print("\n".join(summary), flush=True)
    backend = router.engine.backend
    resolved = [f.done() for f in futures]
    reports = [f.result() for f in futures if f.done()]
    refs = [weakref.ref(f) for f, done in zip(futures, resolved)
            if not done]
    futures.clear()
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    batch_ms = sorted(sum(r.measured_stage_times) * 1e3 for r in reports)
    a_router, a_snap, a_wall, a_summary = stream(argv("analytic"))
    spans, coverage = validated(files["torch"][0])
    row = {"wall_s": wall, "analytic_wall_s": a_wall,
           "completed": snap.completed, "dropped": snap.dropped,
           "preemptions": snap.preemptions,
           "preempted_requests": snap.preempted_requests,
           "tenants": snap.tenants, "batches": len(router.dispatches),
           "host_ms_per_batch": wall * 1e3 / len(router.dispatches),
           "device_ms_per_batch_mean": sum(batch_ms) / len(batch_ms),
           "device_ms_per_batch_p50": batch_ms[(len(batch_ms) - 1) // 2],
           "spmm_csr_rows_launches": launches,
           "preempted_futures_unread": len(refs),
           "preempted_futures_alive": sum(r() is not None for r in refs),
           "device_bytes_kept": mem1 - mem0, "spans": spans,
           "coverage": coverage,
           "frames": len(html_frames(files["torch"][1])),
           "lost": lost_requests(router, snap)}
    print(f"[tenancy a] torch: {snap.completed} completed, {snap.dropped} "
          f"dropped, {snap.preemptions} preemptions "
          f"({snap.preempted_requests} requests) in {wall:.3f} s wall "
          f"({row['host_ms_per_batch']:.4f} host ms a batch); "
          f"{row['batches']} batches, device ms a batch (events) mean "
          f"{row['device_ms_per_batch_mean']:.4f}, p50 "
          f"{row['device_ms_per_batch_p50']:.4f}; spmm_csr_rows launches "
          f"{launches}; other kernels {others or 'none'}; {len(refs)} "
          f"preempted futures unread, {row['preempted_futures_alive']} "
          f"alive after the run; {mem1 - mem0} device bytes kept; "
          f"{spans} spans, coverage {coverage}; {row['frames']} frames",
          flush=True)
    if backend.name != "torch" or backend.device.type != "cuda":
        raise AssertionError(f"the tenanted stream ran on {backend.name} "
                             f"{getattr(backend, 'device', None)}")
    if launches <= 0 or others:
        raise AssertionError(f"expected spmm_csr_rows launches and no "
                             f"other kernel's, saw {launches} and {others}")
    if not all(len(r.measured_stage_times) and all(
            t > 0 for t in r.measured_stage_times) for r in reports):
        raise AssertionError("a tenanted batch has no event timing")
    if snap.preemptions < 1:
        raise AssertionError("the tenanted stream preempted nothing")
    if len(refs) != snap.preemptions or row["preempted_futures_alive"]:
        raise AssertionError(f"{len(refs)} unread futures for "
                             f"{snap.preemptions} preemptions, "
                             f"{row['preempted_futures_alive']} alive")
    if row["lost"] or lost_requests(a_router, a_snap):
        raise AssertionError(f"tenanted stream: requests lost: torch "
                             f"{row['lost']}, analytic "
                             f"{lost_requests(a_router, a_snap)}")
    same = {"completed": (snap.completed, a_snap.completed),
            "dropped": (snap.dropped, a_snap.dropped),
            "preemptions": (snap.preemptions, a_snap.preemptions),
            "preempted_requests": (snap.preempted_requests,
                                   a_snap.preempted_requests),
            "tenants": (snap.tenants, a_snap.tenants),
            "latencies": (sorted(router.metrics.latencies),
                          sorted(a_router.metrics.latencies)),
            "summary": (summary_minus_wall(summary, out),
                        summary_minus_wall(a_summary, out)),
            "log": (router.log + router.engine.log,
                    a_router.log + a_router.engine.log)}
    differ = [k for k, (a, b) in same.items() if a != b]
    if differ:
        raise AssertionError(f"tenanted stream: torch vs analytic differ "
                             f"in {differ}")
    print(f"[check] tenanted stream: torch vs analytic {', '.join(same)} "
          f"equal; no request lost; trace valid at coverage {coverage}",
          flush=True)
    return row, launches


def azure_tenancy(counters):
    """Phase 13 (b): the documented tenancy command on the card and on the
    analytic backend; returns its row (launches printed as they are)."""
    import torch
    from repro_torch.kernels import spmm_csr_rows

    spmm_csr_rows.launches = 0
    for f in counters:
        f.launches = 0
    router, snap, wall, summary = stream(AZURE_ARGV + ["--backend",
                                                       "torch"])
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in (spmm_csr_rows,) + counters}
    a_router, a_snap, a_wall, a_summary = stream(AZURE_ARGV)
    print("\n".join(summary), flush=True)
    backend = router.engine.backend
    row = {"wall_s": wall, "analytic_wall_s": a_wall,
           "completed": snap.completed, "dropped": snap.dropped,
           "preemptions": snap.preemptions, "tenants": snap.tenants,
           "batches": len(router.dispatches),
           "host_ms_per_batch": wall * 1e3 / len(router.dispatches),
           "launches": launches, "lost": lost_requests(router, snap)}
    print(f"[tenancy b] torch: {snap.completed} completed, {snap.dropped} "
          f"dropped, {snap.preemptions} preemptions in {wall:.3f} s wall "
          f"({row['host_ms_per_batch']:.4f} host ms a batch), "
          f"{row['batches']} batches; launches {launches}", flush=True)
    if backend.name != "torch" or backend.device.type != "cuda":
        raise AssertionError(f"the Azure stream ran on {backend.name}")
    if row["lost"] or lost_requests(a_router, a_snap):
        raise AssertionError("the Azure stream lost requests")
    differ = [k for k, (a, b) in {
        "summary": (summary_minus_wall(summary),
                    summary_minus_wall(a_summary)),
        "log": (router.log + router.engine.log,
                a_router.log + a_router.engine.log),
        "latencies": (sorted(router.metrics.latencies),
                      sorted(a_router.metrics.latencies))}.items() if a != b]
    if differ or not any(l.startswith("[serve] tenant gold:")
                         for l in summary):
        raise AssertionError(f"the Azure stream: torch vs analytic differ "
                             f"in {differ}")
    print("[check] Azure tenancy command: torch vs analytic summary, logs "
          "and latencies equal", flush=True)
    return row


def obs_quickstart(counters):
    """Phase 13 (c): the observability quickstart with two torch workers
    on the card against its analytic twin (``cluster_scenario``); returns
    (its row, spmm_csr_rows launches, the torch run's last frame)."""
    out = Path(__file__).resolve().parent / "build"
    files = {b: (out / f"obs_{b}.jsonl", out / f"obs_{b}.html")
             for b in ("torch", "analytic")}

    def per_backend(backend):
        spans, html = files[backend]
        return ["--trace-out", str(spans), "--dashboard-html", str(html)]
    row, launches = cluster_scenario("obs", [], counters, base=OBS_ARGV,
                                     per_backend=per_backend)
    spans, coverage = validated(files["torch"][0])
    frames = {b: html_frames(files[b][1]) for b in files}
    if list(map(mask_frame, frames["torch"])) != \
            list(map(mask_frame, frames["analytic"])):
        raise AssertionError("quickstart: the torch run's dashboard frames "
                             "differ from the analytic run's")
    row.update(spans=spans, coverage=coverage, frames=len(frames["torch"]),
               busy_frac_torch=[w["busy_frac"]
                                for w in frames["torch"][-1]["workers"]],
               busy_frac_analytic=[
                   w["busy_frac"] for w in frames["analytic"][-1]["workers"]])
    print(f"[check] quickstart: {spans} spans, coverage {coverage}; "
          f"{len(frames['torch'])} frames equal but "
          f"{', '.join(FRAME_WALL)} and busy_frac (last frame: torch "
          f"{row['busy_frac_torch']}, analytic "
          f"{row['busy_frac_analytic']})", flush=True)
    return row, launches, frames["torch"][-1]


def dashboard_server(frame):
    """Phase 13 (d): ``DashboardServer(port=0)`` on 127.0.0.1: push one
    frame, read it back over HTTP and server-sent events, close."""
    import urllib.request
    from repro_torch.obs import DashboardServer, dashboard_html

    t0 = time.perf_counter()
    server = DashboardServer(port=0)
    try:
        server.push(frame)
        with urllib.request.urlopen(server.url, timeout=30) as resp:
            page = resp.read().decode()
        with urllib.request.urlopen(server.url + "events",
                                    timeout=30) as resp:
            event = resp.readline().decode()
    finally:
        server.close()
    if page != dashboard_html([frame]) or not event.startswith("data: ") \
            or json.loads(event[len("data: "):]) != frame:
        raise AssertionError("DashboardServer did not serve the pushed "
                             "frame")
    row = {"url": server.url, "page_bytes": len(page),
           "round_trip_s": time.perf_counter() - t0}
    print(f"[check] DashboardServer at {server.url}: the page "
          f"({len(page)} bytes) and the first server-sent event hold the "
          f"pushed frame; closed", flush=True)
    return row


def key_leaves(tree, keys=()):
    """(key tuple, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_leaves(tree[k], keys + (k,))
    else:
        yield keys, tree


def decode_run(name, extra, counters, cfg=None):
    """Phases 14 (a) and 15 (a): ``repro_torch.launch.serve`` in its
    decode mode, in process, at DECODE_ARGV's sizes; every kernel's launch
    counter set to 0 just before and read just after (the decode steps run
    none). With ``cfg`` (a depth cut of a config whose full depth one card
    cannot hold) the run goes through ``serve.decode`` with that config,
    weights and prompt drawn as ``run_decode`` draws them. Under
    ``--int8`` every leaf that ``quant._eligible`` names must be a
    ``QuantizedArray``. Returns the run's row."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import init_params, model_decls, quant
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, P, gen = (int(DECODE_ARGV[DECODE_ARGV.index(f) + 1])
                 for f in ("--batch", "--prompt-len", "--gen"))
    if cfg is not None:
        dev = torch.device("cuda", 0)
        params = init_params(model_decls(cfg),
                             torch.Generator(device=dev).manual_seed(0), dev,
                             cfg.pdtype)
        prompt = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, P), dtype=np.int32)
    for f in counters:
        f.launches = 0
    if cfg is None:
        res = serve.run_decode(serve.parse_args(extra + DECODE_ARGV))
    else:
        tokens, dt = serve.decode(cfg, params, prompt, gen, device=dev)
        res = serve.DecodeResult(cfg, params, prompt, tokens, dt,
                                 P + gen - 1)
        del params
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches for f in counters if f.launches}
    cfg = res.cfg
    row = {"arch": cfg.name, "family": cfg.family, "int8": "--int8" in extra,
           "batch": B, "steps": res.steps, "seconds": res.seconds,
           "tok_per_s": res.tok_per_s, "ms_per_step": res.ms_per_step,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kernel_launches": launched}
    if row["int8"]:
        eligible = {k for k, d in key_leaves(model_decls(cfg))
                    if quant._eligible(k, d)}
        served = dict(key_leaves(res.params))
        row["quantized_leaves"] = sum(isinstance(l, quant.QuantizedArray)
                                      for l in served.values())
        wrong = sorted("/".join(k) for k, l in served.items()
                       if (k in eligible)
                       != isinstance(l, quant.QuantizedArray))
        if wrong or not eligible:
            raise AssertionError(f"{name}: int8 leaves wrong: {wrong}")
    print(f"[decode] {name}: {json.dumps(row)}", flush=True)
    if launched:
        raise AssertionError(f"{name}: the decode steps launched {launched}")
    if res.tokens.shape != (B, gen) or res.tokens.min() < 0 \
            or res.tokens.max() >= cfg.padded_vocab:
        raise AssertionError(f"{name}: tokens {res.tokens.shape} out of "
                             f"range")
    del res
    return row


def mixers(cfg, params):
    """Each token mixer of the decode step in its call order: (kind,
    weights), kind "a" (attention), "l" (MLA), "x" (cross-attention) or
    "m" (mamba)."""
    from repro_torch.models.lm import _hybrid, _layer
    if cfg.family == "hybrid":
        pat, n_macro = _hybrid(cfg)
        for i in range(n_macro):
            mi = 0
            for ch in pat:
                if ch == "a":
                    yield "a", params["shared_attn"]["attn"]
                else:
                    yield "m", _layer(params[f"mamba{mi}"], i)["mix"]
                    mi += 1
    elif cfg.family == "moe":
        for name, n in (("dense_layers", cfg.n_dense_layers),
                        ("moe_layers", cfg.n_layers - cfg.n_dense_layers)):
            for i in range(n):
                yield "l", _layer(params[name], i)["attn"]
    elif cfg.family == "encdec":
        for i in range(cfg.dec_layers):
            lp = _layer(params["dec_layers"], i)
            yield "a", lp["attn"]
            yield "x", lp["xattn"]
    else:
        kind = "m" if cfg.family == "ssm" else "a"
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            yield kind, lp["mix" if kind == "m" else "attn"]


def decode_vs_prefill(label, cfg, params, tokens, first, last, counters,
                      mixer_tol, enc_out=None):
    """Phases 14 (b)-(d) and 15 (c): the model's prefill of ``tokens``
    (B, S) through ``lm.forward`` (the kernels its dtype routes to;
    cross-attending to ``enc_out`` in the encdec family), logits at
    positions first..last, against a teacher-forced decode of the same
    tokens through ``make_serve_step`` up to position ``last`` (its
    encdec cache holding ``enc_out``), recording the logits there and
    every token mixer's input and output at every position. Then each
    mixer's prefill (attention_train: the SWA kernel or plain flash;
    mla_train: the expanded MLA on plain flash; the cross-attention over
    ``enc_out``; mamba_block: the SSD kernel) runs on the decode's
    recorded inputs and is held to the decode's outputs within
    ``mixer_tol`` of its largest output (one layer of rounding either
    way). The end-to-end logits' largest difference as a share of the
    largest logit, and the argmax agreement where the prefill's top two
    differ by more than DECODE_LOGIT_TOL of it, are returned for the
    caller to gate. No kernel launches during the decode."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import attention as attn_model
    from repro_torch.models import lm
    from repro_torch.models import mla as mla_model
    from repro_torch.models import ssm as ssm_model
    from repro_torch.models.layers import logits_from_hidden
    dev = tokens.device
    B = tokens.shape[0]
    S = last + 1
    row = {"label": label, "arch": cfg.name, "batch": B,
           "prefill_len": tokens.shape[1], "positions": [first, last]}
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        h = lm.forward(params, tokens, cfg, enc_out=enc_out)
        pre = logits_from_hidden(h[:, first:S], params, cfg)
    torch.cuda.synchronize()
    row["prefill_s"] = time.perf_counter() - t0
    row["prefill_launches"] = {f.__name__: f.launches for f in counters
                               if f.launches}
    del h
    kinds = [k for k, _ in mixers(cfg, params)]
    n = len(kinds)
    X = torch.empty((n, B, S, cfg.d_model), dtype=cfg.cdtype, device=dev)
    Y = torch.empty_like(X)
    logits, calls = [], [0]
    real_decode = lm.decode_step
    real_attn = attn_model.attention_decode_step
    real_mla = mla_model.mla_decode_step
    real_cross = lm._cross_attention
    real_mamba = ssm_model.mamba_decode_step

    def recording(fn):
        def call(p, x, *args, **kw):
            out = fn(p, x, *args, **kw)
            y = out[0] if isinstance(out, tuple) else out
            step, k = divmod(calls[0], n)
            X[k, :, step] = x[:, 0]
            Y[k, :, step] = y[:, 0]
            calls[0] += 1
            return out
        return call

    def recording_decode(params, token, pos, cache, cfg):
        out, cache = real_decode(params, token, pos, cache, cfg)
        if pos >= first:
            logits.append(out)
        return out, cache

    for f in counters:
        f.launches = 0
    serve = make_serve_step(cfg, device=dev)
    with mock.patch.object(lm, "decode_step", recording_decode), \
            mock.patch.object(attn_model, "attention_decode_step",
                              recording(real_attn)), \
            mock.patch.object(ssm_model, "mamba_decode_step",
                              recording(real_mamba)), \
            mock.patch.object(mla_model, "mla_decode_step",
                              recording(real_mla)), \
            mock.patch.object(lm, "_cross_attention",
                              recording(real_cross)), \
            torch.inference_mode():
        cache = lm.init_cache(cfg, B, tokens.shape[1], device=dev)
        if enc_out is not None:
            cache["enc_out"].copy_(enc_out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(S):
            nxt, cache = serve(params, tokens[:, pos:pos + 1], pos, cache)
        torch.cuda.synchronize()
    row["decode_s"] = time.perf_counter() - t0
    row["decode_ms_per_step"] = row["decode_s"] * 1e3 / S
    row["decode_launches"] = {f.__name__: f.launches for f in counters
                              if f.launches}
    if calls[0] != n * S:
        raise AssertionError(f"{label}: {calls[0]} mixer calls, not {n * S}")
    dec = torch.cat(logits, dim=1)
    if not torch.equal(nxt[:, 0], dec[:, -1].argmax(-1).to(torch.int32)):
        raise AssertionError(f"{label}: the serve step's token is not the "
                             f"argmax of its logits")
    scale = float(pre.abs().max())
    top2 = pre.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > DECODE_LOGIT_TOL * scale
    agree = dec.argmax(-1) == pre.argmax(-1)
    row["logit_share"] = float((dec - pre).abs().max()) / scale
    row["max_abs_logit"] = scale
    row["argmax_clear"] = int(clear.sum())
    row["argmax_clear_agree"] = int((agree & clear).sum())
    row["argmax_agree"] = int(agree.sum())
    row["compared"] = int(agree.numel())
    del pre, dec, logits, cache
    # each mixer's prefill on the decode's inputs, held to its outputs
    pad = S
    if cfg.attention == "swa" and cfg.window < S:
        pad = -(-S // cfg.window) * cfg.window
    positions = torch.arange(pad, device=dev).expand(B, pad)
    shares = []
    for f in counters:
        f.launches = 0
    with torch.inference_mode():
        for k, (kind, p) in enumerate(mixers(cfg, params)):
            x = X[k]
            if kind == "a":
                if pad > S:
                    x = torch.cat([x, x.new_zeros((B, pad - S, x.shape[-1]))],
                                  dim=1)
                y = attn_model.attention_train(
                    p, x, positions, cfg, window=lm._window(cfg))[:, :S]
            elif kind == "l":
                y = mla_model.mla_train(p, x, positions, cfg)
            elif kind == "x":
                y = real_cross(p, x, enc_out, cfg)
            else:
                y = ssm_model.mamba_block(p, x, cfg)
            shares.append(float((y.float() - Y[k].float()).abs().max())
                          / float(y.float().abs().max()))
    torch.cuda.synchronize()
    row["mixer_share_max"] = max(shares)
    row["mixer_share_by_kind"] = {
        kind: max(s for s, k in zip(shares, kinds) if k == kind)
        for kind in sorted(set(kinds))}
    row["mixer_prefill_launches"] = {f.__name__: f.launches for f in counters
                                     if f.launches}
    print(f"[decode] {label}: {json.dumps(row)}", flush=True)
    if row["decode_launches"]:
        raise AssertionError(f"{label}: the decode launched "
                             f"{row['decode_launches']}")
    if not row["mixer_share_max"] <= mixer_tol:
        raise AssertionError(f"{label}: a mixer's decode differs from its "
                             f"prefill by {row['mixer_share_max']:.4e} of "
                             f"its largest output (limit {mixer_tol})")
    del X, Y
    return row


def zoo_prefill(arch, counters, n_layers=None):
    """Phase 15 (b): ``serve_prefill`` of one zoo arch at ZOO_PREFILL's
    size, every kernel's launch counter set to 0 just before and read
    just after; ``n_layers`` cuts the depth of the arch's config (the
    driver builds the full one). Returns (the result, its row)."""
    import torch
    from repro_torch.launch import serve_prefill as sp
    spec = ZOO_PREFILL[arch]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get = sp.get_config
    if n_layers is not None:
        def get(a):
            return full(a).replace(n_layers=n_layers)
    for f in counters:
        f.launches = 0
    with mock.patch.object(sp, "get_config", get):
        res = sp.serve_prefill(arch, shape=spec["shape"], batch=spec["batch"],
                               prompt_len=spec["prompt_len"],
                               device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches for f in counters if f.launches}
    cfg = res.cfg
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "shape": spec["shape"],
           "batch": spec["batch"], "positions": res.positions,
           "seconds": res.seconds, "tok_per_s": res.tok_per_s,
           "launches": launched,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[prefill] {cfg.name}: {json.dumps(row)}", flush=True)
    if tuple(res.logits.shape) != (spec["batch"], 1, cfg.padded_vocab) \
            or not torch.isfinite(res.logits).all():
        raise AssertionError(f"{cfg.name} prefill logits are wrong: "
                             f"{tuple(res.logits.shape)}")
    return res, row


def zoo_phase(gen, card, counters):
    """Phase 15: the moe, encdec and vlm families on the card (see the
    module docstring). Returns the row printed as ``{"zoo": ...}``, with
    what the kernels line needs of the D-256 route under "swa_d256"."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import effective_config, make_prefill_step
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_model
    from repro_torch.models.common import tree_map
    dev = torch.device("cuda", 0)
    row = {"card": card, "decode": {}, "prefill": {}}
    mcfg = get_config(ZOO_MOE["arch"]).replace(n_layers=ZOO_MOE["n_layers"])

    # (a) the decode CLI
    for name, extra in ZOO_DECODE.items():
        row["decode"][name] = decode_run(name, extra, counters)
    name = f"{mcfg.name} n_layers={mcfg.n_layers}"
    row["decode"][name] = decode_run(name, [], counters, cfg=mcfg)

    # (b) the prefills through serve_prefill
    pg, row["prefill"]["paligemma-3b"] = zoo_prefill("paligemma-3b",
                                                     counters)
    pcfg = pg.cfg
    if pcfg != effective_config(get_config("paligemma-3b"),
                                SHAPES["long_500k"]) \
            or (pcfg.attention, pcfg.window) != ("swa", 4096):
        raise AssertionError(f"not the full paligemma-3b SWA config: {pcfg}")
    n = pcfg.n_layers
    if row["prefill"]["paligemma-3b"]["launches"] != {
            "swa_attention": n, "swa_attention_wgmma": n}:
        raise AssertionError(f"paligemma: expected {n} launches of the wgmma "
                             f"SWA kernel and no other, saw "
                             f"{row['prefill']['paligemma-3b']['launches']}")
    errs = []
    t0 = time.perf_counter()
    with mock.patch.object(ops, "swa_attention", holding_kernel(errs)), \
            torch.inference_mode():
        held = make_prefill_step(pcfg, device=dev)(pg.params, pg.batch)
    torch.cuda.synchronize()
    print(f"[check] served paligemma forward, {len(errs)} kernel calls held "
          f"to the plain version: {time.perf_counter() - t0:.1f} s; max abs "
          f"err per layer {errs}", flush=True)
    if len(errs) != n or not torch.equal(held, pg.logits):
        raise AssertionError("the held paligemma forward does not reproduce "
                             "the served logits")
    del pg, held
    gc.collect()
    torch.cuda.empty_cache()
    B, S, H, KV, D, W = (2, ZOO_PREFILL["paligemma-3b"]["prompt_len"],
                         pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim,
                         pcfg.window)
    base = [torch.randn((B, S, n, D), generator=gen, device=dev).to(
        torch.bfloat16) for n in (H, KV, KV)]
    q, k, v = (t.transpose(1, 2) for t in base)
    d256_row = check_swa(f"paligemma prefill S={S} window={W} H={H} "
                         f"KV={KV} D={D} bf16 (B,S,H,D) views", q, k, v, W,
                         time_it=True)
    if d256_row["kernel"] != "wgmma":
        raise AssertionError("paligemma's SWA shape is not routed to the "
                             "wgmma kernel")
    del q, k, v, base
    row["swa_d256"] = {"launches": n, "held_max_abs_err": max(errs),
                       "shape": d256_row}

    sm, row["prefill"]["seamless-m4t-large-v2"] = zoo_prefill(
        "seamless-m4t-large-v2", counters)
    scfg = sm.cfg
    if scfg != get_config("seamless-m4t-large-v2"):
        raise AssertionError(f"not the full seamless config: {scfg}")
    s_params = sm.params
    del sm
    ds, row["prefill"]["deepseek-v2-236b"] = zoo_prefill(
        ZOO_MOE["arch"], counters, n_layers=ZOO_MOE["n_layers"])
    d_params = ds.params
    if ds.cfg != mcfg:
        raise AssertionError(f"not deepseek-v2-236b's config at "
                             f"{mcfg.n_layers} layers: {ds.cfg}")
    del ds
    for arch in ("seamless-m4t-large-v2", "deepseek-v2-236b"):
        if row["prefill"][arch]["launches"]:
            raise AssertionError(f"{arch} prefill launched "
                                 f"{row['prefill'][arch]['launches']}")

    # two MoE calls on one input give the same bits (no atomics)
    lp = tree_map(lambda t: t[0], d_params["moe_layers"]["ffn"])
    x = torch.randn((2, ZOO_PREFILL["deepseek-v2-236b"]["prompt_len"],
                     mcfg.d_model), generator=gen, device=dev).to(mcfg.cdtype)
    with torch.inference_mode():
        y0, a0 = moe_model.moe_ffn(lp, x, mcfg)
        y1, a1 = moe_model.moe_ffn(lp, x, mcfg)
        torch.cuda.synchronize()
        row["moe_ffn_ms"] = time_ms(lambda: moe_model.moe_ffn(lp, x, mcfg),
                                    3)
    row["moe_bit_repeatable"] = bool(torch.equal(y0, y1)
                                     and torch.equal(a0, a1))
    row["moe_tokens"] = x.shape[0] * x.shape[1]
    del x, y0, y1, lp
    if not row["moe_bit_repeatable"]:
        raise AssertionError("two MoE calls on one input differ")

    # (c) decode against prefill
    L = ZOO_RECUR["prompt_len"]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, mcfg.vocab_size, (ZOO_RECUR["batch"], L), dtype=np.int32)).to(dev)
    row["mla"] = decode_vs_prefill(f"(c) MLA {mcfg.name} n_layers="
                                   f"{mcfg.n_layers}", mcfg, d_params, tokens,
                                   0, L - 1, counters, DECODE_LOGIT_TOL)
    # the float32 copy: its capacity factor keeps every assignment of the
    # prefill's 512 tokens (the decode's 2 a step never overflow; the
    # prefill's drops past capacity are the reference's by design)
    fcfg = mcfg.replace(n_layers=ZOO_MOE["fp32_layers"],
                        param_dtype="float32", compute_dtype="float32",
                        capacity_factor=mcfg.n_experts / mcfg.top_k)
    cut = dict(d_params, moe_layers=tree_map(
        lambda t: t[:fcfg.n_layers - fcfg.n_dense_layers],
        d_params["moe_layers"]))
    del d_params
    gc.collect()
    f_params = tree_map(lambda t: t.float(), cut)
    del cut
    gc.collect()
    torch.cuda.empty_cache()
    row["mla_float32"] = decode_vs_prefill(
        f"(c) MLA {fcfg.name} n_layers={fcfg.n_layers} float32 copy", fcfg,
        f_params, tokens, 0, L - 1, counters, FP32_LOGITS_TOL)
    del f_params
    gc.collect()
    torch.cuda.empty_cache()
    frames = torch.from_numpy(rng.standard_normal(
        (ZOO_RECUR["batch"], L, scfg.d_model), dtype=np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(
        0, scfg.vocab_size, (ZOO_RECUR["batch"], L), dtype=np.int32)).to(dev)
    with torch.inference_mode():
        enc = lm.encode(s_params, frames, scfg)
    row["cross"] = decode_vs_prefill(
        f"(c) self- and cross-attention {scfg.name}", scfg, s_params,
        tokens, 0, L - 1, counters, DECODE_LOGIT_TOL, enc_out=enc)
    del s_params, enc, frames, tokens
    gc.collect()
    torch.cuda.empty_cache()
    for part in ("mla", "mla_float32", "cross"):
        if row[part]["prefill_launches"] or \
                row[part]["mixer_prefill_launches"]:
            raise AssertionError(f"{part}: a prefill launched a kernel")
    f32 = row["mla_float32"]
    if not f32["logit_share"] <= DECODE_LOGIT_TOL \
            or f32["argmax_clear_agree"] != f32["argmax_clear"]:
        raise AssertionError(
            f"{f32['label']}: logits {f32['logit_share']:.4e} of the largest "
            f"(limit {DECODE_LOGIT_TOL}), argmax equal at "
            f"{f32['argmax_clear_agree']} of {f32['argmax_clear']} clear "
            f"positions")
    print(json.dumps({"zoo": row}), flush=True)
    return row


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
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import effective_config, make_prefill_step
    from repro_torch.launch.serve_pipeline import gcn_plain, serve
    from repro_torch.models import init_params, model_decls
    from repro_torch.models import ssm as ssm_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import TorchPipelineBackend
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
    edges = [(s_, w_, d_, g_, 2, dtype)
             for dtype in (torch.float32, torch.bfloat16)
             for s_, w_ in ((256, 128), (384, 128), (512, 256), (256, 256),
                            (128, 128))
             for d_ in (64, 128) for g_ in (1, 4, 8)]
    edges += [(512, 256, 256, 8, 2, dtype)
              for dtype in (torch.float32, torch.bfloat16)]
    # D 256 in bf16, the wgmma kernel's 64-key tiles: G 8 with KV 1 is
    # paligemma-3b's (and gemma-2b's) MQA
    edges += [(s_, w_, 256, g_, kv_, torch.bfloat16)
              for s_, w_ in ((128, 128), (256, 128), (384, 128), (512, 256),
                             (1024, 128), (1024, 512))
              for g_, kv_ in ((1, 2), (4, 2), (8, 1))]
    for s_, w_, d_, g_, kv_, dtype in edges:
        q = torch.randn((2, g_ * kv_, s_, d_), generator=gen, device=dev,
                        dtype=dtype)
        k, v = (torch.randn((2, kv_, s_, d_), generator=gen, device=dev,
                            dtype=dtype) for _ in range(2))
        swa_rows.append(check_swa(
            f"S={s_} window={w_} D={d_} G={g_} KV={kv_} {dtype}", q, k, v,
            w_))
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
        fp32_fma_launches = swa_attention_fma.launches - n0
        if fp32_fma_launches != cfg.n_layers:
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
    del mam, held, kern, plain, step32
    torch.cuda.empty_cache()

    # 11) DyPe streaming serving on the torch backend
    phase("11. main path: DyPe streaming serving, Router -> Engine -> DP -> "
          "TorchPipelineBackend, 120 s of traffic")
    prepared, futures = {}, []
    real_prepare = TorchPipelineBackend.prepare
    real_submit = TorchPipelineBackend.submit

    def recording_prepare(self, schedule, workload, *, epoch=0):
        h = real_prepare(self, schedule, workload, epoch=epoch)
        prepared.setdefault(id(h.payload), (self, h.payload, schedule,
                                            workload))
        return h

    def recording_submit(self, handle, batch, t0):
        fut = real_submit(self, handle, batch, t0)
        futures.append(fut)
        return fut

    torch_argv = STREAM_ARGV + ["--backend", "torch"]
    counters = (spmm_blocked_ell, swa_attention, swa_attention_wgmma,
                swa_attention_fma, ssd_chunked, ssd_chunked_tc,
                ssd_chunked_fma) + ssd_stages
    with mock.patch.object(TorchPipelineBackend, "prepare",
                           recording_prepare), \
            mock.patch.object(TorchPipelineBackend, "submit",
                              recording_submit):
        spmm_csr_rows.launches = 0
        for f in counters:
            f.launches = 0
        router, snap, wall, summary = stream(torch_argv)
        torch.cuda.synchronize()
        stream_launches = spmm_csr_rows.launches
        others = {f.__name__: f.launches for f in counters if f.launches}
    print("\n".join(summary), flush=True)
    reports = [f.result() for f in futures]
    batch_ms = sorted(sum(r.measured_stage_times) * 1e3 for r in reports)
    backend = router.engine.backend
    cal = router.calibrator
    scales = [st[1] for st in cal._state.values()
              if st[0] >= cal.skip + cal.warmup]
    sim_s = STREAM_ARGV[STREAM_ARGV.index("--duration") + 1]
    stream_row = {
        "wall_s": wall, "simulated_s": float(sim_s),
        "completed": snap.completed, "dropped": snap.dropped,
        "sim_req_per_s": snap.throughput, "batches": len(router.dispatches),
        "reports": len(reports),
        "device_ms_per_batch_mean": sum(batch_ms) / len(batch_ms),
        "device_ms_per_batch_p50": batch_ms[(len(batch_ms) - 1) // 2],
        "device_ms_total": sum(batch_ms),
        "spmm_csr_rows_launches": stream_launches,
        "payloads": len(prepared), "calibrated_cells": len(scales),
        "calibrated_cell_stages": sum(len(sc) for sc in scales),
        "schedules": sorted({d.mnemonic for d in router.dispatches}),
        "reschedules": snap.reschedules}
    print(f"[stream] {stream_row['simulated_s']:.0f} s of traffic in "
          f"{wall:.3f} s wall; {snap.completed} completed, {snap.dropped} "
          f"dropped, {snap.throughput:.3f} simulated req/s; "
          f"{stream_row['batches']} batches; device ms a batch (events) mean "
          f"{stream_row['device_ms_per_batch_mean']:.4f}, p50 "
          f"{stream_row['device_ms_per_batch_p50']:.4f}; spmm_csr_rows "
          f"launches {stream_launches}; other kernels {others or 'none'}; "
          f"{stream_row['calibrated_cell_stages']} (cell, stage) scales "
          f"locked in {len(scales)} cells", flush=True)
    if backend.name != "torch" or backend.device.type != "cuda":
        raise AssertionError(f"the stream ran on {backend.name} "
                             f"{getattr(backend, 'device', None)}")
    if stream_launches <= 0 or others:
        raise AssertionError(f"expected spmm_csr_rows launches and no "
                             f"other kernel's in the stream, saw "
                             f"{stream_launches} and {others}")
    if len(reports) != len(router.dispatches) or not all(
            len(r.measured_stage_times) and all(t > 0 for t in
                                                r.measured_stage_times)
            for r in reports):
        raise AssertionError("a batch of the stream has no event timing")
    if not scales:
        raise AssertionError("the calibrator locked no (cell, stage) scale "
                             "from the event-timed reports")
    # the same stream on the analytic backend
    a_router, a_snap, a_wall, a_summary = stream(
        STREAM_ARGV + ["--backend", "analytic"])
    print("\n".join(a_summary), flush=True)
    same = {
        "completed": (snap.completed, a_snap.completed),
        "dropped": (snap.dropped, a_snap.dropped),
        "reschedules": (snap.reschedules, a_snap.reschedules),
        "latencies": (sorted(router.metrics.latencies),
                      sorted(a_router.metrics.latencies)),
        "schedules": (stream_row["schedules"],
                      sorted({d.mnemonic for d in a_router.dispatches}))}
    differ = [k for k, (a, b) in same.items() if a != b]
    print(f"[check] torch vs analytic stream: {', '.join(same)} "
          f"{'differ in ' + str(differ) if differ else 'equal'}", flush=True)
    if differ:
        print("\n".join(l for l in router.log if "straggler" in l))
        raise AssertionError(f"the torch stream differs from the analytic "
                             f"one in {differ}")
    if snap.completed < 500 or snap.reschedules.get("resize", 0) < 2:
        raise AssertionError(f"not the documented stream: {snap}")
    # every spmm product of every prepared payload, at each microbatch
    # count the stream used, held to the plain version; each card payload
    # held to the same payload built on the CPU
    micro_counts = sorted({max(1, min(d.n, backend.max_micro))
                           for d in router.dispatches})
    shapes, payload_errs = [], []
    with mock.patch.object(ops, "spmm_csr_rows",
                           holding_spmm(shapes, backend.act_batch)), \
            torch.inference_mode():
        for be, payload, schedule, workload in prepared.values():
            for m in micro_counts:
                payload(be._micro(m))
            cpu_be = TorchPipelineBackend(
                act_batch=be.act_batch, act_dim=be.act_dim,
                max_micro=be.max_micro, device="cpu")
            want = cpu_be.prepare(schedule, workload).payload(
                cpu_be._micro(be.max_micro))
            got = payload(be._micro(be.max_micro)).cpu()
            torch.testing.assert_close(got, want, atol=PAYLOAD_TOL,
                                       rtol=PAYLOAD_TOL)
            payload_errs.append(float((got - want).abs().max()))
    torch.cuda.synchronize()
    print(f"[check] {len(shapes)} spmm products of {len(prepared)} payloads "
          f"at microbatch counts {micro_counts} (x shapes "
          f"{sorted(set(shapes))}) equal the plain version and 0.5 * roll "
          f"bit for bit; card vs CPU payload max abs err "
          f"{max(payload_errs):.3e} (limit {PAYLOAD_TOL})", flush=True)
    if not shapes:
        raise AssertionError("no prepared payload has an spmm stage")
    # the card's busy share, from a second run of the stream profiled
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p_router, p_snap, _, _ = stream(torch_argv)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy_s = union_us(spans) / 1e6
    stream_row.update({"profiled_wall_s": p_wall, "device_busy_s": busy_s,
                       "busy_share": busy_s / p_wall,
                       "profiled_kernels": len(spans),
                       "profiled_completed": p_snap.completed})
    print(f"[stream] profiled run: {p_wall:.3f} s wall, card busy "
          f"{busy_s * 1e3:.3f} ms over {len(spans)} kernels and copies "
          f"(busy share {busy_s / p_wall:.6f}, profiler on); "
          f"{p_snap.completed} completed", flush=True)
    if not spans:
        raise AssertionError("the profiler saw no device time in the stream")
    print(json.dumps({"stream": stream_row}), flush=True)

    # 12) the multi-host control plane with torch workers on the card
    phase("12. main path: DyPe's cluster control plane, serve --stream "
          "--cluster 2, every worker a TorchPipelineBackend on the card")
    cluster_row = {"single_host_device_ms_per_batch_mean":
                   stream_row["device_ms_per_batch_mean"],
                   "single_host_device_ms_per_batch_p50":
                   stream_row["device_ms_per_batch_p50"],
                   "single_host_host_ms_per_batch":
                   stream_row["wall_s"] * 1e3 / stream_row["batches"],
                   "scenarios": {}}
    cluster_launches = 0
    for name, extra in CLUSTER_SCENARIOS.items():
        row, launched = cluster_scenario(name, extra, counters)
        cluster_row["scenarios"][name] = row
        cluster_launches += launched
    cluster_row["remote_worker"] = remote_torch_worker()
    print(json.dumps({"cluster": cluster_row}), flush=True)

    # 13) multi-tenant serving and observability on the card
    phase("13. main path: multi-tenant serving and observability, serve "
          "--stream --tenants / --trace-out / --dashboard* on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    tenancy_row = {"card": card}
    tenancy_row["tenant_stream"], tenancy_launches = tenant_stream(counters)
    tenancy_row["azure"] = azure_tenancy(counters)
    tenancy_row["quickstart"], obs_launches, last_frame = \
        obs_quickstart(counters)
    tenancy_row["dashboard_server"] = dashboard_server(last_frame)
    tenancy_row["spmm_csr_rows_launches"] = {
        "tenant_stream": tenancy_launches,
        "azure": tenancy_row["azure"]["launches"]["spmm_csr_rows"],
        "quickstart": obs_launches}
    print(json.dumps({"tenancy": tenancy_row}), flush=True)
    del last_frame
    gc.collect()
    torch.cuda.empty_cache()

    # 14) the decode mode, and the decode held to the B2 and B3 prefills
    phase("14. main path: the decode mode of serve (KV and SSM caches, the "
          "SWA ring buffer, --int8), and the zamba2 prefill on B3")
    kernels14 = counters + (spmm_csr_rows,)
    decode_row = {"card": card, "runs": {}}
    for name, extra in DECODE_RUNS.items():
        decode_row["runs"][name] = decode_run(name, extra, kernels14)
        gc.collect()
        torch.cuda.empty_cache()

    # (b) the SWA ring buffer against B2
    rcfg = effective_config(get_config(RING["arch"]), SHAPES["long_500k"]
                            ).replace(n_layers=RING["n_layers"])
    if (rcfg.attention, rcfg.window, rcfg.n_layers, rcfg.d_model) != \
            ("swa", 4096, RING["n_layers"], 2560):
        raise AssertionError(f"not the qwen3-4b SWA config: {rcfg}")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_decls(rcfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         rcfg.pdtype)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (1, RING["prompt_len"]), dtype=np.int32)).to(dev)
    ring = decode_vs_prefill(f"(b) ring {rcfg.name} window {rcfg.window}",
                             rcfg, params, tokens, RING["first"],
                             RING["last"], kernels14, DECODE_LOGIT_TOL)
    ring["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    swa_n = {"swa_attention": rcfg.n_layers,
             "swa_attention_wgmma": rcfg.n_layers}
    if ring["prefill_launches"] != swa_n \
            or ring["mixer_prefill_launches"] != swa_n:
        raise AssertionError(f"(b): expected {rcfg.n_layers} wgmma SWA "
                             f"launches in each "
                             f"prefill, saw {ring['prefill_launches']} and "
                             f"{ring['mixer_prefill_launches']}")
    decode_row["ring"] = ring
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the recurrence against B3
    mcfg = get_config("mamba2-780m")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_decls(mcfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         mcfg.pdtype)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, mcfg.vocab_size, (RECUR["batch"], RECUR["prompt_len"]),
        dtype=np.int32)).to(dev)
    last = RECUR["prompt_len"] - 1
    recur = decode_vs_prefill(f"(c) recurrence {mcfg.name}", mcfg, params,
                              tokens, 0, last, kernels14, DECODE_LOGIT_TOL)
    recur["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    def tc_route(n):
        return {"ssd_chunked": n, "ssd_chunked_tc": n, "ssd_chunk_state": n,
                "ssd_state_scan": n, "ssd_chunk_out": n}

    def fma_route(n):
        return {"ssd_chunked": n, "ssd_chunked_fma": n}

    def float32_copy(cfg, params):
        return (cfg.replace(param_dtype="float32", compute_dtype="float32"),
                tree_map(lambda t: t.float(), params))

    if recur["prefill_launches"] != tc_route(48) \
            or recur["mixer_prefill_launches"] != tc_route(48):
        raise AssertionError(f"(c): expected 48 SSD calls on the tc route "
                             f"in each prefill, saw "
                             f"{recur['prefill_launches']} and "
                             f"{recur['mixer_prefill_launches']}")
    decode_row["recurrence"] = recur
    recur32 = decode_vs_prefill(
        f"(c) recurrence {mcfg.name} float32 copy", *float32_copy(
            mcfg, params), tokens, 0, last, kernels14, FP32_LOGITS_TOL)
    if recur32["prefill_launches"] != fma_route(48):
        raise AssertionError(f"(c) float32: expected 48 SSD calls on the "
                             f"FMA kernel, saw {recur32['prefill_launches']}")
    decode_row["recurrence_float32"] = recur32
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the hybrid prefill on B3, at full width and depth
    for f in kernels14:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    hy = serve_prefill(HYBRID_PREFILL["arch"], shape=HYBRID_PREFILL["shape"],
                       batch=HYBRID_PREFILL["batch"],
                       prompt_len=HYBRID_PREFILL["prompt_len"], device=dev)
    torch.cuda.synchronize()
    hy_launches = {f.__name__: f.launches for f in kernels14 if f.launches}
    hcfg = hy.cfg
    hybrid_row = {"tokens": hy.tokens.numel(), "seconds": hy.seconds,
                  "tok_per_s": hy.tok_per_s, "launches": hy_launches,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[prefill] {hcfg.name}: {json.dumps(hybrid_row)}", flush=True)
    if (hcfg.family, hcfg.n_layers, hcfg.d_model, hcfg.ssm_state,
            hcfg.ssm_heads, hcfg.ssm_head_dim, hcfg.ssm_chunk,
            hcfg.head_dim) != ("hybrid", 81, 3584, 64, 112, 64, 256, 112):
        raise AssertionError(f"not the full zamba2-7b config: {hcfg}")
    if hy_launches != tc_route(54):
        raise AssertionError(f"(d): expected 54 SSD calls, all on the tc "
                             f"route, and no other kernel, saw {hy_launches}")
    if tuple(hy.logits.shape) != (HYBRID_PREFILL["batch"], 1, 32000) \
            or not torch.isfinite(hy.logits).all():
        raise AssertionError(f"zamba2 prefill logits are wrong: "
                             f"{tuple(hy.logits.shape)}")
    t0 = time.perf_counter()
    hy_errs = []
    with mock.patch.object(ssm_model, "ssd_chunked",
                           holding_ssd(hy_errs)), torch.inference_mode():
        held = make_prefill_step(hcfg, device=dev)(hy.params,
                                                   {"tokens": hy.tokens})
    torch.cuda.synchronize()
    print(f"[check] served zamba2 forward, {len(hy_errs)} kernel calls held "
          f"to the plain version: {time.perf_counter() - t0:.1f} s; max abs "
          f"err per layer {hy_errs}", flush=True)
    if len(hy_errs) != 54 or not torch.equal(held, hy.logits):
        raise AssertionError("the held zamba2 forward does not reproduce the "
                             "served logits")
    hybrid_row["held_max_abs_err"] = max(hy_errs)
    del held
    args = ssd_inputs(gen, dev, HYBRID_PREFILL["batch"],
                      HYBRID_PREFILL["prompt_len"], hcfg.ssm_heads,
                      hcfg.ssm_head_dim, hcfg.ssm_state, torch.bfloat16)
    zamba_ssd = check_ssd(f"zamba2 prefill L={HYBRID_PREFILL['prompt_len']} "
                          f"H={hcfg.ssm_heads} N={hcfg.ssm_state} chunk "
                          f"{hcfg.ssm_chunk} bf16 strided views", args,
                          hcfg.ssm_chunk, time_it=True)
    if zamba_ssd["kernel"] != "tc":
        raise AssertionError("zamba2's SSD shape is not routed to the "
                             "tensor-core kernels")
    del args
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, hcfg.vocab_size, (RECUR["batch"], RECUR["prompt_len"]),
        dtype=np.int32)).to(dev)
    hyd = decode_vs_prefill(f"(d) hybrid {hcfg.name}", hcfg, hy.params,
                            tokens, 0, last, kernels14, DECODE_LOGIT_TOL)
    if hyd["prefill_launches"] != tc_route(54) \
            or hyd["mixer_prefill_launches"] != tc_route(54):
        raise AssertionError(f"(d): expected 54 SSD calls on the tc route "
                             f"in each prefill, saw {hyd['prefill_launches']}"
                             f" and {hyd['mixer_prefill_launches']}")
    hybrid_row["decode_vs_prefill"] = hyd
    short = HYBRID_FP32_LEN - 1
    hyd32 = decode_vs_prefill(
        f"(d) hybrid {hcfg.name} float32 copy", *float32_copy(
            hcfg, hy.params), tokens[:, :short + 1], 0, short, kernels14,
        FP32_LOGITS_TOL)
    if hyd32["prefill_launches"] != fma_route(54):
        raise AssertionError(f"(d) float32: expected 54 SSD calls on the "
                             f"FMA kernel, saw {hyd32['prefill_launches']}")
    hybrid_row["decode_vs_prefill_float32"] = hyd32
    decode_row["hybrid"] = hybrid_row
    del hy, tokens
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"decode": decode_row}), flush=True)
    # end to end: in bf16 the rounding differences between the prefill's
    # and the decode's products grow with depth (the ring's logits differ
    # by 2.06% of the largest at 36 layers, 1.1% at 4, mamba2's by 22%,
    # zamba2's by 17%, where no
    # mixer differs by 1% of its output), so the logits are held to
    # DECODE_LOGIT_TOL on the float32 copies (mamba2's differ by 1.8e-4),
    # and in bf16 only the ring's argmax, where the top two are clear
    for part, bounded in ((recur32, True), (hyd32, True), (ring, False)):
        if bounded and not part["logit_share"] <= DECODE_LOGIT_TOL:
            raise AssertionError(
                f"{part['label']}: the decode's logits differ from the "
                f"prefill's by {part['logit_share']:.4e} of the largest "
                f"(limit {DECODE_LOGIT_TOL})")
        if part["argmax_clear_agree"] != part["argmax_clear"]:
            raise AssertionError(
                f"{part['label']}: argmax equal at "
                f"{part['argmax_clear_agree']} of {part['argmax_clear']} "
                f"clear positions")

    # 15) the rest of the zoo
    phase("15. main path: the rest of the LM zoo (MLA + MoE of deepseek-v2, "
          "the encoder-decoder of seamless-m4t, the vlm prefix of "
          "paligemma) in decode and prefill")
    zoo = zoo_phase(gen, card, kernels14)
    pg = zoo["swa_d256"]["shape"]

    kernels = [{
        "name": "spmm_csr_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_csr_rows.cu",
        "replaces": "src/repro/kernels/spmm.py:72", "launches": launches,
        "stream_launches": stream_launches,
        "cluster_launches": cluster_launches,
        "tenancy_launches": tenancy_launches + obs_launches,
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
        # D 128 at qwen3-4b's shape; "d256_shape": paligemma-3b's
        "name": "swa_attention_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention_wgmma.cu",
        "replaces": "src/repro/kernels/swa.py:81",
        "launches": wgmma_launches,
        "max_abs_err": max([r["max_abs_err"] for r in swa_rows
                            if r["kernel"] == "wgmma"] + errs
                           + [pg["max_abs_err"],
                              zoo["swa_d256"]["held_max_abs_err"]]),
        "ms": main_swa["ms"], "plain_ms": main_swa["plain_ms"],
        "bound_ms": main_swa["bound_ms"], "bound_by": main_swa["bound_by"],
        "library_ms": main_swa["library_ms"],
        "ring_prefill_launches": ring["prefill_launches"][
            "swa_attention_wgmma"],
        "d256_shape": {
            "q": pg["q"], "kv": pg["kv"], "window": pg["window"],
            "launches": zoo["swa_d256"]["launches"], "ms": pg["ms"],
            "plain_ms": pg["plain_ms"], "bound_ms": pg["bound_ms"],
            "bound_by": pg["bound_by"],
            "share_of_bound": pg["share_of_bound"],
            "library_ms": pg["library_ms"], "fma_ms": pg["fma_ms"]}}, {
        # its path: phase 7's float32 copy; timed as the comparison on the
        # bf16 inputs at paligemma-3b's and qwen3's shapes (the wgmma
        # kernel's)
        "name": "swa_attention_fma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa.py:81",
        "launches": fp32_fma_launches,
        "qwen3_prefill_launches": fma_launches,
        "max_abs_err": max([r["max_abs_err"] for r in swa_rows
                            if r["kernel"] == "fma"]
                           + [main_swa["fma_max_abs_err"],
                              pg["fma_max_abs_err"]]),
        "ms": pg["fma_ms"], "plain_ms": pg["plain_ms"],
        "bound_ms": pg["bound_ms"], "bound_by": pg["bound_by"],
        "library_ms": pg["library_ms"], "library": pg["library"],
        "shape": {"q": pg["q"], "kv": pg["kv"], "window": pg["window"]},
        "qwen3_shape": {"ms": main_swa["fma_ms"],
                        "plain_ms": main_swa["plain_ms"],
                        "bound_ms": main_swa["bound_ms"],
                        "library_ms": main_swa["library_ms"]}}, {
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
        "library_ms": None,
        "hybrid_calls": hy_launches["ssd_chunked_tc"],
        "hybrid_kernel_launches": {k: hy_launches[k] for k in
                                   stage_launches},
        "hybrid_max_abs_err": max(hy_errs + [zamba_ssd["max_abs_err"]]),
        "zamba2_shape": {k: zamba_ssd[k] for k in
                         ("x", "N", "chunk", "ms", "stage_ms", "plain_ms",
                          "bound_ms", "bound_by", "fma_ms")}}, {
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
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
