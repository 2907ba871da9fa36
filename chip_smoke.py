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

16. drive the training path (``launch/train.py``'s loop: ``lm_loss``, the
   train step, AdamW) with B2 forward and its backward kernels, three
   launches each (row statistics, dk/dv, dq), in the route that
   ``swa._bwd_route`` names: ``csrc/swa_attention_bwd_wgmma.cu`` (bf16 at
   D 64/128, on ``wgmma``) or ``csrc/swa_attention_bwd.cu`` (float32, and
   bf16 at D 256, on FMA): (a) before any model is resident, the routed
   backward against ``swa_attention_bwd_plain`` at edge shapes (float32
   and bf16; S 256 to 1024; window 128, 256 and S - 128; D 64/128/256; G
   1/4/8), at 1 x 8,192 in float32 and at the path's shape (q (2, 32,
   16384, 128), k/v (2, 8, 16384, 128), window 4096, bf16, read in place
   from (B, S, H, D) views): float32 gradients within 1e-4 of their
   largest, bf16 at one ulp, the row statistics within 1e-5, two calls
   the same bits; at the path's shape the wgmma route's launches and the
   whole call, the FMA backward on the same input (held too), the plain
   version and SDPA's backward with the band as a mask are timed beside
   the bounds, and both kernels' registers, spills and shared memory are
   recorded; (b) a float32 copy of qwen3-4b-swa4096 at full width, 2
   layers, 1 x 8,192 tokens, remat on: ``lm_loss`` and every gradient
   through the kernels (the FMA forward, twice a layer, and the FMA
   backward) against the same model through the plain versions (the loss
   within 1e-5 relative, each gradient within 1e-4 of its leaf's
   largest); (b') the same copy in bf16 through the kernel route (the
   wgmma forward and backward) against the plain route, each gradient
   within 2e-2 of its leaf's largest; (c) qwen3-4b-swa4096 at full width
   and depth (36 layers, bf16 parameters, float32 AdamW state), 2 x
   16,384 tokens, 3 steps, launch counters set to 0 just before and read
   just after (a step: 72 launches of the wgmma kernel, 36 of each wgmma
   backward launch, 0 of the FMA kernels, forward or backward; loss and
   grad norm finite), printing ms a step, tok/s and peak memory; (d)
   ``examples/train_e2e_torch.py --preset small``, whose restart replays
   the first run's losses bit for bit (``restart replay exact``).

17. drive the training path of the ssm family: mamba2-780m through
   ``launch/train.py``'s loop with B3's forward (the tensor-core route in
   bf16, the FMA kernel in float32) and its backward behind
   ``ssd._SsdChunked``, the route that ``ssd._bwd_route`` names: in bf16
   ``csrc/ssd_chunk_bwd_tc.cu`` on bf16 tensor cores (``wgmma``, TMA
   stages), four launches (the scan with each state split over blocks;
   dGs, the gradient of C B^T summed over heads once per chunk; dB and dC;
   the head blocks' dx, d dts and d da) after bK1 of
   ``csrc/ssd_chunk_bwd.cu``; in float32 that file's three launches on
   FMA (bK1 each chunk's own state gradient, bK2 the reverse scan over
   chunks, bK3 the per-chunk gradients): (a) before any model is
   resident, the routed backward against ``ssd_chunked_bwd_plain`` and
   each launch against its plain stage, in bf16 the FMA route on the same
   input too, on strided x/B/C views as ``mamba_block`` passes them, from
   the routed forward's own la and entering states, at edge shapes
   (float32 and bf16; L = Q and 4Q; Q 64 and 256; N 64 and 128; H 1 and
   3; with and without init_state; a zero and a non-zero final-state
   gradient), at the path's shape (b 16, L 4,096, H 48, P 64, N 128, chunk
   256, bf16) and at zamba2-7b's (b 1, L 8,192, H 112, N 64): float32
   outputs within 1e-4 of their largest, bf16 outputs at one ulp of the
   plain float32 backward rounded once, two calls the same bits; at the
   two large shapes each launch, the call, the FMA route's call and
   launches on the same input, the plain backward and each plain stage
   are timed beside the bounds (no PyTorch call computes the scan's
   gradient, so there is no library yardstick), and both kernels'
   registers, spills and shared memory are recorded; (b) a float32 copy
   of mamba2-780m at full width, 2 layers, 1 x 8,192 tokens, remat on:
   ``lm_loss`` and every gradient through the kernels (the FMA forward,
   twice a layer, and the FMA backward) against the plain versions (the
   loss within 1e-5 relative, each gradient within 1e-4 of its leaf's
   largest); (b') the same copy in bf16 (the tensor-core forward and
   backward) and zamba2-7b at full width, 3 layers (one a-m-m group), 1 x
   8,192, each gradient within 2e-2 of its leaf's largest; (c) mamba2-780m
   at full width and depth (48 layers, bf16 parameters, float32 AdamW
   state), 16 x 4,096 tokens, 3 steps, launch counters set to 0 just
   before and read just after (a step: 96 forward calls on the
   tensor-core route, 48 of bK1 and of each tensor-core backward launch,
   0 of the FMA kernels past bK1; loss and grad norm finite), printing ms
   a step, tok/s and peak memory.

18. drive DyPe on an H100 node: (a) the card's figures beside
   ``core/device.py``'s H100 entries: ``memory.total``, the idle draw and
   the draw under about 2 s of B1 at ogbn-arxiv, of cuBLAS float32 (8192
   cubed, TF32 off) and of B2's float32 route (SWA-T's 16,384 x 1,024),
   each the median of nvidia-smi's ``power.draw`` sampled every 100 ms,
   the on-card copy rate and the pinned host-to-card and card-to-host
   rates, and the draw under a pinned copy loop (no gate on power); (b)
   ``hw_oracle``'s ``"H100"`` role against the card at DyPe's own kernel
   specs: ``SpMM1`` on B1 and ``GeMM1`` on cuBLAS of ``gcn_workload`` for
   the six Table-I datasets at full size (each graph drawn on the card by
   torch's generator with ``data.table1_graph``'s law, whose numpy build
   takes over a minute at S1), ``WinAttn1`` of ``swa_transformer_workload``
   (4096, 512) and (16384, 1024) on B2's float32 route, (1, 8, S, 64);
   each timed with CUDA events (mean of 10 after one) beside
   ``hw_oracle.measure`` and the fitted ``PerfModel``; the oracle within
   2x of the card at every spec, 66 B1 and 22 FMA launches; (c)
   ``serve_pipeline.serve("OA", 8, system=h100_system())``, launch
   counters set to 0 just before and read just after (16 B1 launches, 0
   blocked-ELL; within 1e-3 of the plain GCN), the DP's predicted stage
   times beside the card's CUDA-event times of each stage's kernels for
   one request; (d) the same GCN through the mesh executor on an explicit
   4-slot mesh whose every slot is ``cuda:0`` (the one card stands in for
   four: same-card copies, no NVLink), equal to (c)'s output bit for bit
   with 16 B1 launches; then ``TorchPipelineBackend(mode="mesh")`` on
   that mesh with the DP's OA schedule on the paper's system: the
   runner's group sizes the DP's ``Stage.n``, ``finishes`` equal to the
   analytic backend's, 6 B1 launches for 3 requests, the output within
   1e-5 of the one-card chain's. It prints a ``{"h100_system": ...}``
   line.

19. drive the training path of the LM zoo on a (data, model) mesh
   (``launch/dist.py``: one process a slot, NCCL) on the one card: (a) a
   world of one process on a (1, 1) mesh runs ``lm_loss`` and its
   backward through the mesh code path (each layer's leaves gathered
   inside its checkpoint, the loss and count summed over data, the specs
   of the reference) on qwen3-8b's 2-layer float32 copy at full width,
   2 x 1,024 tokens: the loss and every gradient equal the one-card
   path's bit for bit (at size 1 every gather and sum is an identity and
   the vocab-parallel loss is off); (b) from the specs alone, on the meta
   device, the bytes of parameters, gradients and AdamW state a card
   holds for every arch of ``configs.ARCHS`` at full size on the
   production meshes (16, 16) and (2, 16, 16), each marked whether its
   parameters and state fit 80 GB. It prints a ``{"lm_mesh": ...}`` line.

20. hold the dry run (``launch/dryrun.py``) against the card, on the host
   alone: the dry run's evaluation of one rank on a (1, 1) mesh, on meta
   tensors with its fake process group, of phase 16 (c)'s step
   (qwen3-4b-swa4096, 2 x 16,384) and phase 17 (c)'s (mamba2-780m, 16 x
   4,096): the predicted peak a card beside ``max_memory_allocated`` of
   those phases (within ``DRYRUN_PEAK_SHARE``), and the kernel calls its
   tally counts a step (the kernels' wrappers on meta tensors, with no
   launch) equal to the launches those
   phases counted a step (B2: 72 forward calls, 36 of each backward
   launch; B3: 96 tensor-core forward calls, 48 of bK1 and of each
   tensor-core backward launch); and the dry run's decode step of phase
   14 (a)'s gemma-2b (8 sequences against 256-slot caches, one token, on
   a (1, 1) mesh through ``make_serve_step(mesh=)``): its predicted peak
   beside the peak over phase 14 (a)'s decode loop, within the same share,
   and no kernel call. It prints a ``{"dryrun": ...}`` line with the
   card's name and power limit.

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

# phase 16: the training path. (a) the B2 backward kernel against its plain
# version: edge shapes (S 256-1024; window 128, 256 and S - 128; D
# 64/128/256; G 1/4/8) in float32 and bf16, then the path's shape; gates:
# float32 each of dq, dk, dv within 1e-4 of its largest plain element (sum
# order over up to 8 x 4,096 rows), bf16 one ulp of the plain float32
# backward rounded once (SWA_TOL); the row statistics (lse, delta) within
# 1e-5 of their largest; two calls the same bits
BWD_F32_SHARE = 1e-4
STATS_SHARE = 1e-5
BWD_EDGES = [(s_, w_, d_, g_, kv_)
             for s_, w_ in ((256, 128), (512, 256), (1024, 128), (1024, 896))
             for d_ in (64, 128, 256)
             for g_, kv_ in ((1, 2), (4, 2), (8, 1))]
# (b) a float32 copy of qwen3-4b-swa4096 at full width, depth cut to 2
# layers, 1 x 8,192 tokens, remat on: lm_loss and every gradient through
# the kernels (FMA forward, the backward kernel) against the same model
# through the plain versions (the loss within 1e-5 relative, each
# parameter's gradient within 1e-4 of that leaf's largest element)
TRAIN_FP32 = {"n_layers": 2, "batch": 1, "seq": 8192}
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_SHARE = 1e-4
# (b') the same copy in bf16 through the kernel route (the wgmma forward
# and backward) against the plain route: each parameter's gradient within
# 2e-2 of that leaf's largest element, the bound of the cuda test of
# wq.grad (tests/test_torch_swa.py; the two forwards round o differently)
TRAIN_BF16_GRAD_SHARE = 2e-2
# (c) qwen3-4b-swa4096 at full width and depth (bf16 params, float32 AdamW
# state), 2 x 16,384 tokens (cell 2's prefill tokens; train_4k's global
# batch of 256 x 4,096 cut to what one card holds), 3 steps through
# launch/train.py's loop; (d) examples/train_e2e_torch.py --preset small
TRAIN = {"arch": "qwen3-4b", "shape": "long_500k", "batch": 2, "seq": 16384,
         "steps": 3}
# phase 17: training mamba2-780m. (a) B3's backward, the route that
# ssd._bwd_route names (float32: the FMA kernel's three launches; bf16: the
# shared bK1 and the tensor-core kernel's four), against the plain
# backward and each launch against its plain stage; in bf16 the FMA route
# on the same input too: edge shapes (L = Q and 4Q; Q 64 and 256; N 64
# and 128; H 1 and 3; with and without init_state; a zero and a non-zero
# final-state gradient; float32 and bf16; strided x/B/C views), the path's
# shape and zamba2-7b's; gates as phase 16 (a): float32 outputs within
# 1e-4 of their largest plain element (BWD_F32_SHARE), bf16 outputs one
# ulp of the plain float32 backward rounded once (SSD_TOL), two calls the
# same bits
SSD_BWD_EDGES = [(q_, l_ * q_, n_, h_) for q_ in (64, 256) for l_ in (1, 4)
                 for n_ in (64, 128) for h_ in (1, 3)]
SSD_BWD_PATH = {"b": 16, "L": 4096, "H": 48, "N": 128, "Q": 256}
SSD_BWD_ZAMBA = {"b": 1, "L": 8192, "H": 112, "N": 64, "Q": 256}
# (b) a float32 copy of mamba2-780m at full width, 2 layers, 1 x 8,192
# tokens, remat on, kernels (FMA forward, the backward kernel) against the
# plain versions, phase 16 (b)'s gates; (b') the same copy in bf16 (the
# tensor-core forward) and zamba2-7b at full width, 3 layers (one a-m-m
# group), 1 x 8,192, each gradient within 2e-2 of its leaf's largest
SSD_TRAIN_COPY = {"n_layers": 2, "batch": 1, "seq": 8192}
ZAMBA_TRAIN_COPY = {"n_layers": 3, "batch": 1, "seq": 8192}
# (c) mamba2-780m at full width and depth (bf16 params, float32 AdamW
# state), 16 x 4,096 tokens: train_4k's global batch of 256 x 4,096 cut by
# batch to what one card holds; 3 steps through launch/train.py's loop
SSD_TRAIN = {"arch": "mamba2-780m", "batch": 16, "seq": 4096, "steps": 3}
# phase 20: the dry run's predicted peak a card within this share of
# phases 16 (c) and 17 (c)'s max_memory_allocated (0.04% and 0.47% apart
# when first measured on the card)
DRYRUN_PEAK_SHARE = 0.02
# phase 18: DyPe on an H100 node. (a) the card's figures beside
# core/device.py's H100 entries: nvidia-smi's power.draw sampled every 100 ms
# over POWER_S seconds idle and under each loop (the first POWER_SKIP
# samples dropped), copy rates over COPY_BYTES; (b) hw_oracle's "H100" role
# against the card at DyPe's own kernel specs (SpMM1 and GeMM1 of the GCN on
# the six Table-I datasets at full size, WinAttn1 of the two SWA-T
# workloads), the oracle within ORACLE_FACTOR of the card's time (mean of
# 10 launches after one)
POWER_S = 2.0
POWER_SKIP = 5
COPY_BYTES = 512 << 20
ORACLE_FACTOR = 2.0
GCN_SETS = ("OA", "OP", "S1", "S2", "S3", "S4")
SWA_T = ((4096, 512), (16384, 1024))


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
    """Least time for the banded attention on these shapes: the work of
    ``kernels/swa.py:work`` (q, k, v read once and o written once, the
    q.k and p.v products of the in-band pairs only) at the dense bf16
    tensor-core rate."""
    from repro_torch.kernels import swa
    nbytes, flops = swa.work(B, H, KV, S, D, window, esize)
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


def swa_bwd_bound(B, H, KV, S, D, window, esize, products, stats=False,
                  grads=()):
    """Least time for ``products`` band products of the backward on these
    shapes, the work of ``kernels/swa.py:bwd_work``, at the dense bf16
    tensor-core rate."""
    from repro_torch.kernels import swa
    nbytes, flops = swa.bwd_work(B, H, KV, S, D, window, esize, products,
                                 stats=stats, grads=grads)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def bwd_ptxas(log):
    """Registers, spills and stack of each instantiation of the three
    kernels of either backward (FMA ``swa_bwd_*_kernel``, bf16 wgmma
    ``swa_bwd_*_wgmma_kernel``) in an ``nvcc -Xptxas -v`` log, keyed
    ``kernel<dtype, D>``."""
    import re
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            k = re.search(r"swa_bwd_(stats|dkdv|dq)(_wgmma)?_kernel",
                          m.group(1))
            d = re.search(r"Li(\d+)E", m.group(1))
            if k and d:
                wg = k.group(2) or ""
                t = "bf16" if wg or "bfloat16" in m.group(1) else "f32"
                name = f"swa_bwd_{k.group(1)}{wg}_kernel<{t}, {d.group(1)}>"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            info.setdefault(name, {})["registers"] = int(m.group(1))
        elif name and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            info.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
    return info


def share_err(got, exp):
    """max |got - exp| and its share of max |exp|."""
    err = float((got.float() - exp.float()).abs().max())
    return err, err / max(float(exp.float().abs().max()), 1e-30)


def hold_bwd(label, got, exp, stats, pstats, dtype):
    """Hold a backward's (dq, dk, dv) and row statistics (lse, delta) to the
    plain backward's: the statistics within STATS_SHARE of their largest,
    the gradients within BWD_F32_SHARE of the largest in float32 and at one
    ulp (SWA_TOL) in bf16. Returns the errors."""
    import torch
    row = {}
    for name, a, b in zip(("lse", "delta"), stats, pstats):
        err, share = share_err(a, b)
        if not torch.isfinite(a).all() or share > STATS_SHARE:
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 f"stage by {share:.3e} of its largest")
        row[f"{name}_max_abs_err"] = err
    for name, a, b in zip(("dq", "dk", "dv"), got, exp):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {name} is not finite")
        err, share = share_err(a, b)
        if dtype == torch.float32:
            if share > BWD_F32_SHARE:
                raise AssertionError(f"{label}: {name} differs from the "
                                     f"plain backward by {share:.3e} of its "
                                     f"largest (limit {BWD_F32_SHARE})")
        else:
            atol, rtol = SWA_TOL["bfloat16"]
            torch.testing.assert_close(a, b, atol=atol, rtol=rtol,
                                       msg=lambda m: f"{label} {name}: {m}")
        row[f"{name}_max_abs_err"], row[f"{name}_share"] = err, share
    return row


def check_swa_bwd(label, q, k, v, window, gen, *, time_it=False):
    """The three entries of the backward kernel that ``swa._bwd_route``
    names (wgmma for bf16 at D 64/128, FMA for float32 and bf16 at D 256)
    vs the plain backward on the card for one input (o from the routed
    forward kernel, do a seeded normal draw), held by ``hold_bwd``; a
    second call the same bits. With ``time_it`` the three entries, the
    whole backward, the plain version and the library yardstick are timed,
    with the bounds; on a wgmma-routed input the FMA backward is also held
    on it and timed, as the comparison. Returns a dict of the numbers
    measured."""
    import torch
    from repro_torch.kernels import (swa, swa_attention, swa_attention_bwd,
                                     swa_attention_bwd_plain,
                                     swa_attention_bwd_stats_plain)
    B, H, S, D = q.shape
    scale = D ** -0.5
    kw = {"window": window, "scale": scale}
    o = swa_attention(q, k, v, **kw)
    do = torch.randn(q.shape, generator=gen, device=q.device,
                     dtype=q.dtype)
    route = swa._bwd_route(q.dtype, D)
    entries = swa._BWD_KERNELS[route]
    counted = swa._BWD_KERNELS["wgmma"] + swa._BWD_KERNELS["fma"]
    n0 = [f.launches for f in counted]
    lse, delta = entries[0](q, k, v, o, do, **kw)
    got = swa_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    want = [2, 1, 1] if route == "wgmma" else [0, 0, 0]
    want += [0, 0, 0] if route == "wgmma" else [2, 1, 1]
    if [f.launches - n for f, n in zip(counted, n0)] != want:
        raise AssertionError(f"{label}: the backward did not launch the "
                             f"{route} route's three kernels once each")
    pstats = swa_attention_bwd_stats_plain(q, k, o, do, **kw)
    exp = swa_attention_bwd_plain(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    row = {"label": label, "route": route, "q": list(q.shape),
           "kv": list(k.shape), "window": window, "dtype": str(q.dtype)}
    row.update(hold_bwd(label, got, exp, (lse, delta), pstats, q.dtype))
    again = swa_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two calls of the backward differ")
    row["bit_repeatable"] = True
    del got, again
    if time_it:
        KV = k.shape[1]
        es = q.element_size()
        stats_fn, dkdv_fn, dq_fn = entries
        row["ms"] = time_ms(lambda: swa_attention_bwd(q, k, v, o, do, **kw),
                            10)
        row["stats_ms"] = time_ms(lambda: stats_fn(q, k, v, o, do, **kw), 10)
        row["dkdv_ms"] = time_ms(lambda: dkdv_fn(
            q, k, v, o, do, lse, delta, **kw), 10)
        row["dq_ms"] = time_ms(lambda: dq_fn(
            q, k, v, o, do, lse, delta, **kw), 10)
        if route == "wgmma":
            # the FMA backward on the same bf16 input, held and timed
            f_stats, f_dkdv, f_dq = swa._BWD_KERNELS["fma"]
            flse, fdelta = f_stats(q, k, v, o, do, **kw)
            fgot = (f_dq(q, k, v, o, do, flse, fdelta, **kw),
                    *f_dkdv(q, k, v, o, do, flse, fdelta, **kw))
            torch.cuda.synchronize()
            row.update({f"fma_{k_}": v_ for k_, v_ in hold_bwd(
                f"{label} (FMA backward)", fgot, exp, (flse, fdelta),
                pstats, q.dtype).items()})
            del fgot
            row["fma_stats_ms"] = time_ms(
                lambda: f_stats(q, k, v, o, do, **kw), 3)
            row["fma_dkdv_ms"] = time_ms(lambda: f_dkdv(
                q, k, v, o, do, flse, fdelta, **kw), 3)
            row["fma_dq_ms"] = time_ms(lambda: f_dq(
                q, k, v, o, do, flse, fdelta, **kw), 3)
            row["fma_ms"] = sum(row[f"fma_{p_}_ms"]
                                for p_ in ("stats", "dkdv", "dq"))
            del flse, fdelta
        row["plain_ms"] = time_ms(
            lambda: swa_attention_bwd_plain(q, k, v, o, do, **kw), 3)
        row["stats_plain_ms"] = time_ms(
            lambda: swa_attention_bwd_stats_plain(q, k, o, do, **kw), 3)
        # the backward: five band products (s recomputed, dp, dv, dq, dk)
        row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = \
            swa_bwd_bound(B, H, KV, S, D, window, es, 5,
                          grads=("dq", "dk", "dv"))
        for part, prods, kwb in (("stats", 1, {"stats": True}),
                                 ("dkdv", 4, {"grads": ("dk", "dv")}),
                                 ("dq", 3, {"grads": ("dq",)})):
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"], _, _ = \
                swa_bwd_bound(B, H, KV, S, D, window, es, prods, **kwb)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflop_per_s"] = row["flops"] / row["ms"] / 1e9
        if route == "wgmma":
            # band products issued: stats s; dkdv s, dp, and dv and dk in
            # DKDV_PARTS parts each; dq s, dp, and dq in DQ_PARTS parts
            row["issued_products"] = 1 + 2 + 2 * 3 + 2 + 2
            row["issued_tflop_per_s"] = (row["tflop_per_s"]
                                         * row["issued_products"] / 5)
        row.update(sdpa_bwd_yardstick(q, k, v, do, window, scale))
    print(json.dumps(row), flush=True)
    del o, do, lse, delta, exp
    torch.cuda.synchronize()
    return row


def sdpa_bwd_yardstick(q, k, v, do, window, scale):
    """One library call for the same gradients: the backward of PyTorch's
    memory-efficient scaled_dot_product_attention with the band as a
    broadcast (S, S) additive mask, K/V repeated to H heads (it computes
    every (row, key) pair). Only the backward is timed. Used nowhere in the
    port."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    S, G = q.shape[2], q.shape[1] // k.shape[1]
    qq = q.detach().clone().requires_grad_()
    kr, vr = (t.repeat_interleave(G, dim=1).requires_grad_() for t in (k, v))
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    bias = torch.zeros((S, S), dtype=q.dtype, device=q.device).masked_fill(
        (rel < 0) | (rel >= window), float("-inf"))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(qq, kr, vr, attn_mask=bias,
                                             scale=scale)
    grads = torch.autograd.grad(out, (qq, kr, vr), do, retain_graph=True)
    torch.cuda.synchronize()
    ms = time_ms(lambda: torch.autograd.grad(out, (qq, kr, vr), do,
                                             retain_graph=True), 10)
    del out, grads, qq, kr, vr, bias
    return {"library_ms": ms,
            "library": "SDPA memory-efficient backward, band mask"}


def train_grads(cfg, params, batch):
    """(loss, {path: gradient}) of ``lm_loss`` on the card."""
    from repro_torch.models import lm_loss
    from repro_torch.models.common import tree_leaves
    leaves = [t for _, t in tree_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    loss = lm_loss(params, batch, cfg)
    loss.backward()
    grads = {p: t.grad for p, t in tree_leaves(params)}
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return float(loss.detach()), grads


def train_phase(gen, card, log):
    """Phase 16: the training path (see the module docstring). Returns a
    dict of what it measured."""
    import contextlib
    import io
    import runpy
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import (ops, swa, swa_attention_bwd_plain,
                                     swa_attention_plain)
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import effective_config
    from repro_torch.models import init_params, model_decls
    dev = torch.device("cuda", 0)
    out = {"card": card}

    # (a) the backward kernel, before any model is resident
    t0 = time.perf_counter()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for s_, w_, d_, g_, kv_ in BWD_EDGES:
            q = torch.randn((2, g_ * kv_, s_, d_), generator=gen, device=dev,
                            dtype=dtype)
            k, v = (torch.randn((2, kv_, s_, d_), generator=gen, device=dev,
                                dtype=dtype) for _ in range(2))
            rows.append(check_swa_bwd(
                f"S={s_} window={w_} D={d_} G={g_} KV={kv_} {dtype}", q, k,
                v, w_, gen))
    B, S, H, KV, D, W = 2, 16384, 32, 8, 128, 4096
    for b_, s_, dtype, timed in ((1, 8192, torch.float32, False),
                                 (B, S, torch.bfloat16, True)):
        q, k, v = (torch.randn((b_, s_, n, D), generator=gen, device=dev,
                               dtype=dtype).transpose(1, 2)
                   for n in (H, KV, KV))
        rows.append(check_swa_bwd(
            f"path S={s_} window={W} {dtype} (B,S,H,D) views", q, k, v, W,
            gen, time_it=timed))
        del q, k, v
    torch.cuda.empty_cache()
    out["bwd"] = rows[-1]
    # each route's largest error: the wgmma route's edges and path, the FMA
    # route's edges, float32 path and the FMA backward on the bf16 path
    out["bwd_max_abs_err"] = {route: {
        n: max([r[f"{n}_max_abs_err"] for r in rows if r["route"] == route]
               + ([rows[-1][f"fma_{n}_max_abs_err"]] if route == "fma"
                  else []))
        for n in ("lse", "delta", "dq", "dk", "dv")}
        for route in ("wgmma", "fma")}
    out["bwd_build"] = {"ptxas": bwd_ptxas(log),
                        "dynamic_smem_bytes": {
                            d_: swa.bwd_smem_bytes(d_) for d_ in swa.FMA_D},
                        "wgmma_dynamic_smem_bytes": {
                            d_: swa.bwd_wgmma_smem_bytes(d_)
                            for d_ in swa.WGMMA_BWD_D}}
    print(json.dumps({"swa_attention_bwd build": out["bwd_build"]}),
          flush=True)
    out["a_seconds"] = time.perf_counter() - t0

    # (b) a float32 copy at full width, 2 layers: kernels vs plain
    t0 = time.perf_counter()
    cfg32 = effective_config(get_config(TRAIN["arch"]),
                             SHAPES[TRAIN["shape"]]).replace(
        n_layers=TRAIN_FP32["n_layers"], param_dtype="float32",
        compute_dtype="float32")
    if (cfg32.attention, cfg32.window, cfg32.d_model, cfg32.remat) != \
            ("swa", 4096, 2560, True):
        raise AssertionError(f"not the qwen3-4b-swa4096 config: {cfg32}")
    params = init_params(model_decls(cfg32),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         torch.float32)
    batch = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in synthetic_batch(
        0, TRAIN_FP32["batch"], TRAIN_FP32["seq"], cfg32.vocab_size).items()}
    names = ("swa_attention_fma", "swa_attention_wgmma",
             "swa_attention_bwd_stats", "swa_attention_bwd_dkdv",
             "swa_attention_bwd_dq") + swa.BWD_WGMMA_ENTRIES
    counted = [getattr(swa, n) for n in names]
    n0 = [f.launches for f in counted]
    kloss, kgrads = train_grads(cfg32, params, batch)
    torch.cuda.synchronize()
    launched = {n: f.launches - c for n, f, c in zip(names, counted, n0)}
    L = cfg32.n_layers
    want = {"swa_attention_fma": 2 * L, "swa_attention_wgmma": 0,
            "swa_attention_bwd_stats": L, "swa_attention_bwd_dkdv": L,
            "swa_attention_bwd_dq": L, **dict.fromkeys(
                swa.BWD_WGMMA_ENTRIES, 0)}
    if launched != want:
        raise AssertionError(f"(b) launches {launched}, want {want}")
    with mock.patch.object(ops, "swa_attention", swa_attention_plain), \
            mock.patch.object(ops, "swa_attention_bwd",
                              swa_attention_bwd_plain):
        ploss, pgrads = train_grads(cfg32, params, batch)
    torch.cuda.synchronize()
    worst = max(((share_err(kgrads[p_], pgrads[p_])[1], p_)
                 for p_ in pgrads), key=lambda t: t[0])
    loss_rel = abs(kloss - ploss) / abs(ploss)
    out["fp32"] = {"layers": L, "tokens": [TRAIN_FP32["batch"],
                                           TRAIN_FP32["seq"]],
                   "loss": kloss, "plain_loss": ploss,
                   "loss_rel_err": loss_rel, "worst_grad_share": worst[0],
                   "worst_grad_leaf": worst[1], "launches": launched,
                   "seconds": time.perf_counter() - t0}
    print(json.dumps({"train fp32": out["fp32"]}), flush=True)
    if not (np.isfinite(kloss) and loss_rel <= TRAIN_LOSS_RTOL
            and worst[0] <= TRAIN_GRAD_SHARE):
        raise AssertionError(f"(b) the float32 copy's loss or gradients "
                             f"differ between the kernels and the plain "
                             f"versions: {out['fp32']}")
    del params, batch, kgrads, pgrads
    gc.collect()
    torch.cuda.empty_cache()

    # (b') the same copy in bf16: the kernel route (the wgmma forward and
    # backward) against the plain route
    t0 = time.perf_counter()
    cfg16 = cfg32.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = init_params(model_decls(cfg16),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         torch.bfloat16)
    batch = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in synthetic_batch(
        0, TRAIN_FP32["batch"], TRAIN_FP32["seq"], cfg16.vocab_size).items()}
    n0 = [f.launches for f in counted]
    kloss, kgrads = train_grads(cfg16, params, batch)
    torch.cuda.synchronize()
    launched = {n: f.launches - c for n, f, c in zip(names, counted, n0)}
    want = {**dict.fromkeys(names, 0), "swa_attention_wgmma": 2 * L,
            **dict.fromkeys(swa.BWD_WGMMA_ENTRIES, L)}
    if launched != want:
        raise AssertionError(f"(b') launches {launched}, want {want}")
    with mock.patch.object(ops, "swa_attention", swa_attention_plain), \
            mock.patch.object(ops, "swa_attention_bwd",
                              swa_attention_bwd_plain):
        ploss, pgrads = train_grads(cfg16, params, batch)
    torch.cuda.synchronize()
    shares = {p_: share_err(kgrads[p_], pgrads[p_])[1] for p_ in pgrads}
    worst = max(shares.items(), key=lambda t: t[1])
    out["bf16"] = {"layers": L, "tokens": [TRAIN_FP32["batch"],
                                           TRAIN_FP32["seq"]],
                   "loss": kloss, "plain_loss": ploss,
                   "loss_rel_err": abs(kloss - ploss) / abs(ploss),
                   "worst_grad_share": worst[1], "worst_grad_leaf": worst[0],
                   "grad_shares": shares, "launches": launched,
                   "seconds": time.perf_counter() - t0}
    print(json.dumps({"train bf16": out["bf16"]}), flush=True)
    if not (np.isfinite(kloss) and worst[1] <= TRAIN_BF16_GRAD_SHARE):
        raise AssertionError(f"(b') the bf16 copy's gradients differ "
                             f"between the kernels and the plain versions "
                             f"by more than {TRAIN_BF16_GRAD_SHARE} of a "
                             f"leaf's largest: {out['bf16']}")
    del params, batch, kgrads, pgrads
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the slice: qwen3-4b-swa4096 at full size, 3 steps of train()
    cfg = effective_config(get_config(TRAIN["arch"]), SHAPES[TRAIN["shape"]])
    if (cfg.attention, cfg.window, cfg.n_layers, cfg.d_model,
            cfg.param_dtype, cfg.opt_state_dtype, cfg.remat) != \
            ("swa", 4096, 36, 2560, "bfloat16", "float32", True):
        raise AssertionError(f"not the full qwen3-4b-swa4096 config: {cfg}")
    for f in train_mod.COUNTERS:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_mod.train(cfg, steps=TRAIN["steps"], batch=TRAIN["batch"],
                          seq=TRAIN["seq"], device=dev)
    torch.cuda.synchronize()
    total = {f.__name__: f.launches for f in train_mod.COUNTERS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = TRAIN["batch"] * TRAIN["seq"]
    L = cfg.n_layers
    per_step = {"swa_attention": 2 * L, "swa_attention_wgmma": 2 * L,
                **dict.fromkeys(swa.BWD_WGMMA_ENTRIES, L)}
    out["train"] = {
        "arch": cfg.name, "layers": L, "tokens": [TRAIN["batch"],
                                                  TRAIN["seq"]],
        "steps": TRAIN["steps"], "losses": list(res.losses.values()),
        "grad_norms": list(res.grad_norms.values()),
        "ms": [res.seconds[s_] * 1e3 for s_ in sorted(res.seconds)],
        "tok_per_s": [tokens / res.seconds[s_] for s_ in sorted(res.seconds)],
        "peak_gib": peak, "launches": total,
        "launches_per_step": [res.launches[s_] for s_ in sorted(res.launches)],
        "seconds": time.perf_counter() - t0}
    print(json.dumps({"train": out["train"]}), flush=True)
    if not (np.isfinite(out["train"]["losses"]).all()
            and np.isfinite(out["train"]["grad_norms"]).all()):
        raise AssertionError("(c) a loss or grad norm is not finite")
    if any(launches != per_step for launches in
           out["train"]["launches_per_step"]) or total.get(
               "swa_attention_fma") or total.get("ssd_chunked"):
        raise AssertionError(f"(c) want {per_step} a step and no FMA "
                             f"launch, forward or backward; saw "
                             f"{out['train']['launches_per_step']}")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the example's restart replay on the card
    t0 = time.perf_counter()
    ckpt = Path(__file__).resolve().parent / "build" / "train_e2e_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    example = runpy.run_path(str(Path(__file__).resolve().parent / "examples"
                                 / "train_e2e_torch.py"), run_name="example")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        example["main"](["--preset", "small", "--ckpt-dir", str(ckpt)])
    text = buf.getvalue()
    print(text, end="", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    if "restart replay exact" not in text:
        raise AssertionError("(d) the example did not replay exactly")
    out["e2e"] = {"summary": text.strip().splitlines()[-1],
                  "seconds": time.perf_counter() - t0}
    return out


def ssd_bwd_bound(x, B, Q, part="all"):
    """Least time for the chunk scan's backward (``part`` "all") or one of
    its launches on these inputs, the work of ``kernels/ssd.py:bwd_work``,
    at the dense bf16 tensor-core rate for bf16 inputs, the CUDA cores'
    float32 rate for float32."""
    import torch
    from repro_torch.kernels import ssd
    nbytes, flops = ssd.bwd_work(*x.shape, B.shape[-1], Q, x.element_size(),
                                 part)
    rate = BF16_FLOP_PER_S if x.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def ssd_bwd_ptxas(log):
    """Registers, spills and stack of each instantiation of the backward
    kernels of both routes in an ``nvcc -Xptxas -v`` log, keyed
    ``kernel<dtype, N>`` (``kernel`` alone where N is not a template
    argument)."""
    import re
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            k = re.search(r"(ssd_bwd_(dstate|scan|grads|tc_scan|tc_dgs|"
                          r"tc_dbdc|tc_head)_kernel)", m.group(1))
            n = re.search(r"Li(\d+)E", m.group(1))
            if k and n:
                t = ("bf16" if "bfloat16" in m.group(1) else "f32"
                     if "IfLi" in m.group(1) else "any")
                name = f"{k.group(1)}<{t}, {n.group(1)}>"
            elif k:
                name = k.group(1)
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


SSD_BWD_NAMES = ("dx", "ddts", "dda", "dB", "dC", "dD", "dinit")


def hold_ssd_bwd(label, got, exp, names=SSD_BWD_NAMES):
    """Hold backward outputs to the plain ones: bf16 at one ulp of the
    plain float32 rounded once (SSD_TOL), float32 within BWD_F32_SHARE of
    the largest plain element. Returns the max abs errors by name."""
    import torch
    row = {}
    for name, a, b in zip(names, got, exp):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {name} is not finite")
        err, share = share_err(a, b)
        if a.dtype == torch.bfloat16:
            atol, rtol = SSD_TOL["bfloat16"]
            torch.testing.assert_close(a, b.to(torch.bfloat16), atol=atol,
                                       rtol=rtol,
                                       msg=lambda m: f"{label} {name}: {m}")
        elif share > BWD_F32_SHARE:
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 f"backward by {share:.3e} of its largest "
                                 f"(limit {BWD_F32_SHARE})")
        row[name] = err
    return row


def check_ssd_bwd(label, gen, b, L, H, N, Q, dtype, *, init=False,
                  dstate=False, slow=False, time_it=False):
    """The routed backward (``ssd.ssd_chunked_bwd``: the FMA kernel's three
    launches in float32, bK1 and the tensor-core kernel's four in bf16) on
    strided x/B/C views, from the routed forward's own la and entering
    states, against ``ssd_chunked_bwd_plain``; each launch against its
    plain stage on the plain stage's inputs; a second call the same bits.
    In bf16 the FMA route on the same input is held too. With ``time_it``
    the call, each launch, the FMA route's call and launches, the plain
    backward and each plain stage are timed, with the bounds. Returns a
    dict of the numbers."""
    import torch
    from repro_torch.kernels import ssd
    dev = torch.device("cuda", 0)
    P = ssd.BWD_P
    x, dt, B, C, A_log, D = ssd_inputs(gen, dev, b, L, H, P, N, dtype, slow)
    D = D + 1
    dts, da = ssd._discretize(dt, A_log)
    s0 = (torch.randn((b, H, P, N), generator=gen, device=dev) if init
          else None)
    dS = (torch.randn((b, H, P, N), generator=gen, device=dev) if dstate
          else None)
    dy = torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
    _, _, la, s_in = ssd.ssd_chunked_fwd(x, dts, da, B, C, D, chunk=Q,
                                         init_state=s0)
    route = ssd._bwd_route(dtype, P, N, Q)
    fns = ssd._BWD_KERNELS[route]
    n0 = [f.launches for f in fns]
    got = ssd.ssd_chunked_bwd(x, dts, la, B, C, D, s_in, dy, dS, chunk=Q)
    torch.cuda.synchronize()
    if [f.launches - n for f, n in zip(fns, n0)] != [1] * len(fns):
        raise AssertionError(f"{label}: the backward did not launch its "
                             f"{len(fns)} kernels once each")
    exp = ssd.ssd_chunked_bwd_plain(x, dts, da, B, C, D, dy, dS, chunk=Q,
                                    init_state=s0)
    torch.cuda.synchronize()
    row = {"label": label, "x": list(x.shape), "N": N, "chunk": Q,
           "dtype": str(dtype), "route": route, "init_state": init,
           "dstate": dstate}
    row.update(hold_ssd_bwd(label, got, exp))
    # each launch against its plain stage, on the plain stage's inputs
    R = ssd.ssd_chunk_bwd_dstate(dy, C, la, chunk=Q)
    pR = ssd.ssd_chunk_bwd_dstate_plain(dy, C, la, chunk=Q)
    pg, pdinit, pdle = ssd.ssd_chunk_bwd_scan_plain(la, pR, s_in, chunk=Q,
                                                    dstate=dS)
    stages = {"ssd_chunk_bwd_dstate": hold_ssd_bwd(f"{label} bK1", (R,),
                                                   (pR,), ("R",))}
    if route == "fma":
        g, dinit, dle = ssd.ssd_chunk_bwd_scan(la, pR.clone(), s_in, chunk=Q,
                                               dstate=dS)
        grads = ssd.ssd_chunk_bwd_grads(x, dts, la, B, C, D, dy, s_in, pg,
                                        pdle, chunk=Q)
        pgrads = ssd.ssd_chunk_bwd_grads_plain(x, dts, la, B, C, D, dy,
                                               s_in, pg, pdle, chunk=Q)
        torch.cuda.synchronize()
        stages["ssd_chunk_bwd_scan"] = hold_ssd_bwd(
            f"{label} bK2", (g, dinit, dle), (pg, pdinit, pdle),
            ("g", "dinit", "dle"))
        stages["ssd_chunk_bwd_grads"] = hold_ssd_bwd(f"{label} bK3", grads,
                                                     pgrads)
        del g, dinit, dle, grads, pgrads
    else:
        stages.update(tc_stage_check(label, x, dts, la, B, C, D, dy, s_in,
                                     pR, dS, Q))
        # the FMA route on the same bf16 input, held as well
        fma = ssd.bwd_run("fma", x, dts, la, B, C, D, s_in, dy, dS, chunk=Q)
        torch.cuda.synchronize()
        row["fma_route"] = hold_ssd_bwd(f"{label} FMA route", fma, exp)
        del fma
    row["stages"] = stages
    del R, pR, pg, pdinit, pdle
    again = ssd.ssd_chunked_bwd(x, dts, la, B, C, D, s_in, dy, dS, chunk=Q)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{label}: two calls of the backward differ")
    row["bit_repeatable"] = True
    del again
    if time_it:
        kw = {"chunk": Q}
        row["ms"] = time_ms(lambda: ssd.ssd_chunked_bwd(
            x, dts, la, B, C, D, s_in, dy, dS, **kw), 5)
        row["stage_ms"] = stage_times(ssd._BWD_KERNELS[route], x, dts, la, B,
                                      C, D, dy, s_in, dS, Q, 5)
        row["plain_ms"] = time_ms(lambda: ssd.ssd_chunked_bwd_stages_plain(
            x, dts, la, B, C, D, s_in, dy, dS, **kw), 2)
        row["stage_plain_ms"] = stage_times(
            ssd._BWD_PLAIN["fma"] + ssd._BWD_PLAIN["tc"][1:], x, dts, la, B,
            C, D, dy, s_in, dS, Q, 2)
        if route == "tc":
            # the FMA route and its launches on the same bf16 input
            row["fma_ms"] = time_ms(lambda: ssd.bwd_run(
                "fma", x, dts, la, B, C, D, s_in, dy, dS, **kw), 3)
            row["fma_stage_ms"] = stage_times(
                ssd._BWD_KERNELS["fma"], x, dts, la, B, C, D, dy, s_in, dS,
                Q, 3)
        row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = \
            ssd_bwd_bound(x, B, Q)
        row["stage_bound"] = {
            f"ssd_chunk_bwd_{p_}": dict(zip(
                ("bound_ms", "bound_by", "bytes", "flops"),
                ssd_bwd_bound(x, B, Q, p_)))
            for p_ in ("dstate", "scan", "grads", "tc_scan", "tc_dgs",
                       "tc_dbdc", "tc_head")}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflop_per_s"] = row["flops"] / row["ms"] / 1e9
        row["library_ms"] = None
    print(json.dumps(row), flush=True)
    del x, dt, B, C, dy, got, exp, la, s_in
    torch.cuda.synchronize()
    return row


def tc_stage_check(label, x, dts, la, B, C, D, dy, s_in, pR, dS, Q):
    """The tensor-core backward's four launches, each against its plain
    stage on the plain stages' inputs (dGs on its causal tiles, the only
    ones written). Returns {entry: max abs errors}."""
    import torch
    from repro_torch.kernels import ssd
    pg, pdinit, pdlep = ssd.ssd_chunk_bwd_tc_scan_plain(la, pR, s_in,
                                                        chunk=Q, dstate=dS)
    g, dinit, dlep = ssd.ssd_chunk_bwd_tc_scan(la, pR.clone(), s_in, chunk=Q,
                                               dstate=dS)
    pdgs = ssd.ssd_chunk_bwd_tc_dgs_plain(x, dts, la, dy, chunk=Q)
    dgs = ssd.ssd_chunk_bwd_tc_dgs(x, dts, la, dy, chunk=Q)
    tile = torch.arange(Q, device=x.device) // 64
    causal = tile[:, None] >= tile[None, :]
    pdbdc = ssd.ssd_chunk_bwd_tc_dbdc_plain(x, dts, la, B, C, dy, s_in, pg,
                                            pdgs, chunk=Q)
    dbdc = ssd.ssd_chunk_bwd_tc_dbdc(x, dts, la, B, C, dy, s_in, pg, pdgs,
                                     chunk=Q)
    head_in = (x, dts, la, B, C, D, dy, pg, pdlep, pdbdc[2], pdbdc[3])
    phead = ssd.ssd_chunk_bwd_tc_head_plain(*head_in, chunk=Q)
    head = ssd.ssd_chunk_bwd_tc_head(*head_in, chunk=Q)
    torch.cuda.synchronize()
    return {
        "ssd_chunk_bwd_tc_scan": hold_ssd_bwd(
            f"{label} tc scan", (g, dinit, dlep), (pg, pdinit, pdlep),
            ("g", "dinit", "dlep")),
        "ssd_chunk_bwd_tc_dgs": hold_ssd_bwd(
            f"{label} tc dgs", (dgs[..., causal],), (pdgs[..., causal],),
            ("dgs",)),
        "ssd_chunk_bwd_tc_dbdc": hold_ssd_bwd(
            f"{label} tc dbdc", dbdc, pdbdc, ("dB", "dC", "qc", "xg")),
        "ssd_chunk_bwd_tc_head": hold_ssd_bwd(
            f"{label} tc head", head, phead, ("dx", "ddts", "dda", "dDp"))}


def stage_times(fns, x, dts, la, B, C, D, dy, s_in, dS, Q, iters):
    """ms of each of ``fns`` (launches of a route, or their plain
    versions: bK1, then the FMA route's bK2 and bK3 or the tensor-core
    route's scan, dgs, dbdc and head, whichever ``fns`` holds) on inputs
    made once by the plain stages, by name."""
    from repro_torch.kernels import ssd
    kw = {"chunk": Q}
    plain = ssd._BWD_PLAIN
    R = plain["fma"][0](dy, C, la, **kw)
    g, _, dle = plain["fma"][1](la, R, s_in, dstate=dS, **kw)
    _, _, dlep = plain["tc"][1](la, R, s_in, dstate=dS, **kw)
    dgs = plain["tc"][2](x, dts, la, dy, **kw)
    _, _, qc, xg = plain["tc"][3](x, dts, la, B, C, dy, s_in, g, dgs, **kw)
    work = R.clone()             # the scans overwrite it in place (R -> g)
    calls = {
        "dstate": lambda f: f(dy, C, la, **kw),
        "scan": lambda f: f(la, work, s_in, dstate=dS, **kw),
        "grads": lambda f: f(x, dts, la, B, C, D, dy, s_in, g, dle, **kw),
        "tc_scan": lambda f: f(la, work, s_in, dstate=dS, **kw),
        "tc_dgs": lambda f: f(x, dts, la, dy, **kw),
        "tc_dbdc": lambda f: f(x, dts, la, B, C, dy, s_in, g, dgs, **kw),
        "tc_head": lambda f: f(x, dts, la, B, C, D, dy, g, dlep, qc, xg,
                               **kw)}
    out = {}
    for f in fns:
        name = f.__name__.removesuffix("_plain")
        call = calls[name.removeprefix("ssd_chunk_bwd_")]
        out[name] = time_ms(lambda: call(f), iters)
    return out


def ssd_copy_grads(label, cfg, dev, tokens, want_kernel, share,
                   loss_rtol=None):
    """``lm_loss`` and every gradient of ``cfg`` (drawn from seed 0 on the
    card) through the kernels and through the plain versions (the plain
    forward and backward stood in for them); holds the launches to
    ``want_kernel`` and each gradient to ``share`` of its leaf's largest
    (the loss to ``loss_rtol`` relative where given). Returns the
    numbers."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import ssd
    from repro_torch.models import init_params, model_decls
    t0 = time.perf_counter()
    params = init_params(model_decls(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         cfg.pdtype)
    batch = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in synthetic_batch(
        0, tokens[0], tokens[1], cfg.vocab_size).items()}
    names = (("ssd_chunked_fma", "ssd_chunked_tc") + ssd.BWD_ENTRIES
             + ssd.BWD_TC_ENTRIES)
    counted = [getattr(ssd, n) for n in names]
    n0 = [f.launches for f in counted]
    kloss, kgrads = train_grads(cfg, params, batch)
    torch.cuda.synchronize()
    launched = {n: f.launches - c for n, f, c in zip(names, counted, n0)}
    if launched != want_kernel:
        raise AssertionError(f"{label}: launches {launched}, want "
                             f"{want_kernel}")
    with mock.patch.object(ssd, "ssd_chunked_fwd",
                           ssd.ssd_chunked_fwd_plain), \
            mock.patch.object(ssd, "ssd_chunked_bwd",
                              ssd.ssd_chunked_bwd_stages_plain):
        ploss, pgrads = train_grads(cfg, params, batch)
    torch.cuda.synchronize()
    shares = {p_: share_err(kgrads[p_], pgrads[p_])[1] for p_ in pgrads}
    worst = max(shares.items(), key=lambda t: t[1])
    row = {"arch": cfg.name, "layers": cfg.n_layers, "tokens": list(tokens),
           "dtype": cfg.param_dtype, "loss": kloss, "plain_loss": ploss,
           "loss_rel_err": abs(kloss - ploss) / abs(ploss),
           "worst_grad_share": worst[1], "worst_grad_leaf": worst[0],
           "grad_shares": shares, "launches": launched,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({label: row}), flush=True)
    if not (np.isfinite(kloss) and worst[1] <= share
            and (loss_rtol is None or row["loss_rel_err"] <= loss_rtol)):
        raise AssertionError(f"{label}: the loss or gradients differ "
                             f"between the kernels and the plain versions: "
                             f"{row}")
    del params, batch, kgrads, pgrads
    gc.collect()
    torch.cuda.empty_cache()
    return row


def ssd_train_phase(gen, card, log):
    """Phase 17: training mamba2-780m with B3's forward and its backward
    kernel (see the module docstring). Returns a dict of what it
    measured."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd
    from repro_torch.launch import train as train_mod
    dev = torch.device("cuda", 0)
    out = {"card": card}

    # (a) the backward kernel, before any model is resident
    t0 = time.perf_counter()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (q_, l_, n_, h_) in enumerate(SSD_BWD_EDGES):
            rows.append(check_ssd_bwd(
                f"L={l_} chunk={q_} N={n_} H={h_} {dtype}", gen, 2, l_, h_,
                n_, q_, dtype, init=bool(i & 1), dstate=bool(i & 2),
                slow=bool(i & 4)))
    for name, sh in (("path", SSD_BWD_PATH), ("zamba2", SSD_BWD_ZAMBA)):
        rows.append(check_ssd_bwd(
            f"{name} b={sh['b']} L={sh['L']} H={sh['H']} N={sh['N']} bf16 "
            f"strided views", gen, sh["b"], sh["L"], sh["H"], sh["N"],
            sh["Q"], torch.bfloat16, time_it=True))
        out[name] = rows[-1]
        torch.cuda.empty_cache()
    out["bwd_max_abs_err"] = {
        route: {n: max(r[n] for r in rows if r["route"] == route)
                for n in SSD_BWD_NAMES} for route in ("fma", "tc")}
    out["fma_route_bf16_max_abs_err"] = {
        n: max(r["fma_route"][n] for r in rows if "fma_route" in r)
        for n in SSD_BWD_NAMES}
    out["stage_max_abs_err"] = {
        st_: max(max(r["stages"][st_].values()) for r in rows
                 if st_ in r["stages"])
        for st_ in ssd.BWD_ENTRIES + ssd.BWD_TC_ENTRIES}
    out["bwd_build"] = {"ptxas": ssd_bwd_ptxas(log), "dynamic_smem_bytes": {
        n_: ssd.bwd_smem_bytes(n_) for n_ in ssd.KERNEL_N}}
    print(json.dumps({"ssd_chunk_bwd build": out["bwd_build"]}), flush=True)
    out["a_seconds"] = time.perf_counter() - t0

    # (b) a float32 copy at full width, 2 layers; (b') the same in bf16,
    # and zamba2-7b's first a-m-m group in bf16
    L = SSD_TRAIN_COPY["n_layers"]
    cfg32 = get_config(SSD_TRAIN["arch"]).replace(
        n_layers=L, param_dtype="float32", compute_dtype="float32")
    if (cfg32.family, cfg32.d_model, cfg32.ssm_state, cfg32.ssm_chunk,
            cfg32.ssm_heads, cfg32.remat) != ("ssm", 1536, 128, 256, 48,
                                              True):
        raise AssertionError(f"not the mamba2-780m config: {cfg32}")
    tokens = (SSD_TRAIN_COPY["batch"], SSD_TRAIN_COPY["seq"])

    def bwd_launches(route, n):
        """n calls of the route's launches, none of the other route's."""
        out_ = dict.fromkeys(ssd.BWD_ENTRIES + ssd.BWD_TC_ENTRIES, 0)
        out_.update({f.__name__: n for f in ssd._BWD_KERNELS[route]})
        return out_
    out["fp32"] = ssd_copy_grads(
        "train mamba2 fp32", cfg32, dev, tokens,
        {"ssd_chunked_fma": 2 * L, "ssd_chunked_tc": 0,
         **bwd_launches("fma", L)}, TRAIN_GRAD_SHARE, TRAIN_LOSS_RTOL)
    cfg16 = cfg32.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    out["bf16"] = ssd_copy_grads(
        "train mamba2 bf16", cfg16, dev, tokens,
        {"ssd_chunked_fma": 0, "ssd_chunked_tc": 2 * L,
         **bwd_launches("tc", L)}, TRAIN_BF16_GRAD_SHARE)
    zcfg = get_config("zamba2-7b").replace(
        n_layers=ZAMBA_TRAIN_COPY["n_layers"], param_dtype="bfloat16",
        compute_dtype="bfloat16")
    zm = (zcfg.n_layers // len(zcfg.hybrid_pattern)) \
        * zcfg.hybrid_pattern.count("m")
    if (zcfg.family, zcfg.d_model, zcfg.ssm_state, zcfg.ssm_heads, zm) != \
            ("hybrid", 3584, 64, 112, 2):
        raise AssertionError(f"not zamba2-7b's a-m-m group: {zcfg}")
    out["zamba2_bf16"] = ssd_copy_grads(
        "train zamba2 bf16", zcfg, dev,
        (ZAMBA_TRAIN_COPY["batch"], ZAMBA_TRAIN_COPY["seq"]),
        {"ssd_chunked_fma": 0, "ssd_chunked_tc": 2 * zm,
         **bwd_launches("tc", zm)}, TRAIN_BF16_GRAD_SHARE)

    # (c) the slice: mamba2-780m at full size, 3 steps of train()
    cfg = get_config(SSD_TRAIN["arch"])
    if (cfg.family, cfg.n_layers, cfg.d_model, cfg.param_dtype,
            cfg.opt_state_dtype, cfg.remat) != \
            ("ssm", 48, 1536, "bfloat16", "float32", True):
        raise AssertionError(f"not the full mamba2-780m config: {cfg}")
    for f in train_mod.COUNTERS:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_mod.train(cfg, steps=SSD_TRAIN["steps"],
                          batch=SSD_TRAIN["batch"], seq=SSD_TRAIN["seq"],
                          device=dev)
    torch.cuda.synchronize()
    total = {f.__name__: f.launches for f in train_mod.COUNTERS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = SSD_TRAIN["batch"] * SSD_TRAIN["seq"]
    L = cfg.n_layers
    per_step = {"ssd_chunked": 2 * L, "ssd_chunked_tc": 2 * L,
                "ssd_chunked_bwd": L,
                **{f.__name__: L for f in ssd._BWD_KERNELS["tc"]}}
    out["train"] = {
        "arch": cfg.name, "layers": L, "tokens": [SSD_TRAIN["batch"],
                                                  SSD_TRAIN["seq"]],
        "steps": SSD_TRAIN["steps"], "losses": list(res.losses.values()),
        "grad_norms": list(res.grad_norms.values()),
        "ms": [res.seconds[s_] * 1e3 for s_ in sorted(res.seconds)],
        "tok_per_s": [tokens / res.seconds[s_] for s_ in sorted(res.seconds)],
        "peak_gib": peak, "launches": total,
        "launches_per_step": [res.launches[s_] for s_ in sorted(res.launches)],
        "seconds": time.perf_counter() - t0}
    print(json.dumps({"train mamba2": out["train"]}), flush=True)
    if not (np.isfinite(out["train"]["losses"]).all()
            and np.isfinite(out["train"]["grad_norms"]).all()):
        raise AssertionError("(c) a loss or grad norm is not finite")
    if any(launches != per_step for launches in
           out["train"]["launches_per_step"]):
        raise AssertionError(f"(c) want {per_step} a step (no FMA forward "
                             f"or backward past the shared bK1, no SWA "
                             f"kernel); saw "
                             f"{out['train']['launches_per_step']}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    """Least time for the SSD scan of these inputs, the work of
    ``kernels/ssd.py:work`` (every input read once and y and the final
    state written once, C B^T once per (batch, chunk), the causal
    triangle only), at the dense bf16 tensor-core rate for bf16 inputs
    (the CUDA cores' float32 rate for float32)."""
    import torch
    from repro_torch.kernels import ssd
    x, dt, B, C, A_log, D = args
    size = lambda t: t.numel() * t.element_size()         # noqa: E731
    nbytes, flops = ssd.work(
        *x.shape, B.shape[-1], min(chunk, x.shape[1]), x.element_size(),
        dt_bytes=size(dt), param_bytes=size(A_log) + size(D),
        init_bytes=0 if init_state is None else size(init_state))
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
    held = torch.cuda.memory_allocated()       # what earlier phases left
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
           # the CLI's peak over its decode loop (its weights and caches
           # resident, no draw; not what earlier phases left), else the
           # run's
           "peak_gib": (res.peak_bytes if res.peak_bytes is not None
                        else torch.cuda.max_memory_allocated()) / 2 ** 30,
           "held_before_gib": held / 2 ** 30,
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

    def recording_decode(params, token, pos, cache, cfg, **kw):
        out, cache = real_decode(params, token, pos, cache, cfg, **kw)
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


def smi(query):
    """One nvidia-smi reading of card 0, without units."""
    r = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip()


def power_under(fn, seconds=POWER_S):
    """Median of nvidia-smi's power.draw (W) of card 0, sampled every 100
    ms while ``fn`` runs in a loop for ``seconds`` (``None``: idle), the
    first POWER_SKIP samples dropped. The sampler is stopped before this
    returns."""
    import statistics
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        end, n = time.perf_counter() + seconds, 0
        while time.perf_counter() < end:
            if fn is None:
                time.sleep(0.05)
                continue
            fn()
            n += 1
            if n % 4 == 0:             # keep the queue short: the loop ends
                torch.cuda.synchronize()   # when the card's work does
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    samples = [float(v) for v in out.split()
               if v.replace(".", "", 1).isdigit()][POWER_SKIP:]
    if not samples:
        raise AssertionError(f"nvidia-smi gave no power.draw samples: {out!r}")
    return statistics.median(samples), len(samples)


def card_graph(ds, gen, dev):
    """A Table-I graph at full size drawn on the card: the law of
    ``data.table1_graph`` (uniform random edges plus self loops, duplicates
    merged, GCN-normalised values), with torch's generator in place of
    numpy's, whose host build takes ~0.5 us an edge (over a minute at
    S1's 120 M edges). Returns the int32 CSR operand the kernel reads."""
    import torch
    from repro_torch.kernels import CsrOperand
    V, E = ds.vertices, ds.edges
    loops = torch.arange(V, device=dev)
    src = torch.cat([torch.randint(V, (E,), generator=gen, device=dev),
                     loops])
    key = src * V
    del src
    key += torch.cat([torch.randint(V, (E,), generator=gen, device=dev),
                      loops])
    key = torch.unique(key)            # sorted: rows, then columns
    src, dst = key // V, key % V
    del key
    deg = torch.bincount(src, minlength=V)
    dinv = deg.clamp(min=1).float().rsqrt()
    values = dinv[src] * dinv[dst]
    indptr = torch.zeros(V + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    return CsrOperand(indptr.int(), dst.int(), values, (V, V))


def oracle_row(label, k, card_ms, perf, extra=None):
    """One spec's card time beside hw_oracle.measure(k, "H100") and the
    fitted PerfModel's time on one H100_DENSE card."""
    from repro_torch.core import H100_DENSE, hw_oracle
    oracle_ms = hw_oracle.measure(k, "H100") * 1e3
    row = {"spec": label, "kind": k.kind, "card_ms": card_ms,
           "oracle_ms": oracle_ms,
           "fitted_ms": perf.kernel_time(k, H100_DENSE, 1) * 1e3,
           "oracle_over_card": oracle_ms / card_ms, **(extra or {})}
    print(json.dumps(row), flush=True)
    return row


def lm_mesh_rank(pm, arch, layers, batch, seq):
    """Phase 19 (a), in the one rank of a (1, 1) NCCL world: ``lm_loss``
    and every gradient through the mesh path and through the one-card path
    on the same seeded float32 copy, compared bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import dist
    from repro_torch.models import lm
    from repro_torch.models.common import init_params, tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = pm.device
    cfg = get_config(arch).replace(n_layers=layers, param_dtype="float32",
                                   compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(19)
    full = init_params(lm.model_decls(cfg), gen, dev, cfg.pdtype)
    gen.manual_seed(19)
    shards = dist.shard_init(lm.model_decls(cfg, pm.ax), gen, dev,
                             cfg.pdtype, pm.ax, pm.coords)
    b = {k: torch.from_numpy(v).to(dev) for k, v in
         synthetic_batch(0, batch, seq, cfg.vocab_size).items()}
    out = {"arch": arch, "layers": layers, "tokens": [batch, seq],
           "mesh": dict(pm.mesh.shape), "backend": torch.distributed
           .get_backend(), "params_equal": all(
               torch.equal(a, c) for (_, a), (_, c) in
               zip(tree_leaves(full), tree_leaves(shards)))}
    runs = {}
    for name, params, kw in (("one_card", full, {}),
                             ("mesh", shards, {"mesh": pm})):
        for _, t in tree_leaves(params):
            t.requires_grad_(True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = lm.lm_loss(params, b, cfg, **kw)
        loss.backward()
        torch.cuda.synchronize(dev)
        runs[name] = (loss.detach(), {p: t.grad for p, t in
                                      tree_leaves(params)})
        out[f"{name}_fwd_bwd_s"] = time.perf_counter() - t0
    (l1, g1), (lm_, gm) = runs["one_card"], runs["mesh"]
    out["loss"] = float(l1)
    out["loss_equal"] = torch.equal(l1, lm_)
    out["grads_equal"] = {p: torch.equal(g1[p], gm[p]) for p in g1}
    out["max_abs_grad_diff"] = max(float((g1[p] - gm[p]).abs().max())
                                   for p in g1)
    return out


def dryrun_phase(card, train16, train17, decode14):
    """Phase 20: the dry run's evaluation of phases 16 (c) and 17 (c)'s
    steps and of phase 14 (a)'s gemma-2b decode step, one rank of a
    (1, 1) mesh on meta tensors, against what those phases measured (see
    the module docstring). Returns its record."""
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.kernels import ssd, swa
    from repro_torch.launch.dryrun import evaluate
    from repro_torch.launch.steps import effective_config
    t0 = time.perf_counter()
    out = {"card": card}
    for key, arch, shape, run, measured, tally_of in (
            ("qwen3", TRAIN["arch"], TRAIN["shape"], TRAIN, train16, {
                "swa_attention_wgmma": ("swa_attention_wgmma",),
                "swa_attention_bwd_wgmma": swa.BWD_WGMMA_ENTRIES}),
            ("mamba2", SSD_TRAIN["arch"], None, SSD_TRAIN, train17, {
                "ssd_chunked_tc": ("ssd_chunked_tc",),
                "ssd_chunked_bwd_tc": tuple(
                    f.__name__ for f in ssd._BWD_KERNELS["tc"])})):
        cfg = get_config(arch)
        if shape:
            cfg = effective_config(cfg, SHAPES[shape])
        t1 = time.perf_counter()
        rec = evaluate(cfg, ShapeSpec(f"phase-{key}", run["seq"],
                                      run["batch"], "train"), (1, 1))
        pred = rec["memory"]["peak_bytes"] / 2 ** 30
        share = abs(pred - measured["peak_gib"]) / measured["peak_gib"]
        step = measured["launches_per_step"][-1]
        launched = {name: sorted({step.get(e, 0) for e in entries})
                    for name, entries in tally_of.items()}
        out[key] = {"arch": cfg.name, "tokens": [run["batch"], run["seq"]],
                    "predicted_peak_gib": pred,
                    "measured_peak_gib": measured["peak_gib"],
                    "peak_share": share, "memory": rec["memory"],
                    "kernel_calls": rec["kernel_calls"],
                    "launches_per_step": launched,
                    "dot_flops": rec["dot_flops"],
                    "bytes_accessed": rec["bytes_accessed"],
                    "trace_s": rec["trace_s"],
                    "seconds": time.perf_counter() - t1}
        print(json.dumps({f"dryrun {key}": out[key]}), flush=True)
        if share > DRYRUN_PEAK_SHARE:
            raise AssertionError(f"{key}: predicted peak {pred:.3f} GiB, "
                                 f"measured {measured['peak_gib']:.3f} "
                                 f"({share:.2%} apart)")
        want = {name: [n] for name, n in rec["kernel_calls"].items()}
        if set(rec["kernel_calls"]) != set(tally_of) or launched != want:
            raise AssertionError(f"{key}: the dry run counts "
                                 f"{rec['kernel_calls']} kernel calls a "
                                 f"step; the card launched {launched}")
    # phase 14 (a)'s gemma-2b decode: one token a step
    t1 = time.perf_counter()
    B, P, gen = (int(DECODE_ARGV[DECODE_ARGV.index(f) + 1])
                 for f in ("--batch", "--prompt-len", "--gen"))
    rec = evaluate(get_config("gemma-2b"), ShapeSpec(
        "phase-gemma-decode", P + gen, B, "decode"), (1, 1))
    pred = rec["memory"]["peak_bytes"] / 2 ** 30
    share = abs(pred - decode14["peak_gib"]) / decode14["peak_gib"]
    out["gemma_decode"] = {
        "arch": "gemma-2b", "batch": B, "cache_slots": P + gen,
        "predicted_peak_gib": pred, "measured_peak_gib": decode14["peak_gib"],
        "peak_share": share, "memory": rec["memory"],
        "kernel_calls": rec["kernel_calls"], "dot_flops": rec["dot_flops"],
        "bytes_accessed": rec["bytes_accessed"],
        "collectives": rec["collectives"], "trace_s": rec["trace_s"],
        "seconds": time.perf_counter() - t1}
    print(json.dumps({"dryrun gemma_decode": out["gemma_decode"]}),
          flush=True)
    if share > DRYRUN_PEAK_SHARE or rec["kernel_calls"]:
        raise AssertionError(f"gemma_decode: predicted peak {pred:.3f} GiB, "
                             f"measured {decode14['peak_gib']:.3f} "
                             f"({share:.2%} apart); kernel calls "
                             f"{rec['kernel_calls']}")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"dryrun": out}), flush=True)
    return out


def lm_mesh_phase(card):
    """Phase 19: the LM zoo's training path on a mesh (see the module
    docstring)."""
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import dist
    from repro_torch.models import lm
    from repro_torch.models.common import AxisEnv
    from repro_torch.optim import AdamWConfig, opt_state_decls
    t19 = time.perf_counter()
    row = {"card": card}
    # (a) a one-process NCCL world on a (1, 1) mesh against one card
    a = dist.launch(lm_mesh_rank, (1, 1), ("data", "model"), "qwen3-8b", 2,
                    2, 1024)[0]
    row["one_rank_mesh"] = {k: v for k, v in a.items() if k != "grads_equal"}
    row["one_rank_mesh"]["leaves_equal"] = sum(a["grads_equal"].values())
    row["one_rank_mesh"]["leaves"] = len(a["grads_equal"])
    if a["backend"] != "nccl" or not (a["params_equal"] and a["loss_equal"]
                                      and all(a["grads_equal"].values())):
        raise AssertionError(f"phase 19 (a): the (1, 1) mesh path is not "
                             f"the one-card path bit for bit: {a}")
    # (b) what a card holds at the production meshes, from the specs
    gb = 1e9
    row["per_card_gb"] = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for mesh, data, sizes in (
                ("16x16", ("data",), {"data": 16, "model": 16}),
                ("2x16x16", ("pod", "data"),
                 {"pod": 2, "data": 16, "model": 16})):
            ax = AxisEnv(data=data, model="model", sizes=sizes)
            decls = lm.model_decls(cfg, ax)
            p = dist.per_card_bytes(decls, ax, cfg.pdtype)
            st = dist.per_card_bytes(opt_state_decls(
                decls, AdamWConfig(state_dtype=cfg.opt_state_dtype)), ax,
                torch.float32)
            row["per_card_gb"][f"{arch}@{mesh}"] = {
                "params": p / gb, "grads": p / gb, "opt_state": st / gb,
                "opt_state_dtype": cfg.opt_state_dtype,
                "params_and_state_fit_80gb": p + st <= 80 * gb}
    row["seconds"] = time.perf_counter() - t19
    print(json.dumps({"lm_mesh": row}), flush=True)
    return row


def h100_system_phase(card):
    """Phase 18: DyPe on an H100 node (see the module docstring)."""
    import torch
    from repro_torch.core import (DATASETS, H100_DENSE, INTERCONNECTS,
                                  DynamicScheduler, PerfModel, gcn_workload,
                                  h100_system, paper_system,
                                  swa_transformer_workload)
    from repro_torch.kernels import (spmm_blocked_ell, spmm_csr_rows, swa,
                                     swa_attention, swa_attention_fma)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve_pipeline import serve
    from repro_torch.runtime import (AnalyticBackend,
                                     GroupedPipelineExecutor,
                                     TorchPipelineBackend)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {"card": card}
    t18 = time.perf_counter()

    # (a) the card's figures beside core/device.py's
    fig = {"memory_total_mib": float(smi("memory.total")),
           "device_py_mem_gb": H100_DENSE.mem_gb,
           "power_limit_w": float(smi("power.limit"))}
    fig["idle_w"], _ = power_under(None)
    oa = DATASETS["OA"]
    a = card_graph(oa, gen, dev)
    x = torch.randn((oa.vertices, oa.feature_len), generator=gen, device=dev)
    big = torch.randn((8192, 8192), generator=gen, device=dev)
    s_, w_ = SWA_T[-1]
    q, k, v = (torch.randn((1, 8, s_, 64), generator=gen, device=dev)
               for _ in range(3))
    loops = {"spmm": lambda: a @ x, "gemm": lambda: big @ big,
             "win_attn": lambda: swa_attention(q, k, v, window=w_,
                                               scale=0.125)}
    for kind, fn in loops.items():
        fig[f"{kind}_w"], fig[f"{kind}_samples"] = power_under(fn)
        fig[f"{kind}_above_idle_w"] = fig[f"{kind}_w"] - fig["idle_w"]
        fig[f"device_py_dyn_{kind}_w"] = H100_DENSE.dynamic(kind)
    src = torch.empty(COPY_BYTES // 4, device=dev)
    dst = torch.empty_like(src)
    host = torch.empty(COPY_BYTES // 4, pin_memory=True)
    ms = time_ms(lambda: dst.copy_(src), 10)
    fig["hbm_copy_gb_per_s"] = 2 * COPY_BYTES / ms / 1e6
    ms = time_ms(lambda: dst.copy_(host, non_blocking=True), 10)
    fig["h2d_pinned_gb_per_s"] = COPY_BYTES / ms / 1e6
    ms = time_ms(lambda: host.copy_(dst, non_blocking=True), 10)
    fig["d2h_pinned_gb_per_s"] = COPY_BYTES / ms / 1e6

    def copies():
        dst.copy_(host, non_blocking=True)
        host.copy_(dst, non_blocking=True)
    fig["transfer_w"], _ = power_under(copies)
    fig["transfer_above_idle_w"] = fig["transfer_w"] - fig["idle_w"]
    fig.update(device_py_static_w=H100_DENSE.static_power,
               device_py_transfer_w=H100_DENSE.transfer_power,
               device_py_link_bw_gb_per_s=H100_DENSE.link_bw,
               nvlink4_gb_per_s=H100_DENSE.link_bw
               * INTERCONNECTS["nvlink4"].scale)
    del a, x, big, q, k, v, src, dst, host
    torch.cuda.empty_cache()
    print(f"[h100] figures: {json.dumps(fig)}", flush=True)
    out["figures"] = fig

    # (b) the oracle against the card at DyPe's own kernel specs
    perf = PerfModel()
    rows = []
    spmm_csr_rows.launches = 0
    for name in GCN_SETS:
        ds = DATASETS[name]
        t0 = time.perf_counter()
        a = card_graph(ds, gen, dev)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        wl = gcn_workload(ds)
        x = torch.randn((ds.vertices, ds.feature_len), generator=gen,
                        device=dev)
        w = torch.randn((ds.feature_len, wl[1].N), generator=gen, device=dev)
        nnz = int(a.indices.numel())
        rows.append(oracle_row(f"{name} {wl[0].name}", wl[0],
                               time_ms(lambda: a @ x, 10), perf,
                               {"graph_nnz": nnz, "graph_build_s": built}))
        rows.append(oracle_row(f"{name} {wl[1].name}", wl[1],
                               time_ms(lambda: x @ w, 10), perf))
        del a, x, w
        torch.cuda.empty_cache()
    b1 = spmm_csr_rows.launches
    if swa._route(torch.float32, 64) != "fma":
        raise AssertionError("float32 D 64 is not routed to the FMA kernel")
    n0 = swa_attention_fma.launches
    for s_, w_ in SWA_T:
        kspec = swa_transformer_workload(s_, w_)[1]
        hd = kspec.d // kspec.heads
        q, k, v = (torch.randn((1, kspec.heads, s_, hd), generator=gen,
                               device=dev) for _ in range(3))
        rows.append(oracle_row(
            f"SWA-T-s{s_}-w{w_} {kspec.name}", kspec, time_ms(
                lambda: swa_attention(q, k, v, window=w_, scale=hd ** -0.5),
                10), perf))
        del q, k, v
    fma = swa_attention_fma.launches - n0
    out["oracle"] = rows
    out["oracle_launches"] = {"spmm_csr_rows": b1, "swa_attention_fma": fma}
    off = [r["spec"] for r in rows
           if not 1 / ORACLE_FACTOR <= r["oracle_over_card"] <= ORACLE_FACTOR]
    print(f"[h100] oracle vs card at {len(rows)} specs: oracle/card "
          f"{min(r['oracle_over_card'] for r in rows):.3f} to "
          f"{max(r['oracle_over_card'] for r in rows):.3f} (limit "
          f"{ORACLE_FACTOR}x); {b1} spmm_csr_rows and {fma} "
          f"swa_attention_fma launches", flush=True)
    if off or b1 != 11 * len(GCN_SETS) or fma != 11 * len(SWA_T):
        raise AssertionError(f"the H100 oracle is off by more than "
                             f"{ORACLE_FACTOR}x at {off}, or the specs did "
                             f"not run on B1 and B2 ({b1}, {fma} launches)")

    # (c) DyPe on the H100 node: serve_pipeline scheduled by h100_system
    def counted(**kw):
        spmm_csr_rows.launches = spmm_blocked_ell.launches = 0
        with torch.inference_mode():
            res = serve("OA", 8, device=dev, **kw)
        torch.cuda.synchronize()
        n = (spmm_csr_rows.launches, spmm_blocked_ell.launches)
        if n != (16, 0) or tuple(res.out.shape) != (8, 170_000, 128) \
                or not torch.isfinite(res.out).all() \
                or not res.max_err < GCN_MAX_ERR:
            raise AssertionError(f"serve {kw}: launches {n}, max err "
                                 f"{res.max_err}")
        return res

    res = counted(system=h100_system())
    ex, wl = res.executor, gcn_workload(DATASETS["OA"])
    kernel_ms, xs = [], res.micro[0]
    with torch.inference_mode():
        for st, fn in enumerate(ex.stage_fns):
            kernel_ms.append(time_ms(lambda: fn(ex.local[st], xs), 10))
            xs = fn(ex.local[st], xs)
    torch.cuda.synchronize()
    stages = []
    for s in res.plan.pipeline.stages:
        one = sum(perf.kernel_time(wl[i], s.dev, 1) for i in
                  range(s.i0, s.i1)) * 1e3
        stages.append({"kernels": [wl[i].name for i in range(s.i0, s.i1)],
                       "pool": s.dev.name, "n": s.n,
                       "predicted_exec_ms": s.t_exec * 1e3,
                       "predicted_one_card_ms": one,
                       "card_ms": sum(kernel_ms[s.i0:s.i1])})
        print(f"[h100] stage {stages[-1]['kernels']} on {s.n} "
              f"{s.dev.name}: DP {s.t_exec * 1e3:.4f} ms (one card "
              f"{one:.4f}), card {stages[-1]['card_ms']:.4f} ms (CUDA "
              f"events, one request)", flush=True)
    out["serve"] = {"schedule": res.schedule, "stages": stages,
                    "kernel_ms": kernel_ms, "seconds": res.seconds,
                    "inf_per_s": res.inf_per_s, "max_err": res.max_err,
                    "launches": 16}

    # (d) the mesh path on one card: four slots, every one cuda:0
    mesh = make_mesh((4,), ("stage",), devices=[dev] * 4)
    print(f"[mesh] a 4-slot mesh with every slot {dev} "
          f"({torch.cuda.get_device_name(0)}): the one card stands in for "
          f"four, so each handover is a same-card copy and no NVLink link "
          f"is used", flush=True)
    res_m = counted(system=h100_system(), mesh=mesh)
    same = torch.equal(res_m.out, res.out)
    print(f"[mesh] GCN through the mesh executor: 16 spmm_csr_rows "
          f"launches, output equal to the single-card executor's bit for "
          f"bit: {same}", flush=True)
    if not same or res_m.executor.stage_devices != (dev,) * 4:
        raise AssertionError("the one-card mesh's GCN differs from the "
                             "single-card executor's")
    del res, res_m, ex, xs
    torch.cuda.empty_cache()
    dyn = DynamicScheduler(paper_system("pcie4"), perf)
    sched = dyn.submit(wl)
    be = TorchPipelineBackend(mode="mesh", mesh=mesh, device=dev)
    h = be.prepare(sched, wl, epoch=dyn.epoch)
    sizes = tuple(s.n for s in sched.pipeline.stages)
    n_spmm = sum(k.kind == "spmm" for k in wl)
    spmm_csr_rows.launches = 0
    rep = be.execute(h, 3, 0.0)
    torch.cuda.synchronize()
    launched = spmm_csr_rows.launches
    ana = AnalyticBackend()
    want = ana.execute(ana.prepare(sched, wl), 3, 0.0)
    m3 = be._micro(3)
    chain = TorchPipelineBackend(mode="chain", device=dev).prepare(sched, wl)
    err = float((h.payload(m3) - chain.payload(m3)).abs().max())
    out["mesh_backend"] = {"schedule": sched.mnemonic, "group_sizes": sizes,
                           "launches": launched, "wall_s": rep.wall,
                           "finishes_equal": rep.finishes == want.finishes,
                           "vs_chain_max_abs_err": err}
    print(f"[mesh] TorchPipelineBackend(mode='mesh') on {sched.mnemonic} "
          f"(paper_system): {json.dumps(out['mesh_backend'])}", flush=True)
    if not isinstance(h.payload, GroupedPipelineExecutor) \
            or h.payload.group_sizes != sizes \
            or rep.finishes != want.finishes or launched != 3 * n_spmm \
            or not err <= PAYLOAD_TOL:
        raise AssertionError(f"the mesh backend: {out['mesh_backend']}")
    out["seconds"] = time.perf_counter() - t18
    print(json.dumps({"h100_system": out}), flush=True)
    return out


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

    # 16) the training path
    phase("16. main path: training qwen3-4b-swa4096 (lm_loss, AdamW, the "
          "train step) with B2 forward and its backward kernel")
    gc.collect()
    torch.cuda.empty_cache()
    tr = train_phase(gen, card, logs.get("swa_attention_bwd_wgmma", "")
                     + logs.get("swa_attention_bwd", ""))
    bwd, trl = tr["bwd"], tr["train"]["launches"]
    # B2's backward: no TPU kernel; the reference's gradient is XLA's
    # autodiff of the model zoo's banded attention. The wgmma route serves
    # the bf16 train step (phase 16 (c)); the FMA one the float32 copy
    # (phase 16 (b)), timed on the step's bf16 input as the comparison
    bwd_entries = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
        "replaces": "src/repro/kernels/swa.py:81",
        "gradient_of": "src/repro/models/attention.py:247",
        "launches": trl[name] if pre == "" else tr["fp32"]["launches"][name],
        "train_launches": trl[name],
        "max_abs_err": max(tr["bwd_max_abs_err"][route][g] for g in grads),
        "ms": bwd[f"{pre}{part}_ms"], "plain_ms": bwd[plain],
        "bound_ms": bwd[f"{part}_bound_ms"],
        "bound_by": bwd[f"{part}_bound_by"],
        "library_ms": bwd["library_ms"], "library": bwd["library"],
        "backward": {"ms": bwd[f"{pre}ms"], **{k: bwd[k] for k in (
            "plain_ms", "bound_ms", "bound_by", "library_ms")}}}
        for route, source, pre, names in (
            ("wgmma", "swa_attention_bwd_wgmma", "", swa.BWD_WGMMA_ENTRIES),
            ("fma", "swa_attention_bwd", "fma_", swa.BWD_ENTRIES))
        for name, part, grads, plain in zip(
            names, ("stats", "dkdv", "dq"),
            (("lse", "delta"), ("dk", "dv"), ("dq",)),
            ("stats_plain_ms", "plain_ms", "plain_ms"))]
    print(json.dumps({"train_phase": {k: tr[k] for k in
                                      ("fp32", "bf16", "e2e", "card")}}),
          flush=True)

    # 17) training mamba2-780m: B3's forward and its backward kernel
    phase("17. main path: training mamba2-780m (lm_loss, AdamW, the train "
          "step) with B3's forward and its backward kernel")
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    st = ssd_train_phase(gen, card, logs.get("ssd_chunk_bwd", "")
                         + logs.get("ssd_chunk_bwd_tc", ""))
    sbw, stl = st["path"], st["train"]["launches"]
    # B3's backward: no TPU kernel; the reference's gradient is XLA's
    # autodiff of the model zoo's ssd_chunked. The tensor-core route serves
    # the bf16 train step (phase 17 (c)) after bK1, which both routes
    # share; the FMA route's bK2 and bK3 the float32 copy (phase 17 (b)),
    # timed on the step's bf16 input as the comparison
    fp32_l = st["fp32"]["launches"]
    backward = {"ms": sbw["ms"], "fma_ms": sbw["fma_ms"],
                "plain_ms": sbw["plain_ms"], "bound_ms": sbw["bound_ms"],
                "bound_by": sbw["bound_by"],
                "max_abs_err": st["bwd_max_abs_err"],
                "fma_route_bf16_max_abs_err":
                    st["fma_route_bf16_max_abs_err"],
                "zamba2_shape_ms": st["zamba2"]["ms"],
                "zamba2_shape_fma_ms": st["zamba2"]["fma_ms"]}
    ssd_bwd_entries = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
        "replaces": "src/repro/kernels/ssd.py:74",
        "gradient_of": "src/repro/models/ssm.py:59",
        "launches": stl[name] if on_path else fp32_l[name],
        "train_launches": stl[name], "fp32_copy_launches": fp32_l[name],
        "max_abs_err": st["stage_max_abs_err"][name],
        "ms": (sbw["stage_ms"] if on_path else sbw["fma_stage_ms"])[name],
        "plain_ms": sbw["stage_plain_ms"][name],
        "bound_ms": sbw["stage_bound"][name]["bound_ms"],
        "bound_by": sbw["stage_bound"][name]["bound_by"],
        "library_ms": None,
        "zamba2_shape_ms": (st["zamba2"]["stage_ms"] if on_path
                            else st["zamba2"]["fma_stage_ms"])[name],
        "backward": backward}
        for source, names in (("ssd_chunk_bwd", ssd.BWD_ENTRIES),
                              ("ssd_chunk_bwd_tc", ssd.BWD_TC_ENTRIES))
        for name in names
        for on_path in [name in sbw["stage_ms"]]]
    print(json.dumps({"ssd_train_phase": {
        k: st[k] for k in ("fp32", "bf16", "zamba2_bf16", "card")},
        "seconds": time.perf_counter() - t17}), flush=True)

    # 18) DyPe on an H100 node: the system model and the mesh path
    phase("18. main path: DyPe on an H100 node, h100_system, the H100 "
          "oracle against the card, and the mesh path on one card")
    gc.collect()
    torch.cuda.empty_cache()
    h100_system_phase(card)

    # 19) the LM zoo's training path on a mesh, on the one card
    phase("19. main path: training the LM zoo on a (data, model) mesh "
          "(launch/dist.py, NCCL): a (1, 1) world against one card, and "
          "each arch's bytes a card at the production meshes")
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh_phase(card)

    # 20) the dry run against the card: predicted peaks and kernel calls
    phase("20. the dry run (launch/dryrun.py) against the card: phases 16 "
          "(c), 17 (c) and 14 (a)'s gemma-2b decode on meta tensors, peak "
          "memory and kernel calls")
    dryrun_phase(card, tr["train"], st["train"], decode_row["runs"]["gemma-2b"])

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
        "train_launches": trl["swa_attention_wgmma"],
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
        "train_calls": stl["ssd_chunked_tc"],
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
        "library_ms": None,
        "train_copy_launches": st["fp32"]["launches"]["ssd_chunked_fma"]}] \
        + bwd_entries + ssd_bwd_entries
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
