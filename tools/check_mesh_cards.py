#!/usr/bin/env python3
"""The pipeline's mesh mode across real cards: needs two or more CUDA
devices on one host (an H100 node over NVLink), and fails otherwise.

1. serve_pipeline's 2-layer GCN on ogbn-arxiv at full size, 8 requests,
   DyPe on ``h100_system()``, its four stages on cards 0..3 (or on the
   cards there are, round robin) against the same serve on one card:
   16 launches of the row-wise CSR SpMM kernel, the plain-path GCN within
   1e-3, and whether the two outputs are equal bit for bit;
2. ``TorchPipelineBackend(mode="auto")`` on the DP's OA schedule on the
   paper's system: with enough cards "auto" takes the mesh (the
   reference's rule), its finishes equal the analytic backend's and its
   output the one-card chain's within 1e-5;
3. peer access between card 0 and each other card, and the copy rate of
   512 MiB from card 0 to card 1 and back (CUDA events, mean of 10
   after one).

Prints one JSON line with the cards' name and power limit.

Run from the root of a checkout:  python3 tools/check_mesh_cards.py
"""
import json
import subprocess
import sys
from pathlib import Path

COPY_BYTES = 512 << 20
GCN_MAX_ERR = 1e-3
PAYLOAD_TOL = 1e-5


def copy_gb_per_s(dst, src, iters=10):
    import torch
    dst.copy_(src)
    for d in (dst.device, src.device):
        torch.cuda.synchronize(d)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(src.device):
        start.record()
        for _ in range(iters):
            dst.copy_(src)
        end.record()
    end.synchronize()
    return COPY_BYTES * iters / start.elapsed_time(end) / 1e6


def main():
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        sys.exit(f"check_mesh_cards: needs two or more CUDA devices, have {n}")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from repro_torch.core import (DATASETS, DynamicScheduler, PerfModel,
                                  gcn_workload, h100_system, paper_system)
    from repro_torch.kernels import spmm_csr_rows
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve_pipeline import serve
    from repro_torch.runtime import (AnalyticBackend,
                                     GroupedPipelineExecutor,
                                     TorchPipelineBackend)
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = [torch.device("cuda", i) for i in range(n)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    row = {"cards": smi}

    # 1) the GCN's four stages on four cards against one card
    mesh = make_mesh((4,), ("stage",), devices=[cards[i % n]
                                               for i in range(4)])
    runs = {}
    for name, kw in (("one_card", {}), ("mesh", {"mesh": mesh})):
        spmm_csr_rows.launches = 0
        with torch.inference_mode():
            res = serve("OA", 8, system=h100_system(), device=cards[0], **kw)
        for d in cards:
            torch.cuda.synchronize(d)
        runs[name] = res
        row[name] = {"launches": spmm_csr_rows.launches,
                     "max_err": res.max_err, "seconds": res.seconds,
                     "inf_per_s": res.inf_per_s,
                     "stage_devices": [str(d) for d in
                                       res.executor.stage_devices]}
        if spmm_csr_rows.launches != 16 or not res.max_err < GCN_MAX_ERR:
            raise AssertionError(f"{name}: {row[name]}")
    row["bit_for_bit"] = torch.equal(runs["mesh"].out, runs["one_card"].out)
    row["mesh_vs_one_card_max_abs_err"] = float(
        (runs["mesh"].out - runs["one_card"].out).abs().max())
    del runs, res

    # 2) "auto" on enough cards takes the mesh
    wl = gcn_workload(DATASETS["OA"])
    dyn = DynamicScheduler(paper_system("pcie4"), PerfModel())
    sched = dyn.submit(wl)
    be = TorchPipelineBackend(mode="auto", device=cards[0])
    h = be.prepare(sched, wl, epoch=dyn.epoch)
    rep = be.execute(h, 3, 0.0)
    ana = AnalyticBackend()
    want = ana.execute(ana.prepare(sched, wl), 3, 0.0)
    m3 = be._micro(3)
    chain = TorchPipelineBackend(mode="chain", device=cards[0]).prepare(
        sched, wl).payload
    got = h.payload(m3).to(cards[0])
    err = float((got - chain(m3)).abs().max())
    row["auto"] = {"schedule": sched.mnemonic,
                   "payload": type(h.payload).__name__,
                   "slots": [str(d) for d in h.payload.stage_devices],
                   "finishes_equal": rep.finishes == want.finishes,
                   "vs_chain_max_abs_err": err, "wall_s": rep.wall}
    if not isinstance(h.payload, GroupedPipelineExecutor) \
            or rep.finishes != want.finishes or not err <= PAYLOAD_TOL:
        raise AssertionError(f"auto mode: {row['auto']}")

    # 3) peer access and the card-to-card copy rate
    row["peer_access"] = {str(d): torch.cuda.can_device_access_peer(0, i)
                          for i, d in enumerate(cards) if i}
    a = torch.empty(COPY_BYTES // 4, device=cards[0])
    b = torch.empty(COPY_BYTES // 4, device=cards[1])
    row["copy_gb_per_s"] = {"cuda:0->cuda:1": copy_gb_per_s(b, a),
                            "cuda:1->cuda:0": copy_gb_per_s(a, b)}
    print(json.dumps({"mesh_cards": row}), flush=True)


if __name__ == "__main__":
    main()
