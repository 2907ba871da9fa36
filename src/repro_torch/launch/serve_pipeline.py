"""End-to-end driver: serve GCN inference through the inter-operator
pipeline runtime with a DYPE-chosen schedule (the port of
``examples/serve_pipeline.py``).

1. DYPE (``DynamicScheduler`` on the paper's 3x U280 + 2x MI210 system)
   schedules the GCN workload of a Table-I dataset from its data
   characteristics.
2. The 2-layer GCN (hidden 128) is deployed as a 4-stage pipeline
   SpMM1 | GeMM1+relu | SpMM2 | GeMM2, one CUDA stream per stage; the SpMM
   stages run the hand-written row-wise CSR kernel over the pre-loaded
   graph (an int32 CSR operand on the device).
3. A stream of ``--micro`` feature matrices (V, F) is served and checked
   against a plain-path GCN (CSR gather + ``index_add_``).
4. The data drifts (8x the edges on the same vertices) and DYPE reschedules.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_pipeline \
          --dataset OA --micro 8 [--scale 1.0] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..core import (DATASETS, DynamicScheduler, GraphDataset, PerfModel,
                    gcn_workload, paper_system)
from ..data import scaled_dataset, table1_graph
from ..device import resolve_device, synchronize
from ..kernels import CsrOperand
from ..models import init_gcn_params
from ..runtime import PipelineExecutor
from ..sparse import spmm_csr

HIDDEN = 128          # the paper's GCN width
SEED = 0              # graph, weights and requests
MAX_ERR = 1e-3        # pipeline vs plain-path GCN (examples/serve_pipeline.py)


@dataclasses.dataclass
class ServeResult:
    out: torch.Tensor           # (m, V, hidden) pipeline outputs
    micro: torch.Tensor         # (m, V, F) served feature matrices
    params: list                # GCN weights, [{"theta": (d_in, hidden)}]
    graph: object               # the CSR the operand was built from
    executor: PipelineExecutor  # the deployed pipeline, for further passes
    max_err: float              # vs the plain-path GCN
    seconds: float              # host clock around one pipeline call
    schedule: str               # DYPE mnemonic before drift
    rescheduled: str            # DYPE mnemonic after drift

    @property
    def inf_per_s(self) -> float:
        return self.out.shape[0] / self.seconds


def gcn_plain(params, graph, x: torch.Tensor) -> torch.Tensor:
    """The plain-path GCN the pipeline is checked against."""
    h = x
    for i, p in enumerate(params):
        h = spmm_csr(graph, h) @ p["theta"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def serve(dataset: str = "OA", n_micro: int = 8, *, scale: float = 1.0,
          device=None) -> ServeResult:
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = scaled_dataset(dataset, scale)
    F = ds.feature_len
    if F != HIDDEN:
        raise ValueError("the pipeline keeps one (V, F) activation shape; "
                         f"feature_len {F} != hidden {HIDDEN}")

    # 1) DYPE decides the stage partition from the data characteristics
    dyn = DynamicScheduler(paper_system("pcie4"), PerfModel(), mode="perf")
    wl = gcn_workload(ds, hidden=HIDDEN)
    schedule = dyn.submit(wl)
    print(f"[dype] schedule for {wl.name}: {schedule.mnemonic} "
          f"({len(schedule.pipeline.stages)} stages)")

    # 2) deploy: 2-layer GCN as a 4-stage pipeline
    #    (SpMM1 | GeMM1 | SpMM2 | GeMM2), one stream per stage
    graph = table1_graph(dataset, scale=scale, seed=SEED, device=dev)
    V = graph.shape[0]
    adj = CsrOperand.from_csr(graph, device=dev)
    print(f"[deploy] graph V={V} nnz={graph.nnz}; CSR operand "
          f"{adj.nbytes} bytes")
    params = init_gcn_params(F, HIDDEN, generator=torch.Generator()
                             .manual_seed(SEED), device=dev)
    w1, w2 = params[0]["theta"], params[1]["theta"]
    stacked = {"w": torch.stack([w1, w1, w2, w2])}  # spmm stages ignore theirs

    def spmm_stage(p, x):
        return adj @ x

    def gemm_relu_stage(p, x):
        return torch.relu(x @ p["w"])

    def gemm_stage(p, x):
        return x @ p["w"]

    fns = [spmm_stage, gemm_relu_stage, spmm_stage, gemm_stage]
    ex = PipelineExecutor(fns, stacked, (V, F), device=dev)

    # 3) serve a stream of batched requests
    gen = torch.Generator(device=dev).manual_seed(SEED)
    micro = torch.randn((n_micro, V, F), generator=gen, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    out = ex(micro)
    synchronize(dev)
    dt = time.perf_counter() - t0
    exp = torch.stack([gcn_plain(params, graph, micro[i])
                       for i in range(n_micro)])
    err = float((out - exp).abs().max())
    print(f"[serve] {n_micro} microbatches in {dt * 1e3:.1f} ms "
          f"({n_micro / dt:.1f} inf/s), pipeline vs plain-path GCN "
          f"max err {err:.2e}")
    if not err < MAX_ERR:
        raise AssertionError(f"pipeline disagrees with the plain path: "
                             f"{err} >= {MAX_ERR}")

    # 4) the data drifts (graph becomes denser) -> DYPE reschedules
    dense = GraphDataset(f"{ds.name}x8", ds.vertices, 8 * ds.edges, F)
    wl2 = gcn_workload(dense, hidden=HIDDEN)
    s2 = dyn.submit(wl2)
    print(f"[dype] drift: {wl.name} -> {wl2.name}: "
          f"{schedule.mnemonic} -> {s2.mnemonic}")
    return ServeResult(out, micro, params, graph, ex, err, dt,
                       schedule.mnemonic, s2.mnemonic)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the pipeline keeps one (V, F) activation shape, so F must be hidden
    ap.add_argument("--dataset", default="OA",
                    choices=sorted(k for k, d in DATASETS.items()
                                   if d.feature_len == HIDDEN))
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is no card)")
    args = ap.parse_args(argv)
    with torch.inference_mode():
        serve(args.dataset, args.micro, scale=args.scale, device=args.device)
    print("[done]")


if __name__ == "__main__":
    main()
