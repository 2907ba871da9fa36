"""H100 roofline of the dry run's records (``launch/dryrun.py``).

For each cell, per card:

  compute term    = dot_flops / BF16_FLOP_PER_S
  memory term     = bytes_accessed / HBM_BYTES_PER_S
  collective term = sum over the groups of (collective bytes / the
                    group's link rate)

The figures are the H100 SXM data sheet's (the ones ``chip_smoke.py``'s
bounds use): 989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM3. A group
inside one node of ``NODE_CARDS`` cards is priced at NVLink4's 450e9 B/s
each way (data sheet; ``core/device.py``'s ``"nvlink4"``; a card-to-card
copy measured 393.4e9 B/s on NVIDIA H100 80GB HBM3 at 700 W,
``tools/check_mesh_cards.py``). A group that spans nodes is priced at one
400 Gb/s NIC a card, 50e9 B/s: a data-sheet assumption, not a
measurement. Ranks lie on the mesh in row-major order (``model``
fastest), eight to a node, so on (16, 16) and (2, 16, 16) the 16 ranks of
a ``model`` group span two nodes and the ranks of a data group one node
each: every group of the production meshes crosses nodes.

``bytes_accessed`` is eager, op by op, with no fusion, so the memory term
is an upper bound of the step as the port runs it now.

``model_flops`` is 6 (train) or 2 (prefill, decode) x the active
parameters x the tokens a card, the parameters counted from
``lm.model_decls`` (a routed expert counts top_k / n_experts of itself).

  PYTHONPATH=src python -m repro_torch.launch.roofline [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.roofline --markdown

``--markdown`` prints one table row a (arch, shape) cell, each number as
"(16, 16) / (2, 16, 16)": status, the argument, temp and peak GB a card,
``dot_flops``, the all-gather, all-reduce and reduce-scatter GB, the trace
seconds and the three terms.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .dryrun import RESULTS

BF16_FLOP_PER_S = 989e12        # H100 SXM data sheet, dense bf16
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
NVLINK_BYTES_PER_S = 450e9      # H100 SXM data sheet, NVLink4 each way
NIC_BYTES_PER_S = 400e9 / 8     # one 400 Gb/s NIC a card (assumption)
NODE_CARDS = 8


def group_ranks(mesh_shape, axes, axis: str, rank: int) -> list:
    """The ranks of ``rank``'s ``"model"`` or ``"data"`` group (every axis
    but ``model``), as ``launch/dist.py:process_mesh`` forms them."""
    ranks = np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape)
    mi = list(axes).index("model")
    rows = np.moveaxis(ranks, mi, -1).reshape(-1, mesh_shape[mi])
    for row in (rows if axis == "model" else rows.T):
        if rank in row:
            return [int(r) for r in row]
    raise ValueError(f"rank {rank} not on the mesh")


def crosses_nodes(ranks) -> bool:
    return len({r // NODE_CARDS for r in ranks}) > 1


def link_rate(mesh_shape, axes, axis: str, rank: int) -> float:
    return (NIC_BYTES_PER_S if crosses_nodes(
        group_ranks(mesh_shape, axes, axis, rank)) else NVLINK_BYTES_PER_S)


def active_params(cfg) -> float:
    """Parameters a token meets: the routed experts at top_k / E."""
    from ..models.common import tree_leaves
    from ..models.lm import model_decls
    total = 0.0
    for path, d in tree_leaves(model_decls(cfg)):
        n = float(np.prod(d.shape))
        if "['moe_layers']['ffn']" in path and path.endswith(
                ("['wi']", "['wo']")):
            n *= cfg.top_k / cfg.n_experts
        total += n
    return total


def model_flops(arch: str, shape_name: str, n_devices: int) -> float:
    from ..configs import SHAPES, get_config
    from .steps import effective_config
    shape = SHAPES[shape_name]
    cfg = effective_config(get_config(arch), shape)
    n = active_params(cfg)
    if shape.step == "decode":
        return 2.0 * n * shape.global_batch / n_devices
    factor = 6.0 if shape.step == "train" else 2.0
    return factor * n * shape.global_batch * shape.seq_len / n_devices


def analyse_cell(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    mesh_shape = tuple(int(n) for n in rec["mesh"].split("x"))
    axes = tuple(rec["coords"])
    t_c = rec["dot_flops"] / BF16_FLOP_PER_S
    t_m = rec["bytes_accessed"] / HBM_BYTES_PER_S
    by_axis = {}
    for axis, kinds in rec.get("collectives_by_axis", {}).items():
        nbytes = sum(v["bytes"] for v in kinds.values())
        rate = link_rate(mesh_shape, axes, axis, rec["rank"])
        by_axis[axis] = {"bytes": nbytes, "rate": rate,
                         "crosses_nodes": rate == NIC_BYTES_PER_S,
                         "seconds": nbytes / rate}
    t_n = sum(v["seconds"] for v in by_axis.values())
    mf = model_flops(rec["arch"], rec["shape"], rec["n_devices"])
    total = max(t_c, t_m, t_n)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "collective_by_axis": by_axis,
        "dominant": max((t_c, "compute"), (t_m, "memory"),
                        (t_n, "collective"))[1],
        "model_flops": mf, "dot_flops": rec["dot_flops"],
        "useful_ratio": mf / rec["dot_flops"] if rec["dot_flops"] else 0.0,
        "roofline_fraction": (mf / BF16_FLOP_PER_S) / total if total
        else 0.0,
        "bound_time_s": total,
    }


def load_cells(multi_pod: bool = False) -> list:
    out = []
    for p in sorted(RESULTS.glob("*__*.json")):
        rec = json.loads(p.read_text())
        if rec.get("multi_pod") != multi_pod:
            continue
        cell = analyse_cell(rec)
        if cell:
            out.append(cell)
    return out


def markdown() -> list:
    """The rows of PERF.md's dry-run table from the records."""
    from ..configs import ARCHS, SHAPES
    from .dryrun import _cell_path

    def both(recs, fn, fmt):
        vals = [fn(r) for r in recs]
        return " / ".join("-" if v is None else format(v, fmt)
                          for v in vals)

    gb = 1e9
    rows = ["| cell | status | args GB | temp GB | peak GB | dot_flops | "
            "all-gather GB | all-reduce GB | reduce-scatter GB | trace s | "
            "compute s | memory s | collective s |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in SHAPES:
            recs = [json.loads(_cell_path(arch, shape, mp).read_text())
                    for mp in (False, True)]
            terms = [analyse_cell(r) for r in recs]
            status = "/".join(sorted({r["status"] for r in recs}))
            mem = lambda k: (lambda r: r.get("memory", {}).get(k) / gb  # noqa
                             if r.get("memory", {}).get(k) is not None
                             else None)
            coll = lambda k: (lambda r: r["collectives"][k]["bytes"] / gb  # noqa
                              if "collectives" in r else None)
            term = lambda k: (lambda t: t[k] if t else None)  # noqa: E731
            rows.append(" | ".join([
                f"| {arch} {shape}", status,
                both(recs, mem("argument_bytes"), ".3f"),
                both(recs, mem("temp_bytes"), ".2f"),
                both(recs, mem("peak_bytes"), ".2f"),
                both(recs, lambda r: r.get("dot_flops"), ".3e"),
                both(recs, coll("all-gather"), ".3f"),
                both(recs, coll("all-reduce"), ".3f"),
                both(recs, coll("reduce-scatter"), ".3f"),
                both(recs, lambda r: r.get("trace_s"), ".1f"),
                both(terms, term("compute_s"), ".3f"),
                both(terms, term("memory_s"), ".2f"),
                both(terms, term("collective_s"), ".3f")]) + " |")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    if args.markdown:
        print("\n".join(markdown()))
        return None
    cells = sorted(load_cells(args.multi_pod),
                   key=lambda c: (c["arch"], c["shape"]))
    name = "roofline_mp.json" if args.multi_pod else "roofline.json"
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / name).write_text(json.dumps(cells, indent=1))
    print(f"ROOFLINE on H100 figures, "
          f"{'2x16x16' if args.multi_pod else '16x16'}, per card (s)")
    print(f"{'arch':24s} {'shape':12s} {'compute':>9s} {'memory':>9s} "
          f"{'collect.':>9s} {'dominant':>10s} {'useful':>7s}")
    for c in cells:
        print(f"{c['arch']:24s} {c['shape']:12s} {c['compute_s']:9.3f} "
              f"{c['memory_s']:9.3f} {c['collective_s']:9.3f} "
              f"{c['dominant']:>10s} {c['useful_ratio']:7.3f}")
    return cells


if __name__ == "__main__":
    main()
