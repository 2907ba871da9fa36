#!/usr/bin/env python3
"""The LM zoo's training path on meshes of four cards (``launch/dist.py``:
one process a card, NCCL): needs four CUDA devices on one host (an H100
node over NVLink), and fails otherwise. (a), (b), (d) and (e) run on a
(2, 2) ("data", "model") mesh.

(a) qwen3-8b's 2-layer float32 copy at full width with ``fsdp=True``,
    4 x 2,048 tokens: ``lm_loss`` and every gradient on the mesh (the
    vocab-parallel loss: V 151,936 is even) against the same seeded
    copy on one card; the loss within 1e-5 relative and every gradient,
    gathered with ``gather_params``, within 1e-4 of its leaf's largest
    element;
(b) deepseek-v2-236b's float32 copy at full width with 2 layers (1 dense,
    1 MoE), capacity factor E/top_k so that no assignment is dropped on
    either side, 2 x 512 tokens: 80 experts on each model rank against
    all 160 on one card, the same bounds, under tests/test_torch_zoo.py's
    near-tie rule (the router's k-th and (k+1)-th probabilities of every
    token more than 256 float32 ulps apart, else the token is reported).
    The mesh's aux loss is each data shard's averaged, as the reference's
    ``pmean``, so the card runs each shard's rows in turn and averages the
    losses (with equal rows a shard, the cross entropy's global mean is
    the same average);
(c) qwen3-8b at full width and depth, bf16 parameters and float32 AdamW
    state, 3 steps of 8 x 4,096 tokens through ``launch/train.py``'s
    loop (``train_4k``'s 256 x 4,096 cut by batch to what four cards
    hold), on (2, 2) and on (4, 1) (FSDP over four data ranks, no model
    axis): ms a step, tok/s and each card's peak memory (one card cannot
    hold this model's parameters, gradients and AdamW state: 98.3 GB);
(d) mamba2-780m's 2-layer bf16 copy at full width, 4 x 2,048 tokens: the
    hand-written SSD scan (B3) forward and its tensor-core backward inside
    each rank on gathered leaves, against one card;
(e) qwen3-4b under ``long_500k`` (sliding-window attention, window
    4,096), its 2-layer bf16 copy at full width, 2 x 8,192 tokens: the
    hand-written SWA kernel (B2) forward and backward inside each rank,
    against one card.
    (d) and (e) hold the loss within 1e-3 relative and every gradient
    within 5e-2 of its leaf's largest (13 bfloat16 steps): bf16 products
    over half the rows a data rank, whose weight gradients the
    reduce-scatter sums in bf16, round differently from one card's, while
    a gradient summed over the wrong ranks or left unsummed is off by
    its own size; each rank's B3 or B2 launches in the mesh run are
    counted (``launch/train.py:COUNTERS``) and must not be 0.

Prints one JSON line with every card's name and power limit.

Run from the root of a checkout:  python3 tools/check_lm_mesh_cards.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

MESH = (2, 2)
# (loss relative, gradient share of its leaf's largest) by dtype
BOUNDS = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}
TIE_ULPS = 256
# name: the copy, its tokens, and the kernel entries each rank must launch
# on the mesh
CASES = {
    "qwen3-8b": {"arch": "qwen3-8b", "layers": 2, "batch": 4, "seq": 2048},
    "deepseek-v2-236b": {"arch": "deepseek-v2-236b", "layers": 2,
                         "batch": 2, "seq": 512},
    "mamba2-780m-bf16": {"arch": "mamba2-780m", "layers": 2, "batch": 4,
                         "seq": 2048, "dtype": "bfloat16",
                         "kernels": ("ssd_chunked_tc",
                                     "ssd_chunk_bwd_tc_head")},
    "qwen3-4b-swa4096-bf16": {"arch": "qwen3-4b", "shape": "long_500k",
                              "layers": 2, "batch": 2, "seq": 8192,
                              "dtype": "bfloat16",
                              "kernels": ("swa_attention_wgmma",
                                          "swa_attention_bwd_wgmma_dq")}}
TRAIN = {"arch": "qwen3-8b", "steps": 3, "batch": 8, "seq": 4096,
         "meshes": ((2, 2), (4, 1))}


def _copy(case):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import effective_config
    cfg = get_config(case["arch"])
    if "shape" in case:
        cfg = effective_config(cfg, SHAPES[case["shape"]])
    dt = case.get("dtype", "float32")
    kw = {"n_layers": case["layers"], "param_dtype": dt,
          "compute_dtype": dt, "fsdp": True}
    if cfg.n_experts:
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    return cfg.replace(**kw)


def _launches(before):
    from repro_torch.launch.train import COUNTERS
    return {f.__name__: f.launches - n for f, n in zip(COUNTERS, before)
            if f.launches != n}


def _counts():
    from repro_torch.launch.train import COUNTERS
    return [f.launches for f in COUNTERS]


def _loss_and_grads(cfg, params, parts, mesh=None):
    """The mean of ``lm_loss`` over the batches ``parts`` and its
    gradients."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    for _, t in tree_leaves(params):
        t.requires_grad_(True)
        t.grad = None
    loss = 0
    for b in parts:
        part = lm.lm_loss(params, b, cfg, mesh=mesh) / len(parts)
        part.backward()
        loss = loss + part.detach()
    return loss, tree_map(lambda t: t.grad, params)


def parity_rank(pm, case):
    """(a), (b), (d), (e) on one rank: the mesh's loss and gathered
    gradients (moved to the host) and its kernel launches, then on rank 0
    the one-card run, compared leaf by leaf."""
    import torch
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import dist
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import init_params, tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = pm.device
    cfg = _copy(case)
    batch, seq = case["batch"], case["seq"]
    b = {k: torch.from_numpy(v).to(dev) for k, v in
         synthetic_batch(0, batch, seq, cfg.vocab_size).items()}
    margins, route = [], moe_mod.route

    def recording(xf, router_w, c):
        probs, gates, ids = route(xf, router_w, c)
        p = probs.detach().sort(dim=-1, descending=True).values
        pk, pk1 = p[:, c.top_k - 1], p[:, c.top_k]
        ulp = torch.exp2(torch.floor(torch.log2(pk)) - 23)   # float32's
        ulps = ((pk - pk1) / ulp).cpu().numpy()
        margins.append((float(ulps.min()), int((ulps <= TIE_ULPS).sum())))
        return probs, gates, ids

    def counting(self, x, axis):
        pmax_calls.append(axis)
        return pmax(self, x, axis)

    pmax_calls, pmax = [], dist.ProcessMesh.pmax
    moe_mod.route, dist.ProcessMesh.pmax = recording, counting
    gen = torch.Generator(device=dev).manual_seed(30)
    shards = dist.shard_init(lm.model_decls(cfg, pm.ax), gen, dev,
                             cfg.pdtype, pm.ax, pm.coords)
    torch.cuda.synchronize(dev)
    t0, before = time.perf_counter(), _counts()
    loss, grads = _loss_and_grads(cfg, shards, [b], pm)
    torch.cuda.synchronize(dev)
    out = {**case, "tokens": [batch, seq], "launches": _launches(before),
           "mesh_fwd_bwd_s": time.perf_counter() - t0,
           "loss": float(loss),
           "router_margin_ulps_min": min((m for m, _ in margins),
                                         default=None),
           "tied_tokens": sum(n for _, n in margins),
           "vp_active": bool(pmax_calls),
           "mesh_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    full = {p: t.cpu() for p, t in
            tree_leaves(lm.gather_params(grads, cfg, pm))}
    del shards, grads
    torch.cuda.empty_cache()
    if pm.rank != 0:
        return out
    moe_mod.route, dist.ProcessMesh.pmax = route, pmax
    gen.manual_seed(30)
    params = init_params(lm.model_decls(cfg), gen, dev, cfg.pdtype)
    # the aux loss on a mesh is each data shard's, averaged (the
    # reference's pmean): one card takes the shards' rows in turn
    dp = pm.size("data") if cfg.n_experts else 1
    parts = [{k: v[i * batch // dp:(i + 1) * batch // dp]
              for k, v in b.items()} for i in range(dp)]
    t0, before = time.perf_counter(), _counts()
    one_loss, one_grads = _loss_and_grads(cfg, params, parts)
    torch.cuda.synchronize(dev)
    out["one_card_fwd_bwd_s"] = time.perf_counter() - t0
    out["one_card_launches"] = _launches(before)
    out["one_card_loss"] = float(one_loss)
    worst = {}
    for p, g in tree_leaves(one_grads):
        g = g.cpu()
        worst[p] = float((full[p] - g).abs().max() / g.abs().max())
    out["loss_rel_err"] = abs(out["loss"] - out["one_card_loss"]) / abs(
        out["one_card_loss"])
    out["worst_grad_share"] = max(worst.values())
    out["worst_grad_leaf"] = max(worst, key=worst.get)
    loss_rtol, grad_share = BOUNDS[case.get("dtype", "float32")]
    out["within_bounds"] = bool(out["loss_rel_err"] <= loss_rtol
                                and out["worst_grad_share"] <= grad_share)
    out["one_card_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def train_rank(pm, arch, steps, batch, seq):
    """(c): the train loop on one rank of a mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    dev = pm.device
    torch.cuda.reset_peak_memory_stats(dev)
    res = train(get_config(arch), steps=steps, batch=batch, seq=seq,
                mesh=pm)
    s = [res.seconds[k] for k in sorted(res.seconds)]
    return {"rank": pm.rank, "device": str(dev), "coords": pm.coords,
            "step_s": s,
            "losses": [res.losses[k] for k in sorted(res.losses)],
            "grad_norms": [res.grad_norms[k] for k in sorted(res.grad_norms)],
            "tok_per_s": res.tokens_per_step / s[-1],
            "launches_last_step": res.launches[max(res.launches)],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def main():
    import math
    import torch
    from repro_torch.kernels._build import build_all
    from repro_torch.launch import dist
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 4:
        sys.exit(f"check_lm_mesh_cards: needs four CUDA devices, have {n}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    row = {"cards": smi, "mesh": list(MESH)}
    build_all()                 # once, before the ranks load the kernels
    for name, case in CASES.items():
        t0 = time.perf_counter()
        ranks = dist.launch(parity_rank, MESH, ("data", "model"), case)
        res = ranks[0]
        for k in ("loss", "mesh_peak_gib", "tied_tokens", "launches"):
            res[f"rank_{k}"] = [r[k] for r in ranks]
        # every rank launched each named kernel on the mesh
        ran = all(r["launches"].get(k, 0) > 0 for r in ranks
                  for k in case.get("kernels", ()))
        # a near-tie may go either way: the gradients are held only
        # without one
        res["ok"] = (res["within_bounds"] and res["vp_active"] and ran
                     and not any(res["rank_tied_tokens"]))
        res["wall_s"] = time.perf_counter() - t0
        row[name] = res
        print(json.dumps({name: res}), flush=True)
    row["train"] = []
    for mesh in TRAIN["meshes"]:
        t0 = time.perf_counter()
        ranks = dist.launch(train_rank, mesh, ("data", "model"),
                            TRAIN["arch"], TRAIN["steps"], TRAIN["batch"],
                            TRAIN["seq"])
        row["train"].append({**TRAIN, "mesh": list(mesh), "ranks": ranks,
                             "wall_s": time.perf_counter() - t0})
        print(json.dumps({"train": row["train"][-1]}), flush=True)
    print(json.dumps({"lm_mesh_cards": row}), flush=True)
    bad = [a for a in CASES if not row[a]["ok"]]
    ranks = [r for t in row["train"] for r in t["ranks"]]
    if bad or not all(math.isfinite(l) for r in ranks for l in r["losses"]) \
            or max(r["peak_gib"] for r in ranks) >= 80 \
            or not all(r["step_s"] for r in ranks):
        sys.exit(f"check_lm_mesh_cards: failed: {bad or 'train'}")


if __name__ == "__main__":
    main()
