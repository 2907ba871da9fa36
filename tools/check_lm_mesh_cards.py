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
    counted (``launch/train.py:COUNTERS``) and must not be 0;
(f) the sharded checkpoint: qwen3-8b's 2-layer bf16 copy at full width
    with int8 AdamW moments trains 3 steps of 4 x 2,048 tokens through
    ``launch/train.py``'s loop on (2, 2), checkpointing at step 2 (every
    rank gathers each leaf, rank 0 writes); the checkpoint then restores
    on (4, 1) and on one card through the same loop, and each restored
    leaf (gathered over its mesh) equals its file leaf for leaf, the int8
    codes and scales included; the files are removed after.

(g) the sharded decode (``lm.decode_step(mesh=)``) on (2, 2) against one
    card, the 2-layer copies at full width with ``fsdp=True``: qwen3-8b
    and deepseek-v2-236b (capacity factor E/top_k) in float32 and
    mamba2-780m in bf16, 4 sequences of 64 prompt tokens then 32 greedy
    ones against caches of 96 slots; qwen3-4b under ``long_500k`` in
    float32 at B 1, its 4,096-slot ring seeded with random keys and values,
    16 steps from position 4,088 across the ring's wrap (the slots cut
    over data, D over model). The mesh decodes greedily; one card is fed
    the tokens the mesh fed and its logits of every step are held as (a)
    and (b) hold a gradient (float32: within 1e-4 of the largest logit;
    bf16: 5e-2), its greedy token equal to the mesh's wherever its two
    largest logits lie further apart than the near-tie margin
    (``TIE_ULPS`` float32 ulps of the largest; in bf16, 4 bf16 ulps);
(h) qwen3-8b in bf16 at full depth, 32 sequences against caches of 32,768
    slots seeded with random contents, 16 greedy steps from position
    32,752, on (2, 2) and on (4, 1): ms a step, tok/s and each card's peak
    (one card cannot hold the 154.6 GB of caches beside 16.4 GB of
    weights); no tokens compared.

(a)-(e) and (g) run with the layers' products split over ``model``
(tensor parallelism, ``models/tp.py``) wherever heads, KV heads, d_ff or
SSM heads divide at tp 2, as they do for every copy here.

Prints one JSON line with every card's name and power limit.

Run from the root of a checkout:  python3 tools/check_lm_mesh_cards.py
"""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

MESH = (2, 2)
# (loss relative, gradient share of its leaf's largest) by dtype
BOUNDS = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}
TIE_ULPS = 256
# (g): each step's logits within this share of the largest one-card logit;
# a greedy token may differ where the one card's two largest logits lie
# within the margin: (the dtype's mantissa bits, ulps of the largest)
DECODE_BOUNDS = {"float32": 1e-4, "bfloat16": 5e-2}
DECODE_TIES = {"float32": (23, TIE_ULPS), "bfloat16": (7, 4)}
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
CKPT = {"arch": "qwen3-8b", "layers": 2, "opt_state_dtype": "int8",
        "steps": 3, "every": 2, "batch": 4, "seq": 2048,
        "dir": Path(__file__).resolve().parent.parent / "build"
        / "check_lm_mesh_ckpt"}


# (g): the decode copies, (prompt, generated) tokens a sequence, or a
# seeded ring and the position its steps start from
DECODE_CASES = {
    "qwen3-8b-decode": {"arch": "qwen3-8b", "layers": 2, "batch": 4,
                        "prompt": 64, "gen": 32},
    "deepseek-v2-236b-decode": {"arch": "deepseek-v2-236b", "layers": 2,
                                "batch": 4, "prompt": 64, "gen": 32},
    "mamba2-780m-decode-bf16": {"arch": "mamba2-780m", "layers": 2,
                                "batch": 4, "prompt": 64, "gen": 32,
                                "dtype": "bfloat16"},
    "qwen3-4b-swa4096-decode": {"arch": "qwen3-4b", "shape": "long_500k",
                                "layers": 2, "batch": 1, "start": 4088,
                                "steps": 16}}
SERVE = {"arch": "qwen3-8b", "batch": 32, "slots": 32768, "start": 32752,
         "steps": 16, "meshes": ((2, 2), (4, 1))}


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


def _seeded_cache(cfg, batch, slots, pm, seed):
    """Caches of ``slots`` positions in the specs of the decode on ``pm``
    (the rank's shards; every rank of a one-rank mesh holds all), every
    leaf drawn whole from a seeded generator on the card and cut, so that
    any mesh holds the same contents."""
    import torch
    from repro_torch.launch.dist import shard
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    gen = torch.Generator(device=pm.device).manual_seed(seed)
    specs = lm.cache_specs(cfg, batch, slots, pm.ax)

    def one(t, spec):
        full = torch.randn(t.shape, generator=gen, device=pm.device).to(
            t.dtype)
        return shard(full, spec, pm.ax, pm.coords).clone()
    return tree_map(one, lm.cache_shapes(cfg, batch, slots), specs)


def _decode_loop(cfg, params, fed, start, cache, gen, slots, mesh=None):
    """Decode from position ``start``: ``fed`` (B, n) tokens fed first
    (teacher-forced), then ``gen`` greedy ones. Returns (the (B, n + gen
    - 1) tokens fed after the first, each step's float32 logits of all
    rows (gathered over data) on the host, each step's seconds)."""
    import torch
    from repro_torch.models import lm
    B, n = fed.shape
    tok, toks, logits, secs = fed[:, :1], [], [], []
    with torch.inference_mode():
        for i in range(n + gen - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = lm.decode_step(params, tok, start + i, cache, cfg,
                                       mesh=mesh, seq_len=slots)
            if mesh is not None and mesh.for_batch(B).split_data:
                lg = mesh.all_gather(lg, "data", 0)
            lg = lg[:, 0]
            nxt = lg.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            logits.append(lg.cpu())
            tok = fed[:, i + 1:i + 2] if i + 1 < n else nxt
            toks.append(tok)
    return torch.cat(toks, 1), torch.stack(logits, 1), secs


def decode_rank(pm, case):
    """(g) on one rank: the mesh's greedy decode, then on rank 0 the same
    tokens through one card, logits held step by step."""
    import torch
    from repro_torch.launch import dist
    from repro_torch.launch.steps import init_cache_shards
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = pm.device
    cfg = _copy(case)
    B = case["batch"]
    ring = "start" in case
    start = case.get("start", 0)
    gen_n = case["steps"] - 1 if ring else case["gen"]
    n = 1 if ring else case["prompt"]
    slots = start + case["steps"] if ring else n + gen_n
    g = torch.Generator(device=dev).manual_seed(31)
    fed = torch.randint(0, cfg.vocab_size, (B, n), generator=g, device=dev,
                        dtype=torch.int32)
    g.manual_seed(30)
    shards = dist.shard_init(lm.model_decls(cfg, pm.ax), g, dev, cfg.pdtype,
                             pm.ax, pm.coords)
    cache = (_seeded_cache(cfg, B, slots, pm, 32) if ring
             else init_cache_shards(cfg, B, slots, pm))
    t0 = time.perf_counter()
    toks, mesh_logits, secs = _decode_loop(cfg, shards, fed, start, cache,
                                           gen_n, slots, pm)
    out = {**case, "mesh_decode_s": time.perf_counter() - t0,
           "mesh_ms_per_step": 1e3 * sum(secs[1:]) / max(len(secs) - 1, 1),
           "mesh_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    del shards, cache
    torch.cuda.empty_cache()
    if pm.rank != 0:
        return out
    g.manual_seed(30)
    params = init_params(lm.model_decls(cfg), g, dev, cfg.pdtype)
    cache = (_seeded_cache(cfg, B, slots, _OneCard(dev), 32) if ring
             else lm.init_cache(cfg, B, slots, device=dev))
    every = torch.cat([fed[:, :1], toks], 1)
    _, card_logits, _ = _decode_loop(cfg, params, every, start, cache, 0,
                                     slots)
    bound = DECODE_BOUNDS[case.get("dtype", "float32")]
    top = card_logits.abs().max()
    err = float((mesh_logits - card_logits).abs().max() / top)
    two = card_logits.topk(2, dim=-1).values
    bits, ulps = DECODE_TIES[case.get("dtype", "float32")]
    ulp = torch.exp2(torch.floor(torch.log2(two[..., 0].abs())) - bits)
    far = two[..., 0] - two[..., 1] > ulps * ulp
    same = mesh_logits.argmax(-1) == card_logits.argmax(-1)
    out.update(logit_share=err, bound=bound, decode_steps=len(secs),
               tokens_compared=int(far.sum()),
               tokens_differing_far=int((~same & far).sum()),
               near_ties=int((~far).sum()),
               within_bounds=bool(err <= bound and bool(same[far].all())),
               one_card_peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return out


class _OneCard:
    """The view ``_seeded_cache`` reads of one card: no axis cut."""

    def __init__(self, dev):
        from repro_torch.models.common import CPU_AXES
        self.device, self.ax, self.coords = dev, CPU_AXES, {}


def serve_rank(pm, arch, batch, slots, start, steps):
    """(h) on one rank: the full-depth bf16 model's decode steps against
    seeded caches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dist
    from repro_torch.launch.steps import init_cache_shards
    from repro_torch.models import lm
    dev = pm.device
    cfg = get_config(arch)
    g = torch.Generator(device=dev).manual_seed(33)
    params = dist.shard_init(lm.model_decls(cfg, pm.ax), g, dev, cfg.pdtype,
                             pm.ax, pm.coords)
    # each rank seeds its own shards (a whole leaf would not fit a card)
    cache = init_cache_shards(cfg, batch, slots, pm)
    for t in _leaves(cache):
        t.normal_(generator=g)
    fed = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                        device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats(dev)
    toks, logits, secs = _decode_loop(cfg, params, fed, start, cache,
                                      steps, slots, pm)
    ms = [1e3 * t for t in secs]
    return {"rank": pm.rank, "device": str(dev), "coords": pm.coords,
            "step_ms": ms, "ms_per_step": sum(ms[1:]) / (len(ms) - 1),
            "tok_per_s": batch * (len(ms) - 1) / sum(secs[1:]),
            "finite": bool(torch.isfinite(logits).all()),
            "cache_gb_a_card": sum(t.numel() * t.element_size() for t in
                                   _leaves(cache)) / 1e9,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return [t for _, t in tree_leaves(tree)]


def _ckpt_copy():
    from repro_torch.configs import get_config
    return get_config(CKPT["arch"]).replace(
        n_layers=CKPT["layers"], opt_state_dtype=CKPT["opt_state_dtype"],
        fsdp=True)


def ckpt_rank(pm, restore):
    """(f) on one rank: train the copy with checkpoints (``restore``
    False), or restore the newest checkpoint through the same loop (no
    step left to run) and hold each leaf, gathered over this mesh, to its
    file on rank 0."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import gathered_leaves
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.models.common import param_specs
    from repro_torch.optim import AdamWConfig, opt_state_decls
    cfg = _ckpt_copy()
    steps = CKPT["steps"] if not restore else CKPT["every"] + 1
    t0 = time.perf_counter()
    res = train(cfg, steps=steps, batch=CKPT["batch"], seq=CKPT["seq"],
                ckpt_dir=CKPT["dir"], ckpt_every=CKPT["every"], mesh=pm)
    torch.cuda.synchronize(pm.device)
    out = {"rank": pm.rank, "start": res.start, "losses": res.losses,
           "train_s": time.perf_counter() - t0}
    if not restore:
        return out
    decls = lm.model_decls(cfg, pm.ax)
    specs = {"opt": param_specs(opt_state_decls(decls, AdamWConfig(
        state_dtype=cfg.opt_state_dtype))), "params": param_specs(decls),
        "step": ()}
    step_dir = CKPT["dir"] / f"step_{CKPT['every']:08d}"
    equal, n = True, 0
    for i, (path, leaf) in enumerate(gathered_leaves(
            {"opt": res.opt, "params": res.params, "step": 0}, specs, pm)):
        if pm.rank == 0 and isinstance(leaf, torch.Tensor):
            got = (leaf.float() if leaf.dtype == torch.bfloat16
                   else leaf).cpu().numpy()
            equal &= bool(np.array_equal(got, np.load(step_dir /
                                                      f"arr_{i}.npy")))
            n += 1
        del leaf
    out.update(leaves=n, leaves_equal=equal)
    return out


def one_card_restore():
    """(f) on one card: the newest checkpoint through ``train`` on
    cuda:0, each leaf against its file."""
    import numpy as np
    import torch
    from repro_torch.launch.train import train
    from repro_torch.models.common import tree_leaves
    cfg = _ckpt_copy()
    res = train(cfg, steps=CKPT["every"] + 1, batch=CKPT["batch"],
                seq=CKPT["seq"], ckpt_dir=CKPT["dir"], device="cuda:0")
    step_dir = CKPT["dir"] / f"step_{CKPT['every']:08d}"
    leaves = list(tree_leaves({"opt": res.opt, "params": res.params,
                               "step": 0}))[:-1]
    equal = all(np.array_equal(
        (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy(),
        np.load(step_dir / f"arr_{i}.npy"))
        for i, (_, t) in enumerate(leaves))
    out = {"start": res.start, "leaves": len(leaves), "leaves_equal": equal}
    del res, leaves
    torch.cuda.empty_cache()
    return out


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
    bad = []
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
        bad += [] if res["ok"] else [name]
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
    ranks = [r for t in row["train"] for r in t["ranks"]]
    if not all(math.isfinite(l) for r in ranks for l in r["losses"]) \
            or any(r["peak_gib"] >= 80 or not r["step_s"] for r in ranks):
        bad.append("train")
    # (f): save on (2, 2), restore on (4, 1) and on one card
    t0 = time.perf_counter()
    shutil.rmtree(CKPT["dir"], ignore_errors=True)
    try:
        saved = dist.launch(ckpt_rank, (2, 2), ("data", "model"), False)
        restored = dist.launch(ckpt_rank, (4, 1), ("data", "model"), True)
        one = one_card_restore()
    finally:
        shutil.rmtree(CKPT["dir"], ignore_errors=True)
    resumed = CKPT["every"] + 1
    f = {**{k: str(v) for k, v in CKPT.items()}, "saved_on_2x2": saved[0],
         "restored_on_4x1": restored[0], "restored_on_one_card": one,
         "wall_s": time.perf_counter() - t0}
    f["ok"] = bool(restored[0]["leaves_equal"] and one["leaves_equal"]
                   and restored[0]["leaves"] == one["leaves"] > 0
                   and all(r["start"] == resumed for r in restored)
                   and one["start"] == resumed)
    row["checkpoint"] = f
    bad += [] if f["ok"] else ["checkpoint"]
    print(json.dumps({"checkpoint": f}), flush=True)
    for name, case in DECODE_CASES.items():
        # (g): the sharded decode on (2, 2) against one card
        t0 = time.perf_counter()
        ranks = dist.launch(decode_rank, MESH, ("data", "model"), case)
        res = ranks[0]
        res["rank_mesh_peak_gib"] = [r["mesh_peak_gib"] for r in ranks]
        res["wall_s"] = time.perf_counter() - t0
        row[name] = res
        bad += [] if res["within_bounds"] else [name]
        print(json.dumps({name: res}), flush=True)
    row["serve"] = []
    for mesh in SERVE["meshes"]:
        # (h): qwen3-8b at full depth against 32,768-slot caches
        t0 = time.perf_counter()
        ranks = dist.launch(serve_rank, mesh, ("data", "model"),
                            SERVE["arch"], SERVE["batch"], SERVE["slots"],
                            SERVE["start"], SERVE["steps"])
        row["serve"].append({**SERVE, "mesh": list(mesh), "ranks": ranks,
                             "wall_s": time.perf_counter() - t0})
        print(json.dumps({"serve": row["serve"][-1]}), flush=True)
        if not all(r["finite"] and r["peak_gib"] < 80 for r in ranks):
            bad.append(f"serve {mesh}")
    print(json.dumps({"lm_mesh_cards": row}), flush=True)
    if bad:
        sys.exit(f"check_lm_mesh_cards: failed: {bad}")


if __name__ == "__main__":
    main()
