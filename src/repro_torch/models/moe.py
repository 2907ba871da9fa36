"""Mixture-of-Experts FFN: routed experts plus optional shared experts.

The routing arithmetic is the JAX package's (``models/moe.py``), with every
expert local on one device and E/tp local experts a ``model`` rank on a
mesh (``routed_experts``): the router's logits in
the compute dtype and its softmax in float32; the top-k experts of each
token, their gates renormalised by their sum; the token-expert
assignments stably sorted by expert, at most ``cpe`` kept per expert in
that order; a dense slot grid (E, cpe) through two batched GEMMs; each
slot's output weighted by its gate and added into its token; and the
load-balance aux loss E * sum(frac * imp), which ``lm._forward`` sums over
the MoE layers into ``lm.lm_loss``.

Two choices keep it deterministic where PyTorch alone would not be:

  * Top-k by a stable descending sort, so that tied probabilities (common
    in bf16) pick the lower expert id, as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order for ties on CUDA).
  * No atomics in the combine: each token gathers its (at most k) kept
    slots in slot order, which is ascending expert order, and adds them
    one at a time in the output dtype, as the reference's scatter-add
    walks its updates; repeated calls give the same bits on the card.

The integer index builders whose outputs have static shapes (expert
counts, the combine's token table) are custom ops with a fake
implementation, so that a step on meta tensors (``launch/dryrun.py``)
runs the expert products at capacity, as the card runs them; a real
tensor runs the same code as before.
"""
from __future__ import annotations

import torch

from .common import CPU_AXES, AxisEnv, ModelConfig, ParamDecl, fsdp_spec
from .layers import _gate


def moe_decls(cfg: ModelConfig, stack: int | None = None, *,
              ax: AxisEnv = CPU_AXES):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    st = () if stack is None else (stack,)
    stp = () if stack is None else (None,)
    m = ax.shard_if(E, ax.model)
    f = fsdp_spec(cfg, ax, d)
    decls = {
        "router": ParamDecl(st + (d, E), (*stp, None, None), fan_in=d),
        "wi": ParamDecl(st + (E, d, 2 * ff), (*stp, m, f, None), fan_in=d),
        "wo": ParamDecl(st + (E, ff, d), (*stp, m, None, f), fan_in=ff),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        sm = ax.shard_if(sff, ax.model)
        decls["shared_wi"] = ParamDecl(st + (d, 2 * sff), (*stp, f, sm),
                                       fan_in=d)
        decls["shared_wo"] = ParamDecl(st + (sff, d), (*stp, sm, f),
                                       fan_in=sff)
    return decls


@torch.library.custom_op("repro_torch::counts", mutates_args=())
def counts(x: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(x, minlength=n)`` of values in [0, n): (n,)
    int64."""
    return torch.bincount(x, minlength=n)


@counts.register_fake
def _(x, n):
    return x.new_empty((n,), dtype=torch.long)


def expert_capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``t`` tokens. The alignment floor is 128 once
    the grid is GEMM-sized anyway, but only ``cfg.moe_cap_align`` for the
    few tokens of a decode step; never more than t * top_k."""
    k, E = cfg.top_k, cfg.n_experts
    cpe = int(t * k * cfg.capacity_factor / max(E, 1)) + 1
    align = 128 if cpe >= 128 else max(cfg.moe_cap_align, 1)
    return min(max(align, ((cpe + align - 1) // align) * align), t * k)


def route(xf, router_w, cfg: ModelConfig):
    """xf: (t, d) -> (float32 probs (t, E), gates (t, k) float32, expert
    ids (t, k) int64). Ties go to the lower id."""
    logits = xf @ router_w.to(cfg.cdtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, ids = vals[:, :cfg.top_k], ids[:, :cfg.top_k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, ids


def slot_grid(ids, cfg: ModelConfig, lo: int = 0, n_local: int | None = None):
    """The dense slot grid of the routed assignments ``ids`` (t, k) to the
    ``n_local`` experts [lo, lo + n_local) (all of them by default):
    (token (n_local, cpe), assignment (n_local, cpe) into the flattened
    (t*k,) ids, valid (n_local, cpe)). The local assignments are stably
    sorted by expert, the others after them, and each expert keeps its
    first ``cpe``; invalid slots point at a clamped position and carry
    weight 0."""
    t, k = ids.shape
    E = cfg.n_experts if n_local is None else n_local
    dev = ids.device
    flat_ids = ids.reshape(-1)
    key = torch.where((flat_ids >= lo) & (flat_ids < lo + E),
                      flat_ids - lo, E)
    order = torch.sort(key, stable=True).indices
    cpe = expert_capacity(t, cfg)
    C = min(cpe * E, t * k)
    per = counts(key, E + 1)[:E]
    gs = per.clamp_max(cpe)
    starts = torch.cumsum(per, 0) - per
    slot = torch.arange(cpe, device=dev)
    raw_pos = starts[:, None] + slot[None, :]                # (E, cpe)
    pos = raw_pos.clamp_max(C - 1)
    valid = (slot[None, :] < gs[:, None]) & (raw_pos < C)
    assign = order[:C][pos]                                  # (E, cpe)
    return assign // k, assign, valid


@torch.library.custom_op("repro_torch::token_table", mutates_args=())
def token_table(tok: torch.Tensor, valid: torch.Tensor, t: int,
                k: int) -> torch.Tensor:
    """(t, k) int64: each token's kept slots of the (E, cpe) grid, as
    flat slot indices in slot order, padded with E * cpe (the zero row
    of ``_combine``)."""
    E, cpe = tok.shape
    dev = tok.device
    s = torch.nonzero(valid.reshape(-1)).squeeze(1)          # slot order
    tk = tok.reshape(-1)[s]
    # sort the kept slots by token, keeping slot order within a token
    by_tok = torch.sort(tk, stable=True)
    s, tk = s[by_tok.indices], by_tok.values
    per_tok = torch.bincount(tk, minlength=t)
    first = torch.cumsum(per_tok, 0) - per_tok
    rank = torch.arange(tk.numel(), device=dev) - first[tk]
    table = torch.full((t, k), E * cpe, dtype=torch.long, device=dev)
    table[tk, rank] = s
    return table


@token_table.register_fake
def _(tok, valid, t, k):
    return tok.new_empty((t, k), dtype=torch.long)


def _combine(y, tok, valid, t: int, k: int):
    """out[tok] += y over the valid slots, without atomics: each token's
    kept slots (at most k, in slot order) are gathered and added one at a
    time in y's dtype. y: (E, cpe, d); tok, valid: (E, cpe)."""
    E, cpe, d = y.shape
    dev = y.device
    yf = torch.cat([y.reshape(E * cpe, d), y.new_zeros((1, d))])
    table = token_table(tok, valid, t, k)
    out = torch.zeros((t, d), dtype=y.dtype, device=dev)
    for j in range(k):
        out = out + yf[table[:, j]]
    return out


def routed_experts(x, router_w, wi, wo, cfg: ModelConfig, *, mesh=None):
    """x: (B, S, d) -> (routed output (B, S, d), float32 aux loss).

    On a mesh (``launch/dist.ProcessMesh``), after the reference's
    ``_local_expert_ffn`` (``models/moe.py:61-153``): x is this rank's
    batch shard; with ``ep = tp`` (E divisible by the model axis) wi and
    wo are the rank's E/ep local experts [axis_index(model) * E/ep, +E/ep)
    and each token's assignments to them fill the slot grid, whose
    capacity comes from the shard's own tokens; the routed output is
    summed over ``model``. The router runs replicated; x and the gates
    enter the local experts through ``enter`` over ``model``, so their
    gradients sum the ranks' partial work. The aux loss comes from the
    local tokens and is averaged over the data axes."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    t = B * S
    xf = x.reshape(t, d)
    probs, gate_w, ids = route(xf, router_w, cfg)
    tp = 1 if mesh is None else mesh.size("model")
    ep = tp if (tp > 1 and E % tp == 0) else 1
    lo = mesh.axis_index("model") * (E // ep) if ep > 1 else 0
    tok, assign, valid = slot_grid(ids, cfg, lo, E // ep)
    xin, gin = xf, gate_w
    if ep > 1:
        xin, gin = mesh.enter(xf, "model"), mesh.enter(gate_w, "model")
    w_grid = torch.where(valid, gin.reshape(-1)[assign], 0.0)
    xe = xin[tok]                                            # (E_loc, cpe, d)
    h = torch.bmm(xe, wi.to(cfg.cdtype))
    g, u = h.chunk(2, dim=-1)
    h = _gate(cfg.activation, u, g)
    y = torch.bmm(h, wo.to(cfg.cdtype))                      # (E_loc, cpe, d)
    y = y * w_grid[..., None].to(y.dtype)
    out = _combine(y, tok, valid, t, k)
    if ep > 1:
        out = mesh.psum(out, "model")
    # load-balance aux loss
    frac = counts(ids.reshape(-1), E).float() / ids.numel()
    imp = probs.mean(dim=0)
    aux = E * torch.sum(frac * imp)
    if mesh is not None and mesh.split_data:
        aux = mesh.pmean(aux, "data")
    return out.reshape(B, S, d), aux


def moe_ffn(p, x, cfg: ModelConfig, *, mesh=None):
    """Routed experts (+ optional shared experts). Returns (y, aux_loss).
    On a mesh ``p["wi"]`` and ``p["wo"]`` are the rank's local experts
    (``routed_experts``) and the shared experts' weights are whole."""
    routed, aux = routed_experts(x, p["router"], p["wi"], p["wo"], cfg,
                                 mesh=mesh)
    if cfg.n_shared_experts:
        h = x @ p["shared_wi"].to(cfg.cdtype)
        g, u = h.chunk(2, dim=-1)
        h = _gate(cfg.activation, u, g)
        routed = routed + h @ p["shared_wo"].to(cfg.cdtype)
    return routed, aux
