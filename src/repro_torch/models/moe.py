"""Mixture-of-Experts FFN: routed experts plus optional shared experts.

The routing arithmetic is the JAX package's (``models/moe.py``) with every
expert local (one device, no expert parallelism): the router's logits in
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
"""
from __future__ import annotations

import torch

from .common import ModelConfig, ParamDecl
from .layers import _gate


def moe_decls(cfg: ModelConfig, stack: int | None = None):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    st = () if stack is None else (stack,)
    decls = {
        "router": ParamDecl(st + (d, E), fan_in=d),
        "wi": ParamDecl(st + (E, d, 2 * ff), fan_in=d),
        "wo": ParamDecl(st + (E, ff, d), fan_in=ff),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        decls["shared_wi"] = ParamDecl(st + (d, 2 * sff), fan_in=d)
        decls["shared_wo"] = ParamDecl(st + (sff, d), fan_in=sff)
    return decls


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


def slot_grid(ids, cfg: ModelConfig):
    """The dense slot grid of the routed assignments ``ids`` (t, k):
    (token (E, cpe), assignment (E, cpe) into the flattened (t*k,) ids,
    valid (E, cpe)). Assignments are stably sorted by expert and each
    expert keeps its first ``cpe``; invalid slots point at a clamped
    position and carry weight 0."""
    t, k = ids.shape
    E = cfg.n_experts
    dev = ids.device
    flat_ids = ids.reshape(-1)
    order = torch.sort(flat_ids, stable=True).indices
    cpe = expert_capacity(t, cfg)
    C = min(cpe * E, t * k)
    counts = torch.bincount(flat_ids, minlength=E)
    gs = counts.clamp_max(cpe)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cpe, device=dev)
    raw_pos = starts[:, None] + slot[None, :]                # (E, cpe)
    pos = raw_pos.clamp_max(C - 1)
    valid = (slot[None, :] < gs[:, None]) & (raw_pos < C)
    assign = order[:C][pos]                                  # (E, cpe)
    return assign // k, assign, valid


def _combine(y, tok, valid, t: int, k: int):
    """out[tok] += y over the valid slots, without atomics: each token's
    kept slots (at most k, in slot order) are gathered and added one at a
    time in y's dtype. y: (E, cpe, d); tok, valid: (E, cpe)."""
    E, cpe, d = y.shape
    dev = y.device
    yf = torch.cat([y.reshape(E * cpe, d), y.new_zeros((1, d))])
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
    out = torch.zeros((t, d), dtype=y.dtype, device=dev)
    for j in range(k):
        out = out + yf[table[:, j]]
    return out


def routed_experts(x, router_w, wi, wo, cfg: ModelConfig):
    """x: (B, S, d) -> (routed output (B, S, d), float32 aux loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    t = B * S
    xf = x.reshape(t, d)
    probs, gate_w, ids = route(xf, router_w, cfg)
    tok, assign, valid = slot_grid(ids, cfg)
    w_grid = torch.where(valid, gate_w.reshape(-1)[assign], 0.0)
    xe = xf[tok]                                             # (E, cpe, d)
    h = torch.bmm(xe, wi.to(cfg.cdtype))
    g, u = h.chunk(2, dim=-1)
    h = _gate(cfg.activation, u, g)
    y = torch.bmm(h, wo.to(cfg.cdtype))                      # (E, cpe, d)
    y = y * w_grid[..., None].to(y.dtype)
    out = _combine(y, tok, valid, t, k)
    # load-balance aux loss
    frac = torch.bincount(ids.reshape(-1), minlength=E).float() / ids.numel()
    imp = probs.mean(dim=0)
    aux = E * torch.sum(frac * imp)
    return out.reshape(B, S, d), aux


def moe_ffn(p, x, cfg: ModelConfig):
    """Routed experts (+ optional shared experts). Returns (y, aux_loss)."""
    routed, aux = routed_experts(x, p["router"], p["wi"], p["wo"], cfg)
    if cfg.n_shared_experts:
        h = x @ p["shared_wi"].to(cfg.cdtype)
        g, u = h.chunk(2, dim=-1)
        h = _gate(cfg.activation, u, g)
        routed = routed + h @ p["shared_wo"].to(cfg.cdtype)
    return routed, aux
