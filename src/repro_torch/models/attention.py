"""Attention layers: GQA/MQA with RoPE and optional qk-norm.

Three execution paths:
  * ``flash_attention``  — full causal or bidirectional attention as an
    online-softmax scan over KV blocks (memory-bounded; plain PyTorch), an
    autograd Function with the reference's custom VJP: its residuals are
    q, k, v, the output and lse, and the backward recomputes the scores
    blockwise (``models/attention.py:93-192`` of the JAX package).
  * ``swa_attention``    — sliding-window attention. Below the sequence
    length it runs the hand-written banded kernel through
    ``kernels.ops.swa_attention_op`` (its plain version on CPU tensors),
    whose backward is the hand-written backward kernel; a window that
    covers the sequence is plain causal attention.
  * ``decode_attention`` — one new token against a KV cache (a ring buffer
    of ``window`` slots for SWA), plain PyTorch as in the JAX package.
    ``attention_decode_step`` writes the new k and v into the cache in
    place, and takes ``pos`` as a Python int so that neither the slot nor
    the mask needs the device.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.ops import swa_attention_op
from . import tp
from .common import CPU_AXES, AxisEnv, ModelConfig, ParamDecl, fsdp_spec
from .layers import apply_rope, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------
def attn_decls(cfg: ModelConfig, stack: int | None = None, *,
               ax: AxisEnv = CPU_AXES):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    st = () if stack is None else (stack,)
    stp = () if stack is None else (None,)
    f = fsdp_spec(cfg, ax, d)
    mq = ax.shard_if(qd, ax.model)
    mkv = ax.shard_if(kvd, ax.model)
    decls = {
        "wq": ParamDecl(st + (d, qd), (*stp, f, mq), fan_in=d),
        "wk": ParamDecl(st + (d, kvd), (*stp, f, mkv), fan_in=d),
        "wv": ParamDecl(st + (d, kvd), (*stp, f, mkv), fan_in=d),
        "wo": ParamDecl(st + (qd, d), (*stp, mq, f), fan_in=qd),
    }
    if cfg.qk_norm:
        decls["q_norm"] = ParamDecl(st + (cfg.head_dim,), init="ones")
        decls["k_norm"] = ParamDecl(st + (cfg.head_dim,), init="ones")
    return decls


def _qkv(p, x, positions, cfg: ModelConfig, mesh=None):
    B, S, _ = x.shape
    q = tp.proj(mesh, x, p["wq"].to(cfg.cdtype))
    k = tp.proj(mesh, x, p["wk"].to(cfg.cdtype))
    v = tp.proj(mesh, x, p["wv"].to(cfg.cdtype))
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Full attention: online-softmax scan over KV blocks, flash-style custom VJP
# (the backward recomputes the scores blockwise; residuals are q, k, v, out
# and lse, O(S), never O(S^2))
# ---------------------------------------------------------------------------
def _flash_fwd(q, k, v, scale: float, causal: bool, block_k: int):
    """(out in q's dtype, lse (B, S, KV, G) float32)."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    bk = min(block_k, Sk)
    nb = -(-Sk // bk)
    qg = (q.float() * scale).reshape(B, S, KV, G, D)
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, S, KV, G), NEG_INF, device=q.device)
    l = torch.zeros((B, S, KV, G), device=q.device)
    acc = torch.zeros((B, S, KV, G, D), device=q.device)
    for blk in range(nb):
        start = blk * bk
        k_b = k[:, start:start + bk].float()
        v_b = v[:, start:start + bk].float()
        kpos = start + torch.arange(k_b.shape[1], device=q.device)
        s = torch.einsum("bskgd,btkd->bskgt", qg, k_b)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]                 # (S, t)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bskgt,btkd->bskgd",
                                                    pexp, v_b)
        m = m_new
    lse = m + torch.log(l.clamp_min(1e-30))
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(B, S, H, D)
    return out.to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, scale: float, causal: bool,
               block_k: int):
    """The reference's ``_flash_vjp_bwd``: (dq, dk, dv) in the inputs'
    dtypes, the scores recomputed a KV block at a time in float32."""
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    bk = min(block_k, Sk)
    nb = -(-Sk // bk)
    qf = q.float().reshape(B, S, KV, G, D)
    dog = dout.float().reshape(B, S, KV, G, D)
    og = out.float().reshape(B, S, KV, G, D)
    delta = (dog * og).sum(dim=-1)                            # (B,S,KV,G)
    qpos = torch.arange(S, device=q.device)
    dq = torch.zeros((B, S, KV, G, D), device=q.device)
    dk = torch.empty((B, Sk, KV, D), device=q.device)
    dv = torch.empty((B, Sk, KV, D), device=q.device)
    for blk in range(nb):
        start = blk * bk
        k_b = k[:, start:start + bk].float()
        v_b = v[:, start:start + bk].float()
        kpos = start + torch.arange(k_b.shape[1], device=q.device)
        s = torch.einsum("bskgd,btkd->bskgt", qf * scale, k_b)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - lse[..., None])                     # (B,S,KV,G,t)
        dv[:, start:start + bk] = torch.einsum("bskgt,bskgd->btkd", p, dog)
        dp = torch.einsum("bskgd,btkd->bskgt", dog, v_b)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bskgt,btkd->bskgd", ds, k_b)
        dk[:, start:start + bk] = torch.einsum("bskgt,bskgd->btkd", ds, qf)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, block_k: int):
        out, lse = _flash_fwd(q, k, v, scale, causal, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, dout, *ctx.args),
                None, None, None)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    block_k: int = 256):
    """q: (B,S,H,D), k/v: (B,Sk,KV,D) -> (B,S,H,D). float32 math."""
    return _Flash.apply(q, k, v, scale, causal, block_k)


# ---------------------------------------------------------------------------
# Sliding-window attention (train/prefill)
# ---------------------------------------------------------------------------
def swa_attention(q, k, v, *, window: int, scale: float):
    """q: (B,S,H,D), k/v: (B,S,KV,D). The band runs on the kernel."""
    S = q.shape[1]
    if window >= S:
        return flash_attention(q, k, v, scale=scale, causal=True)
    if S % window:
        raise ValueError(f"seq {S} not divisible by window {window}")
    return swa_attention_op(q, k, v, window=window, scale=scale)


# ---------------------------------------------------------------------------
# Heads over the model axis
# ---------------------------------------------------------------------------
def tp_heads(p, cfg: ModelConfig, mesh):
    """(leaves, config, mesh) of this rank's share of an attention layer
    whose leaves ``p`` are gathered over the data axes (``models/tp.py``).
    With n_heads dividing over ``model`` the rank computes its H/tp query
    heads: wq and wo are its stored shards, wk and wv its own KV heads
    (the stored shards where n_kv_heads divides; otherwise only the KV
    heads its query heads read, by ``tp.kv_heads``: at qwen3-8b's tp 16
    the stored cut of wk is half a head), q_norm/k_norm enter over
    ``model``; the config holds the local head counts and the mesh is
    returned for the column-parallel products and the sum. Otherwise (or off a mesh with a
    model axis) every leaf whole, the config as it is, and no mesh:
    replicated compute."""
    mesh = tp.tp_mesh(mesh)
    if mesh is None:
        return p, cfg, None
    decls = attn_decls(cfg, ax=mesh.ax)
    n, D = mesh.size("model"), cfg.head_dim
    if cfg.n_heads % n:
        return tp.whole(mesh, p, decls), cfg, None
    hl = cfg.n_heads // n

    def heads(j):
        return [tp.block(j, hl * D)]

    def kv(j):
        return tp.merge([(h * D, (h + 1) * D) for h in
                         tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, n, j)])

    out = {"wq": tp.take(mesh, p["wq"], decls["wq"].spec, 1, heads),
           "wk": tp.take(mesh, p["wk"], decls["wk"].spec, 1, kv),
           "wv": tp.take(mesh, p["wv"], decls["wv"].spec, 1, kv),
           "wo": tp.take(mesh, p["wo"], decls["wo"].spec, 0, heads)}
    for k in ("q_norm", "k_norm"):
        if k in p:
            out[k] = tp.replicated(mesh, p[k])
    n_kv = len(tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, n,
                           mesh.axis_index("model")))
    return out, cfg.replace(n_heads=hl, n_kv_heads=n_kv), mesh


# ---------------------------------------------------------------------------
# Block-level entry point
# ---------------------------------------------------------------------------
def attention_train(p, x, positions, cfg: ModelConfig, *,
                    window: int | None = None, causal: bool = True,
                    mesh=None):
    """Full-sequence attention (train / prefill). On a mesh whose heads
    divide over ``model`` (``tp_heads``) each rank computes its own heads
    and the output projection's partial product is summed over
    ``model``."""
    p, cfg, mesh = tp_heads(p, cfg, mesh)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg, mesh)
    scale = cfg.head_dim ** -0.5
    if window is not None and causal:
        o = swa_attention(q, k, v, window=window, scale=scale)
    else:
        o = flash_attention(q, k, v, scale=scale, causal=causal,
                            block_k=cfg.attn_block_k)
    o, wo = o.reshape(B, S, cfg.q_dim), p["wo"].to(cfg.cdtype)
    return o @ wo if mesh is None else tp.row_parallel(mesh, o, wo)


# ---------------------------------------------------------------------------
# Decode (one new token against a KV cache; ring buffer for SWA)
# ---------------------------------------------------------------------------
def decode_attention(q, k_cache, v_cache, *, scale: float, valid):
    """q: (B,1,H,D); caches: (B,L,KV,D); valid: (B,L) or (L,) bool."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = (q.float() * scale).reshape(B, KV, G, D)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k_cache.float())
    if valid.dim() == 1:
        valid = valid[None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention_decode_step(p, x, pos: int, cache, cfg: ModelConfig, *,
                          window: int | None = None):
    """x: (B,1,d); pos: the absolute position, a Python int; cache:
    dict(k,v) of (B,L,KV,D), written in place at the new token's slot
    (``pos % L`` for SWA, ``pos`` otherwise). Returns (y, cache)."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, positions, cfg)
    slot = pos % L if window is not None else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    idx = torch.arange(L, device=x.device)
    if window is not None:
        # ring buffer: every slot is valid once it is full
        valid = (idx <= slot) | (pos >= L)
    else:
        valid = idx <= pos
    o = decode_attention(q, cache["k"], cache["v"],
                         scale=cfg.head_dim ** -0.5, valid=valid)
    o = o.reshape(B, 1, cfg.q_dim)
    return o @ p["wo"].to(cfg.cdtype), cache


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                  window: int | None = None, dtype=None, device=None):
    L = min(window, seq_len) if window is not None else seq_len
    dtype = dtype or cfg.cdtype
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
