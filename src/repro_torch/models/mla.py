"""Multi-head Latent Attention (DeepSeek V2/V3).

The full-sequence path expands the compressed latent into per-head K/V and
runs the flash scan of ``attention.flash_attention``. The decode path uses
the *absorbed* formulation: scores are computed directly against the
compressed latent cache (B, L, kv_lora + rope_dim), which is the point of
MLA: O(kv_lora) cache instead of O(H*D) per token. As in
``attention.attention_decode_step``, the decode step writes the new
token's latent into the cache in place and takes ``pos`` as a Python int.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import tp
from .attention import NEG_INF, flash_attention
from .common import CPU_AXES, AxisEnv, ModelConfig, ParamDecl, fsdp_spec
from .layers import apply_rope, rms_norm


def mla_decls(cfg: ModelConfig, stack: int | None = None, *,
              ax: AxisEnv = CPU_AXES):
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vd = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    st = () if stack is None else (stack,)
    stp = () if stack is None else (None,)
    f = fsdp_spec(cfg, ax, d)
    mh = ax.shard_if(H, ax.model)
    mq = ax.shard_if(H * (nope + rope), ax.model)
    decls = {
        "wkv_a": ParamDecl(st + (d, r_kv + rope), (*stp, f, None), fan_in=d),
        "kv_norm": ParamDecl(st + (r_kv,), init="ones"),
        "w_uk": ParamDecl(st + (r_kv, H, nope), (*stp, None, mh, None),
                          fan_in=r_kv),
        "w_uv": ParamDecl(st + (r_kv, H, vd), (*stp, None, mh, None),
                          fan_in=r_kv),
        "wo": ParamDecl(st + (H * vd, d),
                        (*stp, ax.shard_if(H * vd, ax.model), f),
                        fan_in=H * vd),
    }
    if r_q:
        decls["wq_a"] = ParamDecl(st + (d, r_q), (*stp, f, None), fan_in=d)
        decls["q_norm"] = ParamDecl(st + (r_q,), init="ones")
        decls["wq_b"] = ParamDecl(st + (r_q, H * (nope + rope)),
                                  (*stp, None, mq), fan_in=r_q)
    else:
        decls["wq"] = ParamDecl(st + (d, H * (nope + rope)), (*stp, f, mq),
                                fan_in=d)
    return decls


def _queries(p, x, positions, cfg: ModelConfig, mesh=None):
    B, S, _ = x.shape
    H, nope, rope = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        qa = tp.proj(mesh, x, p["wq_a"].to(cfg.cdtype))
        qa = rms_norm(qa, p["q_norm"], cfg.norm_eps)
        q = qa @ p["wq_b"].to(cfg.cdtype)
    else:
        q = tp.proj(mesh, x, p["wq"].to(cfg.cdtype))
    q = q.reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent(p, x, positions, cfg: ModelConfig, mesh=None):
    r_kv = cfg.kv_lora_rank
    kv = tp.proj(mesh, x, p["wkv_a"].to(cfg.cdtype))
    c_kv, k_rope = kv[..., :r_kv], kv[..., r_kv:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _up(c_kv, w):
    """einsum("bsr,rhd->bshd"): the latent expanded through w (r, H, D)."""
    r, H, D = w.shape
    return (c_kv @ w.reshape(r, H * D)).reshape(*c_kv.shape[:-1], H, D)


def tp_heads(p, cfg: ModelConfig, mesh):
    """(leaves, config, mesh) of this rank's share of an MLA layer whose
    leaves ``p`` are gathered over the data axes (``models/tp.py``). With
    n_heads dividing over ``model`` every leaf that the model axis cuts is
    cut by heads (w_uk, w_uv, wq_b or wq, wo), so the stored shard is the
    rank's; the latent path (wkv_a, kv_norm) and the query's low-rank
    path (wq_a, q_norm), replicated, enter over ``model``, so each rank's
    partial work sums into their gradients; the config holds H/tp heads.
    Otherwise every leaf whole and no mesh (replicated compute)."""
    mesh = tp.tp_mesh(mesh)
    if mesh is None:
        return p, cfg, None
    decls = mla_decls(cfg, ax=mesh.ax)
    n = mesh.size("model")
    if cfg.n_heads % n:
        return tp.whole(mesh, p, decls), cfg, None
    out = {k: v if any(e is not None and mesh.key(e) == "model"
                       for e in decls[k].spec) else tp.replicated(mesh, v)
           for k, v in p.items()}
    return out, cfg.replace(n_heads=cfg.n_heads // n), mesh


def mla_train(p, x, positions, cfg: ModelConfig, *, mesh=None):
    """Expanded (non-absorbed) path for full sequences, causal. On a mesh
    whose heads divide over ``model`` (``tp_heads``) each rank computes
    its own heads and the output projection's partial product is summed
    over ``model``."""
    p, cfg, mesh = tp_heads(p, cfg, mesh)
    B, S, _ = x.shape
    H, nope, rope, vd = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim)
    q_nope, q_rope = _queries(p, x, positions, cfg, mesh)
    c_kv, k_rope = _latent(p, x, positions, cfg, mesh)
    k_nope = _up(c_kv, p["w_uk"].to(cfg.cdtype))
    v = _up(c_kv, p["w_uv"].to(cfg.cdtype))
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                      dim=-1)
    if vd != nope + rope:
        v = torch.nn.functional.pad(v, (0, nope + rope - vd))
    o = flash_attention(q_cat, k_cat, v, scale=(nope + rope) ** -0.5,
                        causal=True, block_k=cfg.attn_block_k)
    o, wo = o[..., :vd].reshape(B, S, H * vd), p["wo"].to(cfg.cdtype)
    return o @ wo if mesh is None else tp.row_parallel(mesh, o, wo)


def _decode_on_mesh(p, x, pos, cache, cfg: ModelConfig, mesh, spec):
    """``mla_decode_step`` on a mesh whose latent and rope caches are cut
    along their last dims over ``model`` (and along L over data when B
    does not divide). The queries are the rank's heads (``tp_heads``);
    the new token's latent and rope key are computed whole (RoPE sees all
    rope dims) and each rank writes its slices. The absorbed query and the
    rope query are all-gathered over ``model`` to every head, each rank's
    two partial score terms over its r_kv and rope slices are summed over
    ``model`` in float32, and ctx (B, H, r_kv) comes out cut along r_kv;
    it is all-gathered back to the rank's heads, so ``w_uv`` stays in its
    stored cut by heads (a cut along r_kv would move weights every
    step)."""
    from .attention import cut_layout, softmax_pv
    s_cut, tpn = cut_layout(mesh, spec["c_kv"], cfg.kv_lora_rank)
    cut_layout(mesh, spec["k_rope"], cfg.rope_head_dim)
    B, Sl = x.shape[0], cache["c_kv"].shape[1]
    nope, rope = cfg.head_dim, cfg.rope_head_dim
    j, off = mesh.axis_index("model"), (mesh.axis_index("data") * Sl
                                        if s_cut else 0)
    rl, el = cfg.kv_lora_rank // tpn, rope // tpn
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    pt, lcfg, tmesh = tp_heads(p, cfg, mesh)
    q_nope, q_rope = _queries(pt, x, positions, lcfg, tmesh)
    c_new, kr_new = _latent(pt, x, positions, lcfg, tmesh)
    if off <= pos < off + Sl:
        cache["c_kv"][:, pos - off] = c_new[:, 0, j * rl:(j + 1) * rl]
        cache["k_rope"][:, pos - off] = kr_new[:, 0, j * el:(j + 1) * el]
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         pt["w_uk"].to(cfg.cdtype))
    q_r = q_rope[:, 0]
    if tmesh is not None:
        q_abs = mesh.all_gather(q_abs, "model", 1)
        q_r = mesh.all_gather(q_r, "model", 1)
    q_abs, q_r = q_abs[..., j * rl:(j + 1) * rl], q_r[..., j * el:(j + 1) * el]
    cf = cache["c_kv"].float()
    s = (torch.einsum("bhr,blr->bhl", q_abs.float(), cf)
         + torch.einsum("bhe,ble->bhl", q_r.float(),
                        cache["k_rope"].float()))
    if tpn > 1:
        s = mesh.psum(s, "model")
    s = s * (nope + rope) ** -0.5
    valid = off + torch.arange(Sl, device=x.device) <= pos
    s = torch.where(valid[None, None, :], s, NEG_INF)
    ctx = softmax_pv(s, lambda a: torch.einsum("bhl,blr->bhr", a, cf), mesh,
                     s_cut).to(cfg.cdtype)
    if tpn > 1:
        ctx = mesh.all_gather(ctx, "model", 2)
    hl = lcfg.n_heads
    if tmesh is not None:
        ctx = ctx[:, j * hl:(j + 1) * hl]
    o = torch.einsum("bhr,rhd->bhd", ctx, pt["w_uv"].to(cfg.cdtype))
    o, wo = o.reshape(B, 1, hl * cfg.v_head_dim), pt["wo"].to(cfg.cdtype)
    return o @ wo if tmesh is None else tp.row_parallel(tmesh, o, wo)


def mla_decode_step(p, x, pos: int, cache, cfg: ModelConfig, *, mesh=None,
                    spec=None):
    """Absorbed decode. x: (B,1,d); pos: the absolute position, a Python
    int; cache: {'c_kv': (B,L,r_kv), 'k_rope': (B,L,rope)}, written in
    place at ``pos``. Returns (y, cache). On a mesh that cuts the caches
    (``spec``: their per-layer specs): ``_decode_on_mesh``."""
    if mesh is not None and (tp.tp_mesh(mesh) is not None
                             or spec["c_kv"][1] is not None):
        return _decode_on_mesh(p, x, pos, cache, cfg, mesh, spec), cache
    B = x.shape[0]
    L = cache["c_kv"].shape[1]
    H, nope, rope, vd = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, x, positions, cfg)          # (B,1,H,.)
    c_new, kr_new = _latent(p, x, positions, cfg)            # (B,1,.)
    cache["c_kv"][:, pos] = c_new[:, 0]
    cache["k_rope"][:, pos] = kr_new[:, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    # absorb W_uk into q:  q'_h = W_uk_h^T q_nope_h  -> (B,H,r_kv)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         p["w_uk"].to(cfg.cdtype))
    cf = c_kv.float()
    s = (torch.einsum("bhr,blr->bhl", q_abs.float(), cf)
         + torch.einsum("bhe,ble->bhl", q_rope[:, 0].float(),
                        k_rope.float())) * (nope + rope) ** -0.5
    valid = torch.arange(L, device=x.device) <= pos
    s = torch.where(valid[None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhl,blr->bhr", a, cf)                # (B,H,r_kv)
    o = torch.einsum("bhr,rhd->bhd", ctx.to(cfg.cdtype),
                     p["w_uv"].to(cfg.cdtype))
    o = o.reshape(B, 1, H * vd)
    return o @ p["wo"].to(cfg.cdtype), cache


def init_mla_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
                   device=None):
    dtype = dtype or cfg.cdtype
    dev = resolve_device(device)
    return {
        "c_kv": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dtype,
                            device=dev),
        "k_rope": torch.zeros((batch, seq_len, cfg.rope_head_dim),
                              dtype=dtype, device=dev),
    }
