"""Model assembly, forward and decode, for every family of the JAX
package:

  dense  — (GQA/MQA attention + gated FFN) x N   (gemma, qwen, mistral)
  moe    — MLA attention + (dense FFN | routed experts)   (deepseek v2/v3):
           the leading ``n_dense_layers`` with a dense FFN of
           ``d_ff_dense``, then the MoE layers
  ssm    — (RMSNorm -> Mamba2 mixer -> residual) x N   (mamba2-780m)
  hybrid — [shared attention, mamba, mamba] macro-blocks   (zamba2): one
           attention block, its weights shared by every macro-block, and
           the mamba blocks stacked over the macro-blocks
  encdec — bidirectional encoder + causal decoder with cross-attention
           (seamless); the frontend is a stub, ``encode`` takes frames
  vlm    — the dense backbone behind projected prefix embeddings
           (paligemma); the vision frontend is a stub

Parameters are a nested dict shaped like the JAX package's pytree, with
the per-layer weights stacked along a leading layer axis; ``forward`` and
``decode_step`` walk the layers in a Python loop over views of that
stack, so the decode step's in-place cache writes land in the stacked
cache of ``init_cache``. ``forward`` returns the hidden states only: the
MoE router's aux loss, which the reference also returns, is for the
training loss (``moe.moe_ffn`` returns it). ``lm_params_from_numpy``
carries the reference's parameters across.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import ModelConfig, ParamDecl, tree_leaves, tree_map
from .layers import (embed_apply, embed_decls, ffn_apply, ffn_decls,
                     logits_from_hidden, norm_decl, rms_norm)


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------
def _attn_block_decls(cfg: ModelConfig, stack: int | None, *, d_ff=None,
                      moe=False, mla=False):
    st = () if stack is None else (stack,)
    return {"ln1": ParamDecl(st + (cfg.d_model,), init="ones"),
            "ln2": ParamDecl(st + (cfg.d_model,), init="ones"),
            "attn": (mla_mod.mla_decls(cfg, stack) if mla
                     else attn.attn_decls(cfg, stack)),
            "ffn": (moe_mod.moe_decls(cfg, stack) if moe
                    else ffn_decls(cfg, d_ff, stack))}


def _mamba_block_decls(cfg: ModelConfig, stack: int | None):
    st = () if stack is None else (stack,)
    return {"ln": ParamDecl(st + (cfg.d_model,), init="ones"),
            "mix": ssm_mod.ssm_decls(cfg, stack)}


def model_decls(cfg: ModelConfig):
    decls: dict[str, Any] = dict(embed_decls(cfg))
    decls["final_norm"] = norm_decl(cfg.d_model)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        decls["layers"] = _attn_block_decls(cfg, cfg.n_layers)
        if fam == "vlm" and cfg.frontend_dim:
            decls["vision_proj"] = ParamDecl((cfg.frontend_dim, cfg.d_model),
                                             fan_in=cfg.frontend_dim)
    elif fam == "moe":
        nd = cfg.n_dense_layers
        if nd:
            decls["dense_layers"] = _attn_block_decls(
                cfg, nd, d_ff=cfg.d_ff_dense or cfg.d_ff, mla=True)
        if cfg.n_layers - nd > 0:
            decls["moe_layers"] = _attn_block_decls(
                cfg, cfg.n_layers - nd, moe=True, mla=True)
    elif fam == "ssm":
        decls["layers"] = _mamba_block_decls(cfg, cfg.n_layers)
    elif fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        decls["shared_attn"] = _attn_block_decls(cfg, None)
        for i in range(pat.count("m")):
            decls[f"mamba{i}"] = _mamba_block_decls(cfg, n_macro)
    elif fam == "encdec":
        decls["enc_layers"] = _attn_block_decls(cfg, cfg.enc_layers)
        dec = _attn_block_decls(cfg, cfg.dec_layers)
        dec["ln_x"] = ParamDecl((cfg.dec_layers, cfg.d_model), init="ones")
        dec["xattn"] = attn.attn_decls(cfg, cfg.dec_layers)
        decls["dec_layers"] = dec
        decls["enc_final_norm"] = norm_decl(cfg.d_model)
    else:
        raise ValueError(fam)
    return decls


def _hybrid(cfg: ModelConfig):
    """(the macro-block pattern, the number of macro-blocks)."""
    pat = cfg.hybrid_pattern or "amm"
    return pat, cfg.n_layers // len(pat)


def lm_params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's parameter pytree (numpy arrays, ``layers`` stacked)
    -> the port's parameters on ``device``. Each leaf keeps its dtype;
    bfloat16 goes through float32, which is exact both ways. Shapes are
    checked against ``model_decls(cfg)``."""
    dev = resolve_device(device)
    want = dict(tree_leaves(model_decls(cfg)))
    got = dict(tree_leaves(tree))
    if want.keys() != got.keys():
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(want.keys() - got.keys())}, extra "
                         f"{sorted(got.keys() - want.keys())}")
    for path, a in got.items():
        if tuple(np.shape(a)) != tuple(want[path].shape):
            raise ValueError(f"{path}: shape {np.shape(a)} != "
                             f"{want[path].shape}")

    def convert(a):
        a = np.asarray(a)
        dtype = (torch.bfloat16 if a.dtype.name == "bfloat16"
                 else getattr(torch, a.dtype.name))
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(device=dev, dtype=dtype)

    return tree_map(convert, tree)


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------
def _window(cfg: ModelConfig):
    return cfg.window if cfg.attention == "swa" else None


def attn_block(p, x, positions, cfg: ModelConfig, *, causal=True,
               moe=False, mla=False):
    """Pre-norm attention (GQA/MQA, or MLA) and FFN (dense, or routed
    experts whose aux loss is dropped here) with residuals."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mla:
        h = mla_mod.mla_train(p["attn"], h, positions, cfg)
    else:
        h = attn.attention_train(p["attn"], h, positions, cfg,
                                 window=_window(cfg), causal=causal)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe:
        h, _ = moe_mod.moe_ffn(p["ffn"], h, cfg)
    else:
        h = ffn_apply(p["ffn"], h, cfg)
    return x + h


def mamba_block(p, x, cfg: ModelConfig):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + ssm_mod.mamba_block(p["mix"], h, cfg)


def _layer(tree, i):
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda t: t[i], tree)


def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of the moe family's leading dense layers."""
    return cfg.replace(d_ff=cfg.d_ff_dense or cfg.d_ff)


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None,
            enc_out=None):
    """tokens: (B, S) integer tensor -> final-norm hidden states (B, S', d).
    prefix_embeds: (B, Sp, frontend_dim) for the vlm family, projected and
    put before the tokens (S' = Sp + S); enc_out: the encoder's hidden
    states (``encode``) that the encdec decoder cross-attends to."""
    x = embed_apply(params, tokens, cfg)
    if cfg.family == "vlm" and prefix_embeds is not None:
        pe = prefix_embeds.to(cfg.cdtype)
        if cfg.frontend_dim:
            pe = pe @ params["vision_proj"].to(cfg.cdtype)
        x = torch.cat([pe, x], dim=1)
    positions = _positions(x)
    fam = cfg.family
    if fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        for i in range(n_macro):
            mi = 0
            for ch in pat:
                if ch == "a":
                    x = attn_block(params["shared_attn"], x, positions, cfg)
                else:
                    x = mamba_block(_layer(params[f"mamba{mi}"], i), x, cfg)
                    mi += 1
    elif fam == "moe":
        dcfg = _dense_cfg(cfg)
        for i in range(cfg.n_dense_layers):
            x = attn_block(_layer(params["dense_layers"], i), x, positions,
                           dcfg, mla=True)
        for i in range(cfg.n_layers - cfg.n_dense_layers):
            x = attn_block(_layer(params["moe_layers"], i), x, positions,
                           cfg, moe=True, mla=True)
    elif fam == "encdec":
        # each decoder layer: the causal self-attention block (attention,
        # then FFN), then cross-attention to enc_out
        for i in range(cfg.dec_layers):
            lp = _layer(params["dec_layers"], i)
            x = attn_block(lp, x, positions, cfg)
            hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
            x = x + _cross_attention(lp["xattn"], hx, enc_out, cfg)
    else:
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            if fam == "ssm":
                x = mamba_block(lp, x, cfg)
            else:
                x = attn_block(lp, x, positions, cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def encode(params, frames, cfg: ModelConfig):
    """Bidirectional encoder over precomputed frontend frames (B, S, d)."""
    x = frames.to(cfg.cdtype)
    positions = _positions(x)
    for i in range(cfg.enc_layers):
        x = attn_block(_layer(params["enc_layers"], i), x, positions, cfg,
                       causal=False)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _cross_attention(p, x, enc_out, cfg: ModelConfig):
    """Queries from x, keys and values from enc_out; no RoPE, no mask."""
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    q = x @ p["wq"].to(cfg.cdtype)
    k = enc_out @ p["wk"].to(cfg.cdtype)
    v = enc_out @ p["wv"].to(cfg.cdtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    o = attn.flash_attention(q, k, v, scale=cfg.head_dim ** -0.5,
                             causal=False, block_k=cfg.attn_block_k)
    return o.reshape(B, S, cfg.q_dim) @ p["wo"].to(cfg.cdtype)


# ---------------------------------------------------------------------------
# Decode (one new token against the caches)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Cache tree with a stacked leading layer dim per stack, zeros on
    ``device``. The encdec cache also holds ``enc_out`` (B, seq_len, d),
    which the caller fills with the encoder's output."""
    dev = resolve_device(device)
    w = _window(cfg)
    fam = cfg.family

    def stack(n, one):
        return tree_map(lambda a: a.new_zeros((n,) + a.shape), one)

    def kv(window=w):
        return attn.init_kv_cache(cfg, batch, seq_len, window=window,
                                  device=dev)

    if fam in ("dense", "vlm"):
        return {"layers": stack(cfg.n_layers, kv())}
    if fam == "moe":
        return {"layers": stack(cfg.n_layers, mla_mod.init_mla_cache(
            cfg, batch, seq_len, device=dev))}
    if fam == "ssm":
        return {"layers": stack(cfg.n_layers,
                                ssm_mod.init_ssm_cache(cfg, batch,
                                                       device=dev))}
    if fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        c = {"attn": stack(n_macro, kv())}
        for i in range(pat.count("m")):
            c[f"mamba{i}"] = stack(n_macro, ssm_mod.init_ssm_cache(
                cfg, batch, device=dev))
        return c
    if fam == "encdec":
        return {"self": stack(cfg.dec_layers, kv(None)),
                "enc_out": torch.zeros((batch, seq_len, cfg.d_model),
                                       dtype=cfg.cdtype, device=dev)}
    raise ValueError(fam)


def _attn_step(h, lp, lc, pos, cfg, *, moe=False, mla=False):
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    if mla:
        a, _ = mla_mod.mla_decode_step(lp["attn"], hn, pos, lc, cfg)
    else:
        a, _ = attn.attention_decode_step(lp["attn"], hn, pos, lc, cfg,
                                          window=_window(cfg))
    h = h + a
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if moe:
        f, _ = moe_mod.moe_ffn(lp["ffn"], hn, cfg)
    else:
        f = ffn_apply(lp["ffn"], hn, cfg)
    return h + f


def _dec_step(h, lp, lc, pos, enc_out, cfg):
    """One encdec decoder layer on one token: self-attention, then
    cross-attention, then the FFN (the reference's decode order; its
    forward runs the FFN before the cross-attention)."""
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    a, _ = attn.attention_decode_step(lp["attn"], hn, pos, lc, cfg)
    h = h + a
    hx = rms_norm(h, lp["ln_x"], cfg.norm_eps)
    h = h + _cross_attention(lp["xattn"], hx, enc_out, cfg)
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + ffn_apply(lp["ffn"], hn, cfg)


def _mamba_step(h, lp, lc, cfg):
    hn = rms_norm(h, lp["ln"], cfg.norm_eps)
    y, _ = ssm_mod.mamba_decode_step(lp["mix"], hn, lc, cfg)
    return h + y


def decode_step(params, token, pos: int, cache, cfg: ModelConfig):
    """token: (B,1) integer tensor; pos: its absolute position, a Python
    int. Writes the new token's entries into ``cache`` in place and
    returns (float32 logits (B,1,V), cache)."""
    x = embed_apply(params, token, cfg)
    fam = cfg.family
    if fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        for i in range(n_macro):
            mi = 0
            for ch in pat:
                if ch == "a":
                    x = _attn_step(x, params["shared_attn"],
                                   _layer(cache["attn"], i), pos, cfg)
                else:
                    name = f"mamba{mi}"
                    x = _mamba_step(x, _layer(params[name], i),
                                    _layer(cache[name], i), cfg)
                    mi += 1
    elif fam == "moe":
        nd = cfg.n_dense_layers
        dcfg = _dense_cfg(cfg)
        for i in range(cfg.n_layers):
            lc = _layer(cache["layers"], i)
            if i < nd:
                x = _attn_step(x, _layer(params["dense_layers"], i), lc,
                               pos, dcfg, mla=True)
            else:
                x = _attn_step(x, _layer(params["moe_layers"], i - nd), lc,
                               pos, cfg, moe=True, mla=True)
    elif fam == "encdec":
        for i in range(cfg.dec_layers):
            x = _dec_step(x, _layer(params["dec_layers"], i),
                          _layer(cache["self"], i), pos, cache["enc_out"],
                          cfg)
    else:
        for i in range(cfg.n_layers):
            lp, lc = _layer(params["layers"], i), _layer(cache["layers"], i)
            if fam == "ssm":
                x = _mamba_step(x, lp, lc, cfg)
            else:
                x = _attn_step(x, lp, lc, pos, cfg)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(h, params, cfg), cache
