"""Model assembly, forward and decode, for the ported families:

  dense  — (GQA/MQA attention + gated FFN) x N   (gemma, qwen, mistral)
  ssm    — (RMSNorm -> Mamba2 mixer -> residual) x N   (mamba2-780m)
  hybrid — [shared attention, mamba, mamba] macro-blocks   (zamba2): one
           attention block, its weights shared by every macro-block, and
           the mamba blocks stacked over the macro-blocks

Parameters are a nested dict shaped like the JAX package's pytree, with
the per-layer weights stacked along a leading layer axis; ``forward`` and
``decode_step`` walk the layers in a Python loop over views of that
stack, so the decode step's in-place cache writes land in the stacked
cache of ``init_cache``. ``lm_params_from_numpy`` carries the reference's
parameters across. The other families wait for later slices (ROADMAP.md
A.8).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from . import attention as attn
from . import ssm as ssm_mod
from .common import ModelConfig, ParamDecl, tree_leaves, tree_map
from .layers import (embed_apply, embed_decls, ffn_apply, ffn_decls,
                     logits_from_hidden, norm_decl, rms_norm)

_PORTED = ("dense", "ssm", "hybrid")
_NOT_PORTED = {
    "moe": "ROADMAP.md A.8 (models/mla.py, models/moe.py)",
    "encdec": "ROADMAP.md A.8 (encoder and cross-attention)",
    "vlm": "ROADMAP.md A.8 (prefix embeddings of the vlm family)",
}


def _require_ported(cfg: ModelConfig):
    if cfg.family not in _PORTED:
        where = _NOT_PORTED.get(cfg.family)
        if where is None:
            raise ValueError(cfg.family)
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {where}")


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------
def _attn_block_decls(cfg: ModelConfig, stack: int | None):
    st = () if stack is None else (stack,)
    return {"ln1": ParamDecl(st + (cfg.d_model,), init="ones"),
            "ln2": ParamDecl(st + (cfg.d_model,), init="ones"),
            "attn": attn.attn_decls(cfg, stack),
            "ffn": ffn_decls(cfg, None, stack)}


def _mamba_block_decls(cfg: ModelConfig, stack: int | None):
    st = () if stack is None else (stack,)
    return {"ln": ParamDecl(st + (cfg.d_model,), init="ones"),
            "mix": ssm_mod.ssm_decls(cfg, stack)}


def model_decls(cfg: ModelConfig):
    _require_ported(cfg)
    decls: dict[str, Any] = dict(embed_decls(cfg))
    decls["final_norm"] = norm_decl(cfg.d_model)
    if cfg.family == "ssm":
        decls["layers"] = _mamba_block_decls(cfg, cfg.n_layers)
    elif cfg.family == "hybrid":
        pat, n_macro = _hybrid(cfg)
        decls["shared_attn"] = _attn_block_decls(cfg, None)
        for i in range(pat.count("m")):
            decls[f"mamba{i}"] = _mamba_block_decls(cfg, n_macro)
    else:
        decls["layers"] = _attn_block_decls(cfg, cfg.n_layers)
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


def attn_block(p, x, positions, cfg: ModelConfig):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    h = attn.attention_train(p["attn"], h, positions, cfg,
                             window=_window(cfg))
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h, cfg)


def mamba_block(p, x, cfg: ModelConfig):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + ssm_mod.mamba_block(p["mix"], h, cfg)


def _layer(tree, i):
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda t: t[i], tree)


def forward(params, tokens, cfg: ModelConfig):
    """tokens: (B, S) integer tensor -> final-norm hidden states (B, S, d).
    (The reference also returns an aux loss, which is 0 for these
    families.)"""
    _require_ported(cfg)
    x = embed_apply(params, tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.family == "hybrid":
        pat, n_macro = _hybrid(cfg)
        for i in range(n_macro):
            mi = 0
            for ch in pat:
                if ch == "a":
                    x = attn_block(params["shared_attn"], x, positions, cfg)
                else:
                    x = mamba_block(_layer(params[f"mamba{mi}"], i), x, cfg)
                    mi += 1
    else:
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            if cfg.family == "ssm":
                x = mamba_block(lp, x, cfg)
            else:
                x = attn_block(lp, x, positions, cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decode (one new token against the caches)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Cache tree with a stacked leading layer dim per stack, zeros on
    ``device``."""
    _require_ported(cfg)
    dev = resolve_device(device)
    w = _window(cfg)

    def stack(n, one):
        return tree_map(lambda a: a.new_zeros((n,) + a.shape), one)

    def kv():
        return attn.init_kv_cache(cfg, batch, seq_len, window=w, device=dev)

    if cfg.family == "dense":
        return {"layers": stack(cfg.n_layers, kv())}
    if cfg.family == "ssm":
        return {"layers": stack(cfg.n_layers,
                                ssm_mod.init_ssm_cache(cfg, batch,
                                                       device=dev))}
    pat, n_macro = _hybrid(cfg)
    c = {"attn": stack(n_macro, kv())}
    for i in range(pat.count("m")):
        c[f"mamba{i}"] = stack(n_macro,
                               ssm_mod.init_ssm_cache(cfg, batch, device=dev))
    return c


def _attn_step(h, lp, lc, pos, cfg):
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    a, _ = attn.attention_decode_step(lp["attn"], hn, pos, lc, cfg,
                                      window=_window(cfg))
    h = h + a
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
    _require_ported(cfg)
    x = embed_apply(params, token, cfg)
    if cfg.family == "hybrid":
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
    else:
        for i in range(cfg.n_layers):
            lp, lc = _layer(params["layers"], i), _layer(cache["layers"], i)
            if cfg.family == "ssm":
                x = _mamba_step(x, lp, lc, cfg)
            else:
                x = _attn_step(x, lp, lc, pos, cfg)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(h, params, cfg), cache
