"""Model assembly, forward only, for the ported families:

  dense — (GQA/MQA attention + gated FFN) x N   (gemma, qwen, mistral)
  ssm   — (RMSNorm -> Mamba2 mixer -> residual) x N   (mamba2-780m)

Parameters are a nested dict shaped like the JAX package's pytree, with
the per-layer weights stacked along a leading layer axis (``"layers"``);
``forward`` walks the layers in a Python loop over views of that stack.
``lm_params_from_numpy`` carries the reference's parameters across.
The other families wait for later slices (ROADMAP.md).
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
                     norm_decl, rms_norm)

_PORTED = ("dense", "ssm")
_NOT_PORTED = {
    "moe": "ROADMAP.md A.8 (models/mla.py, models/moe.py)",
    "hybrid": "ROADMAP.md A.8 (zamba2's shared attention over mamba blocks)",
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
    else:
        decls["layers"] = _attn_block_decls(cfg, cfg.n_layers)
    return decls


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


def forward(params, tokens, cfg: ModelConfig):
    """tokens: (B, S) integer tensor -> final-norm hidden states (B, S, d).
    (The reference also returns an aux loss, which is 0 for these
    families.)"""
    _require_ported(cfg)
    x = embed_apply(params, tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i in range(cfg.n_layers):
        lp = tree_map(lambda t: t[i], params["layers"])
        if cfg.family == "ssm":
            x = mamba_block(lp, x, cfg)
        else:
            x = attn_block(lp, x, positions, cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)
