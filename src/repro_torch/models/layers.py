"""Core neural layers: norms, rotary embeddings, FFN, embedding/unembedding.

Each function takes and returns tensors in the layouts of the JAX package's
``models/layers.py`` and rounds to the compute dtype at the same places.
The chunked cross-entropy loss waits for the training slice.
"""
from __future__ import annotations

import math

import torch

from .common import ModelConfig, ParamDecl


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps=1e-6, offset: float = 0.0):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(dt)


def norm_decl(dim: int) -> ParamDecl:
    return ParamDecl((dim,), init="ones")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Split-half
    rotation, computed in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    ang = positions[..., None].float() * freqs                # (..., S, D/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN (gated)
# ---------------------------------------------------------------------------
def ffn_decls(cfg: ModelConfig, d_ff: int | None = None,
              stack: int | None = None):
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    st = () if stack is None else (stack,)
    return {
        "wi": ParamDecl(st + (d, 2 * d_ff), fan_in=d),
        "wo": ParamDecl(st + (d_ff, d), fan_in=d_ff),
    }


def silu(x):
    """``jax.nn.silu`` op by op, x * (1 / (1 + exp(-x))), so that a
    bfloat16 input rounds after every op where the reference does."""
    return x * (1 / (1 + torch.exp(-x)))


def _gate(act: str, u, g):
    """The gate op by op as ``jax.nn.silu`` and ``jax.nn.gelu`` (tanh form,
    constants in g's dtype) decompose, so that a bfloat16 gate rounds
    after every op where the reference does, bit for bit."""
    c = lambda v: torch.tensor(v, dtype=g.dtype)          # noqa: E731
    if act == "geglu":
        inner = c(math.sqrt(2 / math.pi)) * (g + c(0.044715) * (g * g * g))
        return u * (g * (c(0.5) * (1 + torch.tanh(inner))))
    return u * silu(g)  # swiglu


def ffn_apply(p, x, cfg: ModelConfig):
    h = x @ p["wi"].to(cfg.cdtype)
    g, u = h.chunk(2, dim=-1)
    h = _gate(cfg.activation, u, g)
    return h @ p["wo"].to(cfg.cdtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_decls(cfg: ModelConfig):
    v, d = cfg.padded_vocab, cfg.d_model
    decls = {"embedding": ParamDecl((v, d), fan_in=d)}
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl((d, v), fan_in=d)
    return decls


def embed_apply(p, tokens, cfg: ModelConfig):
    x = p["embedding"].to(cfg.cdtype)[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    return x


def unembed_weight(p, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return p["embedding"].T.to(cfg.cdtype)  # (d, V)
    return p["lm_head"].to(cfg.cdtype)


def logits_from_hidden(h, p, cfg: ModelConfig):
    logits = (h @ unembed_weight(p, cfg)).float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
