"""Core neural layers: norms, rotary embeddings, FFN, embedding/unembedding.

Each function takes and returns tensors in the layouts of the JAX package's
``models/layers.py`` and rounds to the compute dtype at the same places.
The chunked cross-entropy loss has no vocab-parallel branch: that is
multi-device work (ROADMAP.md A.10).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    # F.embedding's gradient sums repeated tokens in a fixed order on the
    # card (indexing's accumulates with atomics), so training replays
    x = F.embedding(tokens.long(), p["embedding"].to(cfg.cdtype))
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


# ---------------------------------------------------------------------------
# Chunked cross entropy: full-vocab logits are alive for ``loss_chunk``
# positions at a time (vital for 256k vocabs)
# ---------------------------------------------------------------------------
def chunked_softmax_xent(hidden, labels, mask, p, cfg: ModelConfig):
    """hidden: (B, S, d); labels, mask: (B, S). Returns float32
    (sum of the masked losses, sum of the mask). Each chunk of
    ``loss_chunk`` positions is one ``torch.utils.checkpoint``, so under
    grad its logits are recomputed in the backward, as the reference's
    ``jax.checkpoint(one)`` does."""
    B, S, _ = hidden.shape
    chunk = min(cfg.loss_chunk, S)
    w = unembed_weight(p, cfg)                                 # (d, V)

    def one(h_c, y_c, m_c, w):
        logits = (h_c @ w).float()
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, y_c[..., None].long())[..., 0]
        return ((lse - gold) * m_c).sum(), m_c.sum()

    grad = torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        args = (hidden[:, s0:s0 + chunk], labels[:, s0:s0 + chunk],
                mask[:, s0:s0 + chunk].float(), w)
        l, c = (checkpoint(one, *args, use_reentrant=False) if grad
                else one(*args))
        loss_sum, cnt = loss_sum + l, cnt + c
    return loss_sum, cnt
