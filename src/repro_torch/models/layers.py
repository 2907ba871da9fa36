"""Core neural layers: norms, rotary embeddings, FFN, embedding/unembedding.

Each function takes and returns tensors in the layouts of the JAX package's
``models/layers.py`` and rounds to the compute dtype at the same places.
On a mesh the chunked cross-entropy loss takes the reference's
vocab-parallel branch when the model axis cuts the vocabulary.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import CPU_AXES, AxisEnv, ModelConfig, ParamDecl, fsdp_spec


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
              stack: int | None = None, *, ax: AxisEnv = CPU_AXES):
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    st = () if stack is None else (stack,)
    stp = () if stack is None else (None,)
    m = ax.shard_if(d_ff, ax.model)
    f = fsdp_spec(cfg, ax, d)
    return {
        "wi": ParamDecl(st + (d, 2 * d_ff), (*stp, f, m), fan_in=d),
        "wo": ParamDecl(st + (d_ff, d), (*stp, m, f), fan_in=d_ff),
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
def embed_decls(cfg: ModelConfig, ax: AxisEnv = CPU_AXES):
    v, d = cfg.padded_vocab, cfg.d_model
    m = ax.shard_if(v, ax.model)
    f = fsdp_spec(cfg, ax, d)
    decls = {"embedding": ParamDecl((v, d), (m, f), fan_in=d)}
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl((d, v), (f, m), fan_in=d)
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
def chunked_softmax_xent(hidden, labels, mask, p, cfg: ModelConfig, *,
                         mesh=None):
    """hidden: (B, S, d); labels, mask: (B, S). Returns float32
    (sum of the masked losses, sum of the mask). Each chunk of
    ``loss_chunk`` positions is one ``torch.utils.checkpoint``, so under
    grad its logits are recomputed in the backward, as the reference's
    ``jax.checkpoint(one)`` does.

    On a mesh (``launch/dist.ProcessMesh``; the rows are this rank's
    batch shard and ``p`` holds the unembedding's shards) both sums are
    the global ones, summed over the data axes. When the model axis cuts
    the vocabulary and the batch is cut over data, the reference's
    vocab-parallel loss (``models/layers.py:141-187``): the unembedding is
    gathered over data only, each model rank keeps its (B, chunk, V/tp)
    logits, and the row max (``pmax``), the summed exps and the gold logit
    (each ``psum``) are taken over ``model``; h enters through ``enter``,
    so its gradient sums over the model ranks. Otherwise the logits come
    from the whole gathered unembedding."""
    B, S, _ = hidden.shape
    chunk = min(cfg.loss_chunk, S)
    name = "embedding" if cfg.tie_embeddings else "lm_head"
    use_vp = False
    if mesh is None:
        w = unembed_weight(p, cfg)                             # (d, V)
    else:
        spec = embed_decls(cfg, mesh.ax)[name].spec
        tp, V = mesh.size("model"), cfg.padded_vocab
        use_vp = (cfg.vp_loss and tp > 1 and V % tp == 0
                  and mesh.split_data)
        w = mesh.gather(p[name], spec,
                        ("data",) if use_vp else ("data", "model"))
        w = unembed_weight({name: w}, cfg)                     # (d, V[/tp])

    def one(h_c, y_c, m_c, w):
        logits = (h_c @ w).float()
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, y_c[..., None].long())[..., 0]
        return ((lse - gold) * m_c).sum(), m_c.sum()

    def one_vp(h_c, y_c, m_c, w):
        v_loc = w.shape[-1]
        logits = (mesh.enter(h_c, "model") @ w).float()
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        # logsumexp is shift-invariant: the max carries no gradient
        mx = mesh.pmax(logits.detach().amax(dim=-1), "model")
        se = mesh.psum(torch.exp(logits - mx[..., None]).sum(dim=-1),
                       "model")
        lse = mx + torch.log(se)
        lo = mesh.axis_index("model") * v_loc
        y = y_c.long()
        idx = (y - lo).clamp(0, v_loc - 1)
        sel = (y >= lo) & (y < lo + v_loc)
        gold = mesh.psum(torch.where(
            sel, logits.gather(-1, idx[..., None])[..., 0], 0.0), "model")
        return ((lse - gold) * m_c).sum(), m_c.sum()

    fn = one_vp if use_vp else one
    grad = torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        args = (hidden[:, s0:s0 + chunk], labels[:, s0:s0 + chunk],
                mask[:, s0:s0 + chunk].float(), w)
        l, c = (checkpoint(fn, *args, use_reentrant=False) if grad
                else fn(*args))
        loss_sum, cnt = loss_sum + l, cnt + c
    if mesh is not None and mesh.split_data:
        loss_sum, cnt = mesh.psum(loss_sum, "data"), mesh.psum(cnt, "data")
    return loss_sum, cnt
