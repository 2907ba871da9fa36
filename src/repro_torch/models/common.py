"""Common model-building machinery: parameter declarations and configs.

Parameters are declared once as a nested dict of :class:`ParamDecl`
(shape + init rule); ``init_params`` materialises them and ``param_count``
counts them, so the two never drift apart. Sharding specs and the axis
environment of the JAX package wait for multi-device work: the port runs
on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..device import resolve_device


# ---------------------------------------------------------------------------
# Param declarations
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple
    init: str = "normal"  # 'normal' | 'zeros' | 'ones'
    # fan-in for scaled-normal init; default = second-to-last dim (or last).
    fan_in: int | None = None
    dtype: Any = None  # filled from config default if None


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, in sorted key order (the order
    in which ``jax.tree_util`` flattens a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _truncated_normal_(t: torch.Tensor, generator) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], in place (inverse-CDF sampling,
    as ``jax.random.truncated_normal`` does)."""
    edge = math.erf(3.0 / math.sqrt(2.0))        # 2 * Phi(3) - 1
    t.uniform_(-edge, edge, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0))
    return t.clamp_(-3.0, 3.0)


def _materialize(decl: ParamDecl, generator, device, default_dtype):
    dtype = decl.dtype or default_dtype
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=dtype, device=device)
    fan = decl.fan_in
    if fan is None:
        fan = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
    std = 1.0 / np.sqrt(max(fan, 1))
    t = torch.empty(decl.shape, dtype=torch.float32, device=device)
    return (_truncated_normal_(t, generator) * std).to(dtype)


def init_params(decls, generator: torch.Generator | None = None, device=None,
                dtype: torch.dtype = torch.bfloat16):
    """Materialise a declaration tree: truncated normal at +-3 sigma with
    sigma = 1/sqrt(fan_in) (the JAX package's rule), drawn in float32 on
    ``device`` from ``generator`` (a generator of that device) and cast to
    ``dtype``."""
    dev = resolve_device(device)
    return tree_map(lambda d: _materialize(d, generator, dev, dtype), decls)


def param_count(decls) -> int:
    return int(sum(np.prod(d.shape) for _, d in tree_leaves(decls)))


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab_size: int = 1000
    activation: str = "swiglu"  # swiglu | geglu
    qk_norm: bool = False
    attention: str = "full"  # full | swa | mla
    window: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma-style sqrt(d) embedding scale
    logit_softcap: float = 0.0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0            # leading dense layers (deepseek)
    d_ff_dense: int = 0                # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # --- MLA ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2) ---
    hybrid_pattern: str = ""           # e.g. "amm" => [shared-attn, mamba, mamba] repeated
    # --- enc-dec ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- vlm / audio frontends (stubs provide embeddings directly) ---
    prefix_tokens: int = 0             # e.g. 256 image tokens for paligemma
    frontend_dim: int = 0              # raw frontend embedding dim (projected in)
    # --- numerics / distribution ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    fsdp: bool = False                 # ZeRO-3 shard params over data axes
    vp_loss: bool = True               # vocab-parallel cross-entropy (avoids
                                       # all-gathering sharded logits; see Perf)
    moe_cap_align: int = 8             # expert-slot grid alignment floor
    serve_quant: str = ""             # '' | 'int8' — serving weight quant
                                       # (128 kept once cpe >= 128; see Perf)
    remat: bool = True
    scan_layers: bool = True
    loss_chunk: int = 512              # sequence chunk for the fused CE loss
    attn_block_k: int = 256            # flash-scan kv block
    opt_state_dtype: str = "float32"   # float32 | bfloat16 | int8
    grad_accum: int = 1                # microbatches per step (grad accumulation)
    accum_dtype: str = "float32"       # grad accumulator dtype

    # ---- derived ----
    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
