"""Common model-building machinery: parameter declarations, sharding
specs, the axis environment and configs.

Parameters are declared once as a nested dict of :class:`ParamDecl`
(shape + sharding spec + init rule); ``init_params`` materialises them,
``param_specs`` gives their specs and ``param_count`` counts them, so the
three never drift apart. A spec is a plain tuple, one entry a dim (fewer
entries leave the trailing dims whole): ``None``, a mesh axis name, or a
tuple of names (the data axes ``("pod", "data")``) — the JAX package's
``PartitionSpec``, with no jax in it. ``launch/dist.py`` cuts and gathers
the leaves by these specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..device import resolve_device


# ---------------------------------------------------------------------------
# Axis environment
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """Logical mesh axes. ``data`` may span several physical axes
    (pod, data)."""
    data: tuple[str, ...] = ("data",)
    model: str = "model"
    sizes: dict | None = None  # axis name -> size, for divisibility checks

    @property
    def dp(self):
        return self.data if len(self.data) > 1 else self.data[0]

    def size(self, name) -> int:
        if self.sizes is None:
            return 1
        if isinstance(name, tuple):
            out = 1
            for n in name:
                out *= self.sizes.get(n, 1)
            return out
        return self.sizes.get(name, 1)

    def shard_if(self, dim: int, name):
        """Return axis name if ``dim`` divides evenly over it, else None."""
        if name is None:
            return None
        s = self.size(name)
        return name if (s > 0 and dim % s == 0) else None


def axis_env_for_mesh(mesh) -> AxisEnv:
    """The axis environment of a ``launch.mesh.Mesh``: ``data`` is every
    axis but ``model``."""
    names = mesh.axis_names
    sizes = dict(zip(names, mesh.devices.shape))
    data = tuple(n for n in names if n != "model")
    return AxisEnv(data=data, model="model", sizes=sizes)


# Single-device env (smoke tests / CPU examples).
CPU_AXES = AxisEnv(data=("data",), model="model",
                   sizes={"data": 1, "model": 1})


# ---------------------------------------------------------------------------
# Param declarations
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple
    spec: tuple = ()      # sharding spec: one entry a leading dim
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


def tree_from_leaves(like, flat: dict, prefix: str = ""):
    """``like``'s dict structure with the leaves of ``flat`` (path -> leaf,
    the paths of ``tree_leaves``): the way back of ``dict(tree_leaves)``."""
    if isinstance(like, dict):
        return {k: tree_from_leaves(v, flat, f"{prefix}['{k}']")
                for k, v in like.items()}
    return flat[prefix]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each tree
    in ``rest``, which share its dict structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


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


def param_specs(decls):
    return tree_map(lambda d: d.spec, decls)


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


def fsdp_spec(cfg: ModelConfig, ax: AxisEnv, dim: int):
    """Axis to shard `dim` over for ZeRO-3, or None."""
    if not cfg.fsdp:
        return None
    return ax.shard_if(dim, ax.dp)
