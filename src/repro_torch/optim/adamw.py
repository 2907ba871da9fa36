"""AdamW with selectable state precision.

State dtypes:
  float32  — standard.
  bfloat16 — halves optimizer memory.
  int8     — blockwise-quantized moments (256-element blocks along the last
             axis, float32 absmax scales), ~4x optimizer-memory saving; the
             update math then runs in bfloat16.

Quantized codes keep every leading axis of the parameter (only the last axis
is padded to the block size), so a state leaf can be cut along its leading
axis with its parameter.

The arithmetic is the JAX package's (``optim/adamw.py``) op by op: each op
rounds to its dtype, and Python constants meet a bfloat16 operand as
bfloat16 (JAX's weak types) — so the int8 codes and scales come out equal to
the reference's evaluated op by op. Unlike the reference, the update is in
place: parameters and moments are overwritten a piece at a time (one layer
of a stacked leaf, or at most ``PIECE`` elements of another leaf), so that
the float32 temporaries stay small beside the state (one float32 copy of
qwen3-4b's stacked FFN leaf is 3.6 GB). The update is elementwise, so the
pieces give the same bits as the whole.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models.common import ParamDecl, tree_leaves, tree_map

BLOCK = 256
PIECE = 1 << 26            # elements of a 2-D leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16 | int8


# ---------------------------------------------------------------------------
# int8 blockwise quantization (blocks along the last axis)
# ---------------------------------------------------------------------------
def _pad_last(n: int) -> int:
    return ((n + BLOCK - 1) // BLOCK) * BLOCK


def quantize_blockwise(x, *, round_up: bool = False):
    """(..., n) -> codes (..., n_pad) int8, scales (..., n_pad/BLOCK) fp32.

    ``round_up`` quantizes magnitudes with ceil instead of nearest — used
    for the second moment: nearest-rounding a small nu entry to code 0
    makes Adam's denominator collapse to eps and the update explode; ceil
    keeps every nonzero denominator >= one scale unit. Nearest rounds half
    to even, as ``jnp.round`` does."""
    *lead, n = x.shape
    xf = F.pad(x.float(), (0, _pad_last(n) - n))
    blocks = xf.reshape(*lead, -1, BLOCK)
    scale = blocks.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = blocks / scale[..., None]
    q = torch.sign(q) * torch.ceil(q.abs()) if round_up else torch.round(q)
    codes = q.clamp(-127, 127).to(torch.int8)
    return codes.reshape(*lead, -1), scale


def dequantize_blockwise(codes, scale, shape):
    *lead, n = shape
    blocks = codes.reshape(*lead, -1, BLOCK).float() * scale[..., None]
    return blocks.reshape(*lead, -1)[..., :n]


# ---------------------------------------------------------------------------
# State declaration / init
# ---------------------------------------------------------------------------
def _state_dtype(cfg: AdamWConfig):
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _moment_decl(decl: ParamDecl, cfg: AdamWConfig):
    if cfg.state_dtype == "int8":
        *lead, n = decl.shape
        npad = _pad_last(n)
        return {"codes": ParamDecl(tuple(lead) + (npad,), init="zeros",
                                   dtype=torch.int8),
                "scale": ParamDecl(tuple(lead) + (npad // BLOCK,),
                                   init="zeros", dtype=torch.float32)}
    return ParamDecl(decl.shape, init="zeros", dtype=_state_dtype(cfg))


def opt_state_decls(param_decls, cfg: AdamWConfig):
    mk = lambda d: _moment_decl(d, cfg)                      # noqa: E731
    return {"mu": tree_map(mk, param_decls), "nu": tree_map(mk, param_decls),
            "step": ParamDecl((), init="zeros", dtype=torch.int32)}


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments beside ``params`` (on their devices), step 0."""
    def mk(x):
        if cfg.state_dtype == "int8":
            *lead, n = x.shape
            npad = _pad_last(n)
            return {"codes": torch.zeros(tuple(lead) + (npad,),
                                         dtype=torch.int8, device=x.device),
                    "scale": torch.zeros(tuple(lead) + (npad // BLOCK,),
                                         dtype=torch.float32,
                                         device=x.device)}
        return torch.zeros(x.shape, dtype=_state_dtype(cfg), device=x.device)
    dev = next(t for _, t in tree_leaves(params)).device
    return {"mu": tree_map(mk, params), "nu": tree_map(mk, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------
def _pieces(x):
    """Slices of the leading axis that the update takes at once: one layer
    of a stacked leaf (3-D and up), at most ``PIECE`` elements of a 2-D
    one, the whole of a smaller one."""
    if x.dim() < 2:
        return [slice(None)]
    rows = 1 if x.dim() >= 3 else max(1, PIECE // max(1, x[0].numel()))
    return [slice(r, r + rows) for r in range(0, x.shape[0], rows)]


def global_norm(tree):
    """sqrt of the sum of squares: each square in the leaf's dtype, the sums
    in float32 (a piece at a time, so no float32 copy of a leaf is made)."""
    total = 0
    for _, x in tree_leaves(tree):
        for sl in _pieces(x):
            total = total + x[sl].square().sum(dtype=torch.float32)
    return torch.sqrt(total)


def _math_dtype(cfg):
    # int8-state models also do the update math in bf16: a single f32 copy of
    # a 671B model's per-device shard is 10.5 GB — it would not fit.
    return torch.bfloat16 if cfg.state_dtype == "int8" else torch.float32


def _load(state, shape, cfg):
    if cfg.state_dtype == "int8":
        return dequantize_blockwise(state["codes"], state["scale"],
                                    shape).to(_math_dtype(cfg))
    return state.float()


def _store(dst, val, cfg, *, round_up: bool = False):
    """Write a moment piece into its (sliced) state in place."""
    if cfg.state_dtype == "int8":
        codes, scale = quantize_blockwise(val, round_up=round_up)
        dst["codes"].copy_(codes)
        dst["scale"].copy_(scale)
    else:
        dst.copy_(val)


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step, in place: overwrites the leaves of ``params`` and of
    ``state``'s moments, and replaces ``state["step"]``. Returns (params,
    state, grad_norm)."""
    step = state["step"] + 1
    dev = step.device
    gn = global_norm(grads)
    clip = torch.clamp(torch.div(torch.tensor(cfg.grad_clip, device=dev),
                                 gn.clamp_min(1e-12)), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, device=dev), step.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, device=dev), step.float())
    lr = cfg.lr * lr_scale
    mdt = _math_dtype(cfg)

    def const(v):
        # a Python constant meets the math dtype as that dtype (JAX's weak
        # typing); PyTorch would keep a float32 opmath scalar otherwise
        return torch.tensor(v, dtype=mdt, device=dev)

    def upd(p, g, mu_s, nu_s):
        g = g.to(mdt) * clip.to(mdt)
        mu = (const(b1) * _load(mu_s, p.shape, cfg)
              + const(1 - b1) * g).to(mdt)
        nu = (const(b2) * _load(nu_s, p.shape, cfg)
              + const(1 - b2) * g.square()).to(mdt)
        delta = ((mu.float() / c1) / (torch.sqrt(nu.float() / c2) + cfg.eps)
                 + cfg.weight_decay * p.float()).to(mdt)
        p.copy_((p.to(mdt) - (lr * delta.float()).to(mdt)).to(p.dtype))
        _store(mu_s, mu, cfg)
        _store(nu_s, nu, cfg, round_up=True)

    def piece(s, sl):
        return {k: v[sl] for k, v in s.items()} if isinstance(s, dict) \
            else s[sl]

    def one(p, g, mu_s, nu_s):
        for sl in _pieces(p):
            upd(p[sl], g[sl], piece(mu_s, sl), piece(nu_s, sl))

    _zip_leaves(one, params, grads, state["mu"], state["nu"])
    state["step"] = step
    return params, state, gn


def _zip_leaves(fn, params, *trees):
    """fn(param, *the same leaf of each tree) over the parameter tree; a
    tree's leaf may be a {"codes", "scale"} dict (int8 moments)."""
    if isinstance(params, dict):
        for k, v in params.items():
            _zip_leaves(fn, v, *(t[k] for t in trees))
    else:
        fn(params, *trees)
