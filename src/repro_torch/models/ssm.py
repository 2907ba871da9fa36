"""Mamba2 (SSD, state-space duality) block, forward only.

Prefill: the sequence is split into chunks, a quadratic intra-chunk term
(attention-like, bounded by Q^2) plus a linear inter-chunk state
recurrence. The scan over chunks is the hand-written SSD kernel
(``kernels/ssd.py:ssd_chunked``; its plain version on CPU tensors).
Decode: the O(1) recurrent update of one token (``mamba_decode_step``) in
plain PyTorch, as in the JAX package, with its conv and state cache
(``init_ssm_cache``) written in place.

Notation: x (b, L, H, P) per-head inputs, B and C (b, L, N) (one group
broadcast over heads), per-head log decay a = -exp(A_log), discrete decay
dA = a * dt.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels import ssd as ssd_kernel
from .common import CPU_AXES, AxisEnv, ModelConfig, ParamDecl, fsdp_spec
from .layers import rms_norm, silu


def ssm_decls(cfg: ModelConfig, stack: int | None = None, *,
              ax: AxisEnv = CPU_AXES):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    in_dim = 2 * di + 2 * N + H   # z, x, B, C, dt
    st = () if stack is None else (stack,)
    stp = () if stack is None else (None,)
    f = fsdp_spec(cfg, ax, d)
    return {
        "in_proj": ParamDecl(st + (d, in_dim),
                             (*stp, f, ax.shard_if(in_dim, ax.model)),
                             fan_in=d),
        "conv_w": ParamDecl(st + (cfg.conv_width, conv_ch),
                            fan_in=cfg.conv_width),
        "conv_b": ParamDecl(st + (conv_ch,), init="zeros"),
        "A_log": ParamDecl(st + (H,), init="zeros"),
        "D": ParamDecl(st + (H,), init="ones"),
        "dt_bias": ParamDecl(st + (H,), init="zeros"),
        "norm": ParamDecl(st + (di,), init="ones"),
        "out_proj": ParamDecl(st + (di, d),
                              (*stp, ax.shard_if(di, ax.model), f),
                              fan_in=di),
    }


def _split_in(h, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    z = h[..., :di]
    xBC = h[..., di: 2 * di + 2 * N]
    dt = h[..., 2 * di + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv. xBC (B, L, C); w (W, C); state (B, W-1, C) or
    None. The shifted products are summed one at a time, as the reference
    sums them, so a bfloat16 conv rounds after every product and add."""
    W = w.shape[0]
    L = xBC.shape[1]
    pad = (torch.zeros_like(xBC[:, : W - 1]) if state is None
           else state.to(xBC.dtype))
    xp = torch.cat([pad, xBC], dim=1)
    out = sum(xp[:, i: i + L] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return silu(out + b), new_state


def ssd_chunked(x, dt, B, C, A_log, D, *, chunk: int, init_state=None):
    """x (b, L, H, P), dt (b, L, H), B/C (b, L, N) -> y (b, L, H, P),
    final_state (b, H, P, N). Always the SSD kernel on a CUDA tensor."""
    return ssd_kernel.ssd_chunked(x, dt, B, C, A_log, D, chunk=chunk,
                                  init_state=init_state)


def mamba_block(p, x, cfg: ModelConfig):
    """Full Mamba2 mixer. x (B, L, d_model) -> (B, L, d_model). x, B and C
    reach the scan as strided views of the conv output."""
    Bsz, L, _ = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = x @ p["in_proj"].to(cfg.cdtype)
    z, xBC, dt = _split_in(h, cfg)
    xBC, _ = _causal_conv(xBC, p["conv_w"].to(cfg.cdtype),
                          p["conv_b"].to(cfg.cdtype))
    xs = xBC[..., :di].reshape(Bsz, L, H, Pd)
    Bmat = xBC[..., di:di + N]
    Cmat = xBC[..., di + N:]
    dt = dt + p["dt_bias"].to(dt.dtype)
    y, _ = ssd_chunked(xs, dt, Bmat, Cmat, p["A_log"], p["D"],
                       chunk=cfg.ssm_chunk)
    y = y.reshape(Bsz, L, di)
    y = rms_norm(y * silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(cfg.cdtype)


def mamba_decode_step(p, x, cache, cfg: ModelConfig):
    """x: (B,1,d). cache: {'conv': (B,W-1,conv_ch), 'ssm': (B,H,P,N)},
    written in place. The state update runs in float32 and y rounds to the
    compute dtype once, after the D * x skip. Returns (out, cache)."""
    Bsz = x.shape[0]
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = x @ p["in_proj"].to(cfg.cdtype)
    z, xBC, dt = _split_in(h, cfg)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"].to(cfg.cdtype),
                                   p["conv_b"].to(cfg.cdtype),
                                   state=cache["conv"])
    xs = xBC[:, 0, :di].reshape(Bsz, H, Pd).float()
    Bmat = xBC[:, 0, di:di + N].float()
    Cmat = xBC[:, 0, di + N:].float()
    dtv = ssd_kernel.softplus((dt[:, 0] + p["dt_bias"]).float())   # (B,H)
    a = -torch.exp(p["A_log"].float())
    dA = torch.exp(dtv * a)                                          # (B,H)
    S = cache["ssm"].float()
    S = S * dA[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dtv,
                                                Bmat, xs)
    y = torch.einsum("bn,bhpn->bhp", Cmat, S)
    y = y + p["D"].float()[None, :, None] * xs
    y = y.reshape(Bsz, 1, di).to(cfg.cdtype)
    y = rms_norm(y * silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(cfg.cdtype)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(S)
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None, device=None):
    dtype = dtype or torch.float32
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=cfg.cdtype, device=dev),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=dev),
    }
