"""Step builders: the prefill step, the serve (decode) step, and the
config switch of the long shape.

The train step waits for its slice (ROADMAP.md A.9).
"""
from __future__ import annotations

import torch

from ..configs import LONG_VIA_SWA, ShapeSpec
from ..device import resolve_device
from ..models import lm
from ..models.common import ModelConfig
from ..models.layers import logits_from_hidden


def effective_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """long_500k switches dense archs to the paper's sliding-window attention."""
    if shape.name == "long_500k" and cfg.name in LONG_VIA_SWA:
        return cfg.replace(attention="swa", window=4096)
    return cfg


def make_prefill_step(cfg: ModelConfig, device=None):
    """A step ``(params, batch) -> (B, 1, V)`` float32 logits of the last
    position. ``batch["tokens"]`` is (B, S); the vlm family also reads
    ``batch["prefix_embeds"]`` (B, Sp, frontend_dim) and the encdec family
    ``batch["src_frames"]`` (B, Se, d_model), which it encodes first. Each
    is moved to ``device``."""
    dev = resolve_device(device)
    lm.model_decls(cfg)                      # raises for an unknown family

    def prefill_step(params, batch):
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        kw = {}
        if cfg.family == "vlm":
            kw["prefix_embeds"] = torch.as_tensor(
                batch["prefix_embeds"]).to(dev)
        if cfg.family == "encdec":
            kw["enc_out"] = lm.encode(
                params, torch.as_tensor(batch["src_frames"]).to(dev), cfg)
        h = lm.forward(params, tokens, cfg, **kw)
        return logits_from_hidden(h[:, -1:], params, cfg)

    return prefill_step


def make_serve_step(cfg: ModelConfig, device=None):
    """A step ``(params, token, pos, cache) -> (next token, cache)``: one
    ``lm.decode_step`` (the cache written in place; ``pos`` a Python int),
    then the greedy token of the last position as int32 (B, 1)."""
    resolve_device(device)
    lm.model_decls(cfg)                      # raises for an unknown family

    def serve_step(params, token, pos, cache):
        logits, cache = lm.decode_step(params, token, pos, cache, cfg)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    return serve_step
