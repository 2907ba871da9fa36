"""Step builders: the train step, the prefill step, the serve (decode)
step, and the config switch of the long shape."""
from __future__ import annotations

import torch

from ..configs import LONG_VIA_SWA, ShapeSpec
from ..device import resolve_device
from ..models import lm
from ..models.common import (CPU_AXES, ModelConfig, param_specs,
                             tree_leaves, tree_map)
from ..models.layers import logits_from_hidden
from ..optim import AdamWConfig, adamw_update, cosine_schedule


def effective_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """long_500k switches dense archs to the paper's sliding-window attention."""
    if shape.name == "long_500k" and cfg.name in LONG_VIA_SWA:
        return cfg.replace(attention="swa", window=4096)
    return cfg


def _grad_of(t):
    """A leaf's gradient; zeros for a leaf the loss does not reach, as
    ``jax.grad`` gives."""
    return t.grad if t.grad is not None else torch.zeros_like(t)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    device=None, *, ax=None, mesh=None):
    """A step ``(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the gradient of ``lm.lm_loss`` over
    ``cfg.grad_accum`` microbatches (the batch's leading dim split evenly;
    with more than one the gradients are summed in ``cfg.accum_dtype`` and
    divided by their count), then ``adamw_update`` at the cosine schedule
    of ``opt_state["step"]``. The parameters (the port's stacked tree of
    leaf tensors, on ``device``) and the optimizer state are updated in
    place and returned; each leaf's ``.grad`` is cleared after the update.
    The batch's tensors (tokens, labels and the family's extras, as
    ``lm.lm_loss`` reads them) are moved to ``device``.

    With ``mesh`` (a ``launch/dist.ProcessMesh``; ``device`` is its
    card; ``ax``, the reference's argument, may only name ``mesh.ax``) the
    parameters and the state are this rank's shards (``dist.shard_init``,
    then ``adamw_init(..., specs=, mesh=)``), the batch is the global one
    (each microbatch is cut over the data axes inside ``lm_loss``), the
    gradients land on the shards, the clip reads the whole tree's norm,
    and the loss is the global mean."""
    lm.check_axes(ax, mesh)
    if mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    # raises for an unknown family
    specs = param_specs(lm.model_decls(
        cfg, CPU_AXES if mesh is None else mesh.ax))
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    A = max(cfg.grad_accum, 1)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        leaves = [t for _, t in tree_leaves(params)]
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        if A == 1:
            loss = lm.lm_loss(params, batch, cfg, mesh=mesh)
            loss.backward()
            grads = tree_map(_grad_of, params)
        else:
            adt = getattr(torch, cfg.accum_dtype)
            acc = tree_map(lambda t: torch.zeros(t.shape, dtype=adt,
                                                 device=t.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in range(A):
                part = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[mb]
                        for k, v in batch.items()}
                l = lm.lm_loss(params, part, cfg, mesh=mesh)
                l.backward()
                for (_, a), t in zip(tree_leaves(acc), leaves):
                    a.add_(_grad_of(t).to(a.dtype))
                    t.grad = None
                loss = loss + l.detach()
            grads = tree_map(lambda a: a / A, acc)
            loss = loss / A
        lr_scale = cosine_schedule(opt_state["step"])
        with torch.no_grad():
            params, opt_state, gn = adamw_update(params, grads, opt_state,
                                                 opt_cfg, lr_scale,
                                                 specs=specs, mesh=mesh)
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gn}

    return train_step


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
