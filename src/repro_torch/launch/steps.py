"""Step builders (the train step, the prefill step, the serve (decode)
step), the config switch of the long shape, and the abstract inputs of a
step for the dry run.

``input_specs(cfg, shape, mesh)`` gives, for one rank of ``mesh`` (a
``launch/mesh.Mesh``; only its axis sizes are read), every input of the
step of ``shape`` as ``AbstractLeaf``s: the global shape, the dtype, the
spec that cuts it (the reference's rules, ``src/repro/launch/
steps.py:91-219``) and a meta tensor of the rank's shard. Nothing is
allocated.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import LONG_VIA_SWA, ShapeSpec
from ..device import resolve_device
from ..models import lm
from ..models.common import (CPU_AXES, AxisEnv, ModelConfig,
                             axis_env_for_mesh, param_specs, tree_leaves,
                             tree_map)
from ..models.layers import logits_from_hidden
from ..optim import (AdamWConfig, adamw_update, cosine_schedule,
                     opt_state_decls)
from ..tally import span


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
    and the loss is the global mean. On a model axis of more than one rank
    each layer splits its products over it (``models/tp.py``)."""
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
            with span("rt.train.forward"):
                loss = lm.lm_loss(params, batch, cfg, mesh=mesh)
            with span("rt.train.backward"):
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
                with span("rt.train.forward"):
                    l = lm.lm_loss(params, part, cfg, mesh=mesh)
                with span("rt.train.backward"):
                    l.backward()
                for (_, a), t in zip(tree_leaves(acc), leaves):
                    a.add_(_grad_of(t).to(a.dtype))
                    t.grad = None
                loss = loss + l.detach()
            grads = tree_map(lambda a: a / A, acc)
            loss = loss / A
        with span("rt.train.adamw"), torch.no_grad():
            lr_scale = cosine_schedule(opt_state["step"])
            params, opt_state, gn = adamw_update(params, grads, opt_state,
                                                 opt_cfg, lr_scale,
                                                 specs=specs, mesh=mesh)
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gn}

    return train_step


def make_prefill_step(cfg: ModelConfig, device=None, *, mesh=None):
    """A step ``(params, batch) -> (B, 1, V)`` float32 logits of the last
    position. ``batch["tokens"]`` is (B, S); the vlm family also reads
    ``batch["prefix_embeds"]`` (B, Sp, frontend_dim) and the encdec family
    ``batch["src_frames"]`` (B, Se, d_model), which it encodes first. Each
    is moved to ``device``.

    With ``mesh`` (a ``launch/dist.ProcessMesh``; ``device`` is its card)
    ``params`` are this rank's shards and ``batch`` the global batch, cut
    over the data axes as ``lm.lm_loss`` cuts it (all of it on every rank
    when B does not divide); the step returns the logits of this rank's
    rows, from the unembedding gathered whole, as the reference's output
    stays cut over data. The layers split their products over ``model``
    as in training (``models/tp.py``)."""
    if mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    lm.model_decls(cfg)                      # raises for an unknown family

    def prefill_step(params, batch):
        with span("rt.prefill"):
            return _prefill(params, batch)

    def _prefill(params, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        pm = mesh
        if pm is not None:
            pm = pm.for_batch(batch["tokens"].shape[0])
            batch = {k: pm.batch_shard(v) for k, v in batch.items()}
        kw = {}
        if cfg.family == "vlm":
            kw["prefix_embeds"] = batch["prefix_embeds"]
        if cfg.family == "encdec":
            kw["enc_out"] = lm.encode(params, batch["src_frames"], cfg, pm)
        h = lm.forward(params, batch["tokens"], cfg, mesh=pm, **kw)
        with span("rt.logits"):
            return logits_from_hidden(h[:, -1:],
                                      lm.unembedding(params, cfg, pm), cfg)

    return prefill_step


def make_serve_step(cfg: ModelConfig, device=None, *, mesh=None,
                    seq_len: int | None = None):
    """A step ``(params, token, pos, cache) -> (next token, cache)``: one
    ``lm.decode_step`` (the cache written in place; ``pos`` a Python int),
    then the greedy token of the last position as int32 (B, 1); ties go to
    the lowest id, as ``jnp.argmax``'s do.

    With ``mesh`` (a ``launch/dist.ProcessMesh``; ``device`` is its card)
    ``params`` and ``cache`` are this rank's shards (``init_cache_shards``
    of ``seq_len`` positions, a length that the shards do not tell)
    and ``token`` is the global (B, 1) batch, as the reference's arrays
    are global: each rank decodes its rows (``lm.decode_step(mesh=)``) and
    the next token comes back whole, gathered over the data axes. On a
    one-slot mesh the step is the unsharded one, bit for bit."""
    if mesh is not None:
        device = mesh.device
    resolve_device(device)
    lm.model_decls(cfg)                      # raises for an unknown family

    def serve_step(params, token, pos, cache):
        logits, cache = lm.decode_step(params, token, pos, cache, cfg,
                                       mesh=mesh, seq_len=seq_len)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        if mesh is not None:
            pm = mesh.for_batch(token.shape[0])
            if pm.split_data and pm.size("data") > 1:
                nxt = pm.all_gather(nxt, "data", 0)
        return nxt, cache

    return serve_step


def init_cache_shards(cfg: ModelConfig, batch: int, seq_len: int, mesh):
    """A rank's zero shards of ``lm.init_cache(cfg, batch, seq_len)`` on
    ``mesh`` (a ``launch/dist.ProcessMesh``, on its device), in the specs
    of ``_cache_sharding_tree``."""
    from .dist import local_shape
    specs = lm.cache_specs(cfg, batch, seq_len, mesh.ax)
    return tree_map(lambda t, sp: torch.zeros(
        local_shape(t.shape, sp, mesh.ax), dtype=t.dtype,
        device=mesh.device), lm.cache_shapes(cfg, batch, seq_len), specs)


# ---------------------------------------------------------------------------
# Abstract inputs (the dry run's; the reference's steps.py:91-219)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class AbstractLeaf:
    """One input leaf of a rank, the counterpart of the reference's
    ``jax.ShapeDtypeStruct`` with a ``NamedSharding``: the global
    ``shape``, the ``dtype``, the ``spec`` that cuts it at the axis sizes
    of ``ax``, and ``local``, a meta tensor of the rank's shard."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple
    ax: AxisEnv
    local: torch.Tensor

    @classmethod
    def of(cls, shape, dtype, spec, ax: AxisEnv) -> "AbstractLeaf":
        from .dist import local_shape
        return cls(tuple(shape), dtype, tuple(spec), ax,
                   torch.empty(local_shape(shape, spec, ax), dtype=dtype,
                               device="meta"))

    @property
    def nbytes(self) -> int:
        return self.local.numel() * self.local.element_size()


def abstract_leaves(tree, prefix: str = ""):
    """(path, AbstractLeaf) of an abstract tree, an int8 serving leaf as
    its codes (``path.q``) and scale (``path.s``)."""
    from ..models.quant import QuantizedArray
    for path, leaf in tree_leaves(tree, prefix):
        if isinstance(leaf, QuantizedArray):
            yield f"{path}.q", leaf.q
            yield f"{path}.s", leaf.s
        elif leaf is not None:
            yield path, leaf


def materialize(tree):
    """New meta tensors of the local shapes of an abstract tree (a step's
    arguments; an int8 leaf a ``QuantizedArray`` of them)."""
    from ..models.quant import QuantizedArray

    def one(leaf):
        if isinstance(leaf, QuantizedArray):
            return QuantizedArray(one(leaf.q), one(leaf.s))
        return torch.empty(leaf.local.shape, dtype=leaf.dtype, device="meta")
    return tree_map(one, tree)


def _batch_spec(ax: AxisEnv, b: int, extra=()):
    """Shard the batch dim over the data axes when divisible."""
    if b % ax.size(ax.dp) == 0:
        return (ax.dp, *extra)
    return (None, *extra)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Abstract train/prefill batch."""
    ax = axis_env_for_mesh(mesh)
    B, S = shape.global_batch, shape.seq_len
    bs = _batch_spec(ax, B, (None,))
    S_txt = (S - cfg.prefix_tokens) if cfg.family == "vlm" else S
    out = {"tokens": AbstractLeaf.of((B, S_txt), torch.int32, bs, ax),
           "labels": AbstractLeaf.of((B, S_txt), torch.int32, bs, ax)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = AbstractLeaf.of(
            (B, cfg.prefix_tokens, cfg.frontend_dim), cfg.cdtype,
            _batch_spec(ax, B, (None, None)), ax)
    if cfg.family == "encdec":
        out["src_frames"] = AbstractLeaf.of(
            (B, S, cfg.d_model), cfg.cdtype,
            _batch_spec(ax, B, (None, None)), ax)
    return out


def _cache_sharding_tree(cfg: ModelConfig, cache, mesh, batch: int):
    """Specs for a cache tree of (global) meta tensors, stacked layer dim
    leading: the batch dim over the data axes when it divides, else the
    longest remaining dim that divides; the last head or feature dim that
    divides over ``model`` (``lm.cache_spec``)."""
    ax = axis_env_for_mesh(mesh)
    return tree_map(lambda t: AbstractLeaf.of(
        t.shape, t.dtype, lm.cache_spec(t.shape, ax, batch), ax), cache)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Abstract (token, pos, cache) for the serve step."""
    ax = axis_env_for_mesh(mesh)
    B, S = shape.global_batch, shape.seq_len
    token = AbstractLeaf.of((B, 1), torch.int32,
                            _batch_spec(ax, B, (None,)), ax)
    pos = AbstractLeaf.of((), torch.int32, (), ax)
    cache = lm.init_cache(cfg, B, S, device="meta")
    return token, pos, _cache_sharding_tree(cfg, cache, mesh, B)


def abstract_state(cfg: ModelConfig, mesh, *, with_opt: bool = True):
    """Abstract (params, opt_state) of one rank, in the specs of
    ``lm.model_decls`` and ``opt_state_decls`` at the mesh's sizes."""
    ax = axis_env_for_mesh(mesh)
    decls = lm.model_decls(cfg, ax)
    params = tree_map(lambda d: AbstractLeaf.of(d.shape, d.dtype or cfg.pdtype,
                                                d.spec, ax), decls)
    if not with_opt:
        return params, None
    odecls = opt_state_decls(decls, AdamWConfig(
        state_dtype=cfg.opt_state_dtype))
    opt = tree_map(lambda d: AbstractLeaf.of(d.shape, d.dtype or
                                             torch.float32, d.spec, ax),
                   odecls)
    return params, opt


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """The full abstract argument tuple of the step kind of ``shape``:
    (params, opt_state, batch) to train, (params, batch) to prefill,
    (params, token, pos, cache) to decode, the params quantized where
    ``cfg.serve_quant == "int8"``."""
    cfg = effective_config(cfg, shape)
    if shape.step == "train":
        params, opt = abstract_state(cfg, mesh, with_opt=True)
        return (params, opt, batch_specs(cfg, shape, mesh))
    params, _ = abstract_state(cfg, mesh, with_opt=False)
    if shape.step == "prefill":
        return (params, batch_specs(cfg, shape, mesh))
    if cfg.serve_quant == "int8":
        from ..models.quant import abstract_quantize_params
        params = abstract_quantize_params(params)
    token, pos, cache = decode_specs(cfg, shape, mesh)
    return (params, token, pos, cache)


def step_fn(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(the step of ``shape``'s kind for one rank of ``mesh``, a
    ``launch/dist.ProcessMesh``; the indices of the arguments it updates
    in place)."""
    cfg = effective_config(cfg, shape)
    if shape.step == "train":
        return make_train_step(cfg, mesh=mesh), (0, 1)
    if shape.step == "prefill":
        return make_prefill_step(cfg, mesh=mesh), ()
    return make_serve_step(cfg, mesh=mesh, seq_len=shape.seq_len), (3,)
