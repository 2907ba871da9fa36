"""Model assembly, forward and decode, for every family of the JAX
package:

  dense  — (GQA/MQA attention + gated FFN) x N   (gemma, qwen, mistral)
  moe    — MLA attention + (dense FFN | routed experts)   (deepseek v2/v3):
           the leading ``n_dense_layers`` with a dense FFN of
           ``d_ff_dense``, then the MoE layers
  ssm    — (RMSNorm -> Mamba2 mixer -> residual) x N   (mamba2-780m)
  hybrid — [shared attention, mamba, mamba] macro-blocks   (zamba2): one
           attention block, its weights shared by every macro-block, and
           the mamba blocks stacked over the macro-blocks
  encdec — bidirectional encoder + causal decoder with cross-attention
           (seamless); the frontend is a stub, ``encode`` takes frames
  vlm    — the dense backbone behind projected prefix embeddings
           (paligemma); the vision frontend is a stub

Parameters are a nested dict shaped like the JAX package's pytree, with
the per-layer weights stacked along a leading layer axis; ``forward`` and
``decode_step`` walk the layers in a Python loop over views of that
stack, so the decode step's in-place cache writes land in the stacked
cache of ``init_cache``. ``_forward`` returns the hidden states and the
MoE router's aux loss summed over the layers, as the reference's
``forward`` does; ``lm_loss`` (the training loss) reads both, and the
public ``forward`` returns the hidden states only. Under ``cfg.remat``
and grad each layer body is one ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body), so the backward keeps
one (B, S, d) input a layer and recomputes the rest.
``lm_params_from_numpy`` carries the reference's parameters across.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import tp
from .common import (CPU_AXES, AxisEnv, ModelConfig, ParamDecl, fsdp_spec,
                     param_specs, tree_from_leaves, tree_leaves, tree_map)
from .layers import (chunked_softmax_xent, embed_apply, embed_decls,
                     ffn_apply, ffn_decls, logits_from_hidden, norm_decl,
                     rms_norm)


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------
def _attn_block_decls(cfg: ModelConfig, stack: int | None, *, d_ff=None,
                      moe=False, mla=False, ax: AxisEnv = CPU_AXES):
    st = () if stack is None else (stack,)
    return {"ln1": ParamDecl(st + (cfg.d_model,), init="ones"),
            "ln2": ParamDecl(st + (cfg.d_model,), init="ones"),
            "attn": (mla_mod.mla_decls(cfg, stack, ax=ax) if mla
                     else attn.attn_decls(cfg, stack, ax=ax)),
            "ffn": (moe_mod.moe_decls(cfg, stack, ax=ax) if moe
                    else ffn_decls(cfg, d_ff, stack, ax=ax))}


def _mamba_block_decls(cfg: ModelConfig, stack: int | None, *,
                       ax: AxisEnv = CPU_AXES):
    st = () if stack is None else (stack,)
    return {"ln": ParamDecl(st + (cfg.d_model,), init="ones"),
            "mix": ssm_mod.ssm_decls(cfg, stack, ax=ax)}


def model_decls(cfg: ModelConfig, ax: AxisEnv = CPU_AXES):
    decls: dict[str, Any] = dict(embed_decls(cfg, ax))
    decls["final_norm"] = norm_decl(cfg.d_model)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        decls["layers"] = _attn_block_decls(cfg, cfg.n_layers, ax=ax)
        if fam == "vlm" and cfg.frontend_dim:
            decls["vision_proj"] = ParamDecl(
                (cfg.frontend_dim, cfg.d_model),
                (None, fsdp_spec(cfg, ax, cfg.d_model)),
                fan_in=cfg.frontend_dim)
    elif fam == "moe":
        nd = cfg.n_dense_layers
        if nd:
            decls["dense_layers"] = _attn_block_decls(
                cfg, nd, d_ff=cfg.d_ff_dense or cfg.d_ff, mla=True, ax=ax)
        if cfg.n_layers - nd > 0:
            decls["moe_layers"] = _attn_block_decls(
                cfg, cfg.n_layers - nd, moe=True, mla=True, ax=ax)
    elif fam == "ssm":
        decls["layers"] = _mamba_block_decls(cfg, cfg.n_layers, ax=ax)
    elif fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        decls["shared_attn"] = _attn_block_decls(cfg, None, ax=ax)
        for i in range(pat.count("m")):
            decls[f"mamba{i}"] = _mamba_block_decls(cfg, n_macro, ax=ax)
    elif fam == "encdec":
        decls["enc_layers"] = _attn_block_decls(cfg, cfg.enc_layers, ax=ax)
        dec = _attn_block_decls(cfg, cfg.dec_layers, ax=ax)
        dec["ln_x"] = ParamDecl((cfg.dec_layers, cfg.d_model), init="ones")
        dec["xattn"] = attn.attn_decls(cfg, cfg.dec_layers, ax=ax)
        decls["dec_layers"] = dec
        decls["enc_final_norm"] = norm_decl(cfg.d_model)
    else:
        raise ValueError(fam)
    return decls


def _hybrid(cfg: ModelConfig):
    """(the macro-block pattern, the number of macro-blocks)."""
    pat = cfg.hybrid_pattern or "amm"
    return pat, cfg.n_layers // len(pat)


def lm_params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The reference's parameter pytree (numpy arrays, ``layers`` stacked)
    -> the port's parameters on ``device``. Each leaf keeps its dtype;
    bfloat16 goes through float32, which is exact both ways. Shapes are
    checked against ``model_decls(cfg)``."""
    dev = resolve_device(device)
    want = dict(tree_leaves(model_decls(cfg)))
    got = dict(tree_leaves(tree))
    if want.keys() != got.keys():
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(want.keys() - got.keys())}, extra "
                         f"{sorted(got.keys() - want.keys())}")
    for path, a in got.items():
        if tuple(np.shape(a)) != tuple(want[path].shape):
            raise ValueError(f"{path}: shape {np.shape(a)} != "
                             f"{want[path].shape}")

    return tree_map(lambda a: _from_numpy(a, dev), tree)


def _from_numpy(a, dev):
    a = np.asarray(a)
    dtype = (torch.bfloat16 if a.dtype.name == "bfloat16"
             else getattr(torch, a.dtype.name))
    return torch.from_numpy(np.array(a, np.float32)).to(device=dev,
                                                        dtype=dtype)


def shard_params(tree, decls, ax: AxisEnv, coords: dict, device=None):
    """The reference's full parameter leaves (numpy, as
    ``lm_params_from_numpy`` takes them) -> the shards that the rank at
    ``coords`` (axis name -> index) holds under ``decls``' specs at the
    sizes of ``ax``, on ``device``."""
    from ..launch.dist import shard
    dev = resolve_device(device)
    specs = dict(tree_leaves(param_specs(decls)))
    got = dict(tree_leaves(tree))
    if specs.keys() != got.keys():
        raise ValueError(f"parameter tree mismatch: "
                         f"{sorted(specs.keys() ^ got.keys())}")
    return tree_from_leaves(tree, {
        path: _from_numpy(shard(np.asarray(a), specs[path], ax, coords), dev)
        for path, a in got.items()})


def gather_params(params, cfg: ModelConfig, mesh):
    """The way back of ``shard_params``: every shard of a tree shaped like
    ``model_decls(cfg, mesh.ax)`` gathered over the groups of ``mesh`` (a
    ``launch/dist.ProcessMesh``) that cut it, so each rank gets the whole
    tree."""
    specs = param_specs(model_decls(cfg, mesh.ax))
    with torch.no_grad():
        return tree_map(lambda t, s: mesh.gather(t, s).detach(), params,
                        specs)


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------
def _window(cfg: ModelConfig):
    return cfg.window if cfg.attention == "swa" else None


def attn_block(p, x, positions, cfg: ModelConfig, *, causal=True,
               moe=False, mla=False, mesh=None):
    """Pre-norm attention (GQA/MQA, or MLA) and FFN (dense, or routed
    experts) with residuals. Returns (x, aux): the routed experts' float32
    aux loss, 0 for a dense FFN. On a ``mesh`` (``launch/dist.
    ProcessMesh``) the routed experts are expert-parallel and, on a model
    axis of more than one rank, the attention and the dense or shared FFN
    split their products over it (``models/tp.py``): ``p`` holds the
    layer's leaves gathered over the data axes only, and x and the output
    are replicated over ``model``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mla:
        h = mla_mod.mla_train(p["attn"], h, positions, cfg, mesh=mesh)
    else:
        h = attn.attention_train(p["attn"], h, positions, cfg,
                                 window=_window(cfg), causal=causal,
                                 mesh=mesh)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe:
        h, aux = moe_mod.moe_ffn(p["ffn"], h, cfg, mesh=mesh)
    else:
        h, aux = ffn_apply(p["ffn"], h, cfg, mesh=mesh), _zero(x)
    return x + h, aux


def mamba_block(p, x, cfg: ModelConfig, mesh=None):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + ssm_mod.mamba_block(p["mix"], h, cfg, mesh=mesh)


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _layer(tree, i):
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda t: t[i], tree)


def _layers(tree):
    """Every layer of a stacked tree (none for ``None``), as views from one
    ``unbind`` a leaf. Its backward stacks the layers' gradients once;
    ``_layer`` under grad would add a zero-filled gradient of the whole
    leaf for each layer."""
    if tree is None:
        return []
    split = tree_map(lambda t: t.unbind(0), tree)
    n = len(next(tree_leaves(split))[1])
    return [tree_map(lambda s: s[i], split) for i in range(n)]


def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of the moe family's leading dense layers."""
    return cfg.replace(d_ff=cfg.d_ff_dense or cfg.d_ff)


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def _blocks(cfg: ModelConfig, x, bodies, mesh=None):
    """Run layer bodies ``body(x) -> (x, aux)`` in order; returns (x, the
    sum of their aux). Under ``cfg.remat`` and grad each body is one
    ``torch.utils.checkpoint``. On a model axis of more than one rank
    that cuts d_model, the residual between the bodies, which each
    checkpoint keeps for the backward, is cut over ``model`` along d (the
    reference's ``act_constraint``): each body gathers it at its entry
    and keeps its own slice at its exit, and runs replicated over
    ``model`` inside."""
    remat = cfg.remat and torch.is_grad_enabled()
    mesh = tp.tp_mesh(mesh)
    cut = (remat and mesh is not None
           and x.shape[-1] % mesh.size("model") == 0)
    if cut:
        bodies = [_cut_residual(body, mesh) for body in bodies]
        x = mesh.own(x, "model", -1)
    aux = _zero(x)
    for body in bodies:
        x, a = (checkpoint(body, x, use_reentrant=False) if remat
                else body(x))
        aux = aux + a
    if cut:
        x = mesh.all_gather(x, "model", x.dim() - 1)
    return x, aux


def _cut_residual(body, mesh):
    def cut(xl):
        x, a = body(mesh.all_gather(xl, "model", xl.dim() - 1))
        return mesh.own(x, "model", -1), a
    return cut


class _Leaves:
    """The parameters a forward reads, and their gather on a mesh.

    Without a mesh ``full`` returns its tree as it is. On a mesh
    (``launch/dist.ProcessMesh``) the layer bodies call it inside their
    checkpoint, so one layer's weights are resident at a time and the
    backward's recompute gathers again. On a model axis of more than one
    rank it gathers each shard over the data axes only, as FSDP does, and
    the layer splits its products over ``model`` (``models/tp.py``).
    With one model rank it gathers each shard over the axes that cut it;
    ``moe=True`` keeps the routed experts cut over ``model`` (E/ep local
    experts) and gathers them over the data axes only, as the reference's
    ``fsdp_gather``. ``top`` gathers a leaf outside the layer stacks
    whole."""

    def __init__(self, params, cfg: ModelConfig, mesh):
        self.params, self.mesh = params, mesh
        self.specs = (None if mesh is None else
                      param_specs(model_decls(cfg, mesh.ax)))

    def full(self, tree, specs, moe=False):
        if self.mesh is None:
            return tree
        if tp.tp_mesh(self.mesh) is not None:
            return self.mesh.gather_tree(tree, specs, ("data",))
        if not moe:
            return self.mesh.gather_tree(tree, specs)
        out = {k: self.mesh.gather_tree(v, specs[k])
               for k, v in tree.items() if k != "ffn"}
        out["ffn"] = {k: self.mesh.gather(
            v, specs["ffn"][k], ("data",) if k in ("wi", "wo")
            else ("data", "model")) for k, v in tree["ffn"].items()}
        return out

    def shared(self, name):
        """An unstacked layer tree (the hybrid's shared attention), as
        ``full`` gathers a layer's."""
        return self.full(self.params[name],
                         None if self.mesh is None else self.specs[name])

    def top(self, name):
        """A leaf outside the layer stacks, gathered whole."""
        if self.mesh is None:
            return self.params[name]
        return self.mesh.gather(self.params[name], self.specs[name])

    def layers(self, name):
        """(layer shards, their specs) of a stacked tree."""
        tree = self.params.get(name)
        spec = (None if self.mesh is None or tree is None
                else tree_map(lambda s: s[1:], self.specs[name]))
        return [(lp, spec) for lp in _layers(tree)]


def _forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None,
             enc_out=None, mesh=None):
    """``forward``, returning (final-norm hidden states, the aux loss summed
    over the layers: the MoE router's, float32 0 for other families).
    With ``mesh`` the inputs are this rank's batch rows and ``params`` its
    shards (see ``_Leaves``)."""
    pl = _Leaves(params, cfg, mesh)
    x = embed_apply({"embedding": pl.top("embedding")}, tokens, cfg)
    if cfg.family == "vlm" and prefix_embeds is not None:
        pe = prefix_embeds.to(cfg.cdtype)
        if cfg.frontend_dim:
            pe = pe @ pl.top("vision_proj").to(cfg.cdtype)
        x = torch.cat([pe, x], dim=1)
    positions = _positions(x)
    fam = cfg.family
    if fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        mambas = [pl.layers(f"mamba{mi}") for mi in range(pat.count("m"))]

        def macro(i):
            def body(h):
                a, mi = _zero(h), 0
                for ch in pat:
                    if ch == "a":
                        h, a0 = attn_block(pl.shared("shared_attn"), h,
                                           positions, cfg, mesh=mesh)
                        a = a + a0
                    else:
                        h = mamba_block(pl.full(*mambas[mi][i]), h, cfg,
                                        mesh)
                        mi += 1
                return h, a
            return body

        x, aux = _blocks(cfg, x, [macro(i) for i in range(n_macro)], mesh)
    elif fam == "moe":
        dcfg = _dense_cfg(cfg)
        x, aux = _blocks(cfg, x, [
            (lambda h, ls=ls: attn_block(pl.full(*ls), h, positions, dcfg,
                                         mla=True, mesh=mesh))
            for ls in pl.layers("dense_layers")], mesh)
        x, a1 = _blocks(cfg, x, [
            (lambda h, ls=ls: attn_block(pl.full(*ls, moe=True), h,
                                         positions, cfg, moe=True, mla=True,
                                         mesh=mesh))
            for ls in pl.layers("moe_layers")], mesh)
        aux = aux + a1
    elif fam == "encdec":
        # each decoder layer: the causal self-attention block (attention,
        # then FFN), then cross-attention to enc_out
        def dec(ls):
            def body(h):
                lp = pl.full(*ls)
                h, _ = attn_block(lp, h, positions, cfg, mesh=mesh)
                hx = rms_norm(h, lp["ln_x"], cfg.norm_eps)
                return h + _cross_attention(lp["xattn"], hx, enc_out,
                                            cfg, mesh), _zero(h)
            return body

        x, aux = _blocks(cfg, x, [dec(ls) for ls in pl.layers("dec_layers")],
                         mesh)
    elif fam == "ssm":
        x, aux = _blocks(cfg, x, [
            (lambda h, ls=ls: (mamba_block(pl.full(*ls), h, cfg, mesh),
                               _zero(h)))
            for ls in pl.layers("layers")], mesh)
    else:
        x, aux = _blocks(cfg, x, [
            (lambda h, ls=ls: attn_block(pl.full(*ls), h, positions, cfg,
                                         mesh=mesh))
            for ls in pl.layers("layers")], mesh)
    return rms_norm(x, pl.top("final_norm"), cfg.norm_eps), aux


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None,
            enc_out=None, mesh=None):
    """tokens: (B, S) integer tensor -> final-norm hidden states (B, S', d).
    prefix_embeds: (B, Sp, frontend_dim) for the vlm family, projected and
    put before the tokens (S' = Sp + S); enc_out: the encoder's hidden
    states (``encode``) that the encdec decoder cross-attends to. With
    ``mesh`` (a ``launch/dist.ProcessMesh``) the inputs are this rank's
    batch rows and ``params`` its shards."""
    return _forward(params, tokens, cfg, prefix_embeds=prefix_embeds,
                    enc_out=enc_out, mesh=mesh)[0]


def unembedding(params, cfg: ModelConfig, mesh=None):
    """The tree ``layers.logits_from_hidden`` reads: the unembedding leaf
    (``embedding`` when tied, else ``lm_head``), gathered whole on a
    ``mesh``."""
    name = "embedding" if cfg.tie_embeddings else "lm_head"
    return {name: _Leaves(params, cfg, mesh).top(name)}


def encode(params, frames, cfg: ModelConfig, mesh=None):
    """Bidirectional encoder over precomputed frontend frames (B, S, d)."""
    pl = _Leaves(params, cfg, mesh)
    x = frames.to(cfg.cdtype)
    positions = _positions(x)
    x, _ = _blocks(cfg, x, [
        (lambda h, ls=ls: attn_block(pl.full(*ls), h, positions, cfg,
                                     causal=False, mesh=mesh))
        for ls in pl.layers("enc_layers")], mesh)
    return rms_norm(x, pl.top("enc_final_norm"), cfg.norm_eps)


def _cross_attention(p, x, enc_out, cfg: ModelConfig, mesh=None):
    """Queries from x, keys and values from enc_out; no RoPE, no mask. On
    a mesh whose heads divide over ``model`` (``attention.tp_heads``) each
    rank computes its own heads from column-parallel products of x and
    enc_out, and the partial product is summed over ``model``."""
    p, cfg, mesh = attn.tp_heads(p, cfg, mesh)
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    q = tp.proj(mesh, x, p["wq"].to(cfg.cdtype))
    k = tp.proj(mesh, enc_out, p["wk"].to(cfg.cdtype))
    v = tp.proj(mesh, enc_out, p["wv"].to(cfg.cdtype))
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    o = attn.flash_attention(q, k, v, scale=cfg.head_dim ** -0.5,
                             causal=False, block_k=cfg.attn_block_k)
    o, wo = o.reshape(B, S, cfg.q_dim), p["wo"].to(cfg.cdtype)
    return o @ wo if mesh is None else tp.row_parallel(mesh, o, wo)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def check_axes(ax, mesh):
    """The reference passes its axis environment beside its mesh; the
    port's ``ProcessMesh`` carries its own (``mesh.ax``), so an ``ax`` of
    the reference's signature must be that one."""
    if ax is not None and (mesh is None or ax != mesh.ax):
        raise ValueError(f"ax {ax} is not the mesh's axis environment "
                         f"{None if mesh is None else mesh.ax}")


def lm_loss(params, batch, cfg: ModelConfig, ax=None, mesh=None):
    """The training loss, a float32 scalar. ``batch``: tokens and labels
    (B, S) on the parameters' device, an optional float32 ``mask`` (ones
    by default), and the family's extra: ``prefix_embeds`` for the vlm
    family (the loss covers the text positions only), ``src_frames`` for
    the encdec family (encoded first). The masked mean of the chunked
    cross entropy, plus ``router_aux_weight`` times the summed aux loss for
    a model with experts.

    With ``mesh`` (a ``launch/dist.ProcessMesh``) ``params`` are this
    rank's shards and ``batch`` is the global batch: each rank takes its
    rows over the data axes (all of them when B does not divide), and the
    loss is the global mean, the same on every rank. ``ax``, the
    reference's argument, may only name ``mesh.ax``."""
    check_axes(ax, mesh)
    if mesh is not None:
        mesh = mesh.for_batch(batch["labels"].shape[0])
        batch = {k: mesh.batch_shard(v) for k, v in batch.items()}
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = batch["prefix_embeds"]
    if cfg.family == "encdec":
        kw["enc_out"] = encode(params, batch["src_frames"], cfg, mesh)
    h, aux = _forward(params, batch["tokens"], cfg, mesh=mesh, **kw)
    labels, mask = batch["labels"], batch.get("mask")
    if cfg.family == "vlm":
        h = h[:, -labels.shape[1]:]
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=h.device)
    loss_sum, cnt = chunked_softmax_xent(h, labels, mask, params, cfg,
                                         mesh=mesh)
    loss = loss_sum / cnt.clamp_min(1.0)
    if cfg.n_experts and cfg.router_aux_weight:
        loss = loss + cfg.router_aux_weight * aux
    return loss


# ---------------------------------------------------------------------------
# Decode (one new token against the caches)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Cache tree with a stacked leading layer dim per stack, zeros on
    ``device``. The encdec cache also holds ``enc_out`` (B, seq_len, d),
    which the caller fills with the encoder's output."""
    dev = resolve_device(device)
    w = _window(cfg)
    fam = cfg.family

    def stack(n, one):
        return tree_map(lambda a: a.new_zeros((n,) + a.shape), one)

    def kv(window=w):
        return attn.init_kv_cache(cfg, batch, seq_len, window=window,
                                  device=dev)

    if fam in ("dense", "vlm"):
        return {"layers": stack(cfg.n_layers, kv())}
    if fam == "moe":
        return {"layers": stack(cfg.n_layers, mla_mod.init_mla_cache(
            cfg, batch, seq_len, device=dev))}
    if fam == "ssm":
        return {"layers": stack(cfg.n_layers,
                                ssm_mod.init_ssm_cache(cfg, batch,
                                                       device=dev))}
    if fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        c = {"attn": stack(n_macro, kv())}
        for i in range(pat.count("m")):
            c[f"mamba{i}"] = stack(n_macro, ssm_mod.init_ssm_cache(
                cfg, batch, device=dev))
        return c
    if fam == "encdec":
        return {"self": stack(cfg.dec_layers, kv(None)),
                "enc_out": torch.zeros((batch, seq_len, cfg.d_model),
                                       dtype=cfg.cdtype, device=dev)}
    raise ValueError(fam)


def _attn_step(h, lp, lc, pos, cfg, *, moe=False, mla=False):
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    if mla:
        a, _ = mla_mod.mla_decode_step(lp["attn"], hn, pos, lc, cfg)
    else:
        a, _ = attn.attention_decode_step(lp["attn"], hn, pos, lc, cfg,
                                          window=_window(cfg))
    h = h + a
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if moe:
        f, _ = moe_mod.moe_ffn(lp["ffn"], hn, cfg)
    else:
        f = ffn_apply(lp["ffn"], hn, cfg)
    return h + f


def _dec_step(h, lp, lc, pos, enc_out, cfg):
    """One encdec decoder layer on one token: self-attention, then
    cross-attention, then the FFN (the reference's decode order; its
    forward runs the FFN before the cross-attention)."""
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    a, _ = attn.attention_decode_step(lp["attn"], hn, pos, lc, cfg)
    h = h + a
    hx = rms_norm(h, lp["ln_x"], cfg.norm_eps)
    h = h + _cross_attention(lp["xattn"], hx, enc_out, cfg)
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + ffn_apply(lp["ffn"], hn, cfg)


def _mamba_step(h, lp, lc, cfg):
    hn = rms_norm(h, lp["ln"], cfg.norm_eps)
    y, _ = ssm_mod.mamba_decode_step(lp["mix"], hn, lc, cfg)
    return h + y


def decode_step(params, token, pos: int, cache, cfg: ModelConfig):
    """token: (B,1) integer tensor; pos: its absolute position, a Python
    int. Writes the new token's entries into ``cache`` in place and
    returns (float32 logits (B,1,V), cache)."""
    x = embed_apply(params, token, cfg)
    fam = cfg.family
    if fam == "hybrid":
        pat, n_macro = _hybrid(cfg)
        for i in range(n_macro):
            mi = 0
            for ch in pat:
                if ch == "a":
                    x = _attn_step(x, params["shared_attn"],
                                   _layer(cache["attn"], i), pos, cfg)
                else:
                    name = f"mamba{mi}"
                    x = _mamba_step(x, _layer(params[name], i),
                                    _layer(cache[name], i), cfg)
                    mi += 1
    elif fam == "moe":
        nd = cfg.n_dense_layers
        dcfg = _dense_cfg(cfg)
        for i in range(cfg.n_layers):
            lc = _layer(cache["layers"], i)
            if i < nd:
                x = _attn_step(x, _layer(params["dense_layers"], i), lc,
                               pos, dcfg, mla=True)
            else:
                x = _attn_step(x, _layer(params["moe_layers"], i - nd), lc,
                               pos, cfg, moe=True, mla=True)
    elif fam == "encdec":
        for i in range(cfg.dec_layers):
            x = _dec_step(x, _layer(params["dec_layers"], i),
                          _layer(cache["self"], i), pos, cache["enc_out"],
                          cfg)
    else:
        for i in range(cfg.n_layers):
            lp, lc = _layer(params["layers"], i), _layer(cache["layers"], i)
            if fam == "ssm":
                x = _mamba_step(x, lp, lc, cfg)
            else:
                x = _attn_step(x, lp, lc, pos, cfg)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(h, params, cfg), cache
