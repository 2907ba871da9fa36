"""The two sides of tests/test_torch_dist.py, each run as a subprocess of
the test on one numpy input file:

  python tests/dist_harness.py ref  IN OUT   the reference on a (2, 2)
      mesh of 4 forced host devices (``repro.launch.mesh.make_mesh``: its
      axes are Auto; ``jax.make_mesh``'s Explicit axes make
      ``with_sharding_constraint`` raise under jax 0.9)
  python tests/dist_harness.py port IN OUT   the port: one gloo world of
      4 CPU processes on a (2, 2) mesh, one torch thread each, and one
      world of 1 process on a (1, 1) mesh

IN is a pickle of the numpy parameters, batches and decode prompts of
each case, and of two checkpoint directories (``"ckpt"``); OUT a pickle
of the losses,
gradients, updated parameters and AdamW states, whole (the port's
gathered over the groups that cut each leaf), the prefill step's
last-position logits of each case (the port's rows gathered over data),
and, on the port's side, the collectives that the first train step of
each ``TRAIN`` case counted (``repro_torch.tally``, by group and kind),
each rank's ``FlopCounterMode`` FLOPs of its loss and gradients, and the
leaves it gathered over ``model``. Every model copy is float32 with
``fsdp=True`` (``case_config``).

Each side also decodes every ``DECODE`` case at B 4 and at B 1
(``decode_config``): a teacher-forced prompt, then greedy tokens. The
reference runs ``decode_step`` jitted on its mesh with the caches placed
by its ``_cache_sharding_tree`` (deepseek at B 1 without a mesh: its
expert-parallel ``shard_map`` cannot cut one token over data) and returns
the tokens it fed, the logits of every step and its caches; the port's
worlds are fed the same tokens (``lm.decode_step(mesh=)``) and return
their logits (gathered over data), the caches (gathered after the run),
the router's top-k margins, and the collectives whose input was a cache
leaf. The (1, 1) world also runs the unsharded decode, and the (2, 2)
world counts one serve step's collectives and gathers its int8 leaves.

Checkpoints cross between the two sides: the reference saves the
``CKPT_CASE`` state after its train steps with its ``save_pytree`` into
``ckpt["ref"]``, which the port's (2, 2) world restores; the port's world
saves its own state of that case (``Checkpointer`` on the mesh) into
``ckpt["port"]``, which the test restores with the reference's
``restore_pytree``.
"""
import contextlib
import os
import pickle
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

# (name: arch): the vp loss, the routed experts with their aux, the train
# step, the hybrid family's shared attention gathered at each use, the
# encoder, the vlm prefix, the int8 AdamW state, GQA with qk-norm (qwen3:
# 4 query heads over 2 KV heads, one KV head a model rank). At tp 2 every
# layer splits its products over model (models/tp.py); gemma's and
# paligemma's one KV head is taken by both model ranks.
CASES = {"gemma": "gemma-2b", "deepseek": "deepseek-v3-671b",
         "mamba2": "mamba2-780m", "zamba2": "zamba2-7b",
         "seamless": "seamless-m4t-large-v2", "paligemma": "paligemma-3b",
         "gemma_int8": "gemma-2b", "qwen3": "qwen3-8b"}
# the cases that run the train step (the others the loss and its
# gradients), STEPS steps on one batch: the first runs at learning rate 0
# (the warmup's start), the second reads the moments the first wrote
TRAIN = ("mamba2", "gemma_int8")
STEPS = 2
CKPT_CASE = "gemma_int8"     # float32 params, int8 moments in global blocks
B, S = 4, 64
TIE_ULPS = 256       # tests/test_torch_zoo.py's near-tie margin


# the decode cases: every CASES entry, gemma_int8 serving int8 weights on
# a copy widened so that its projections qualify (d_model 256), and qwen3
# with sliding-window attention over a ring of 16 slots that its steps
# wrap; (prompt, generated) tokens of each, at each batch
DECODE = (*CASES, "qwen3_swa")
DECODE_BATCHES = (4, 1)
DECODE_LENGTHS = {"qwen3_swa": (8, 12)}
PROMPT, GENERATED = 6, 4
TALLY_CASE = "gemma"     # the decode case whose serve step is counted


def decode_config(configs, name):
    cfg = case_config(configs, "qwen3" if name == "qwen3_swa" else name)
    if name == "qwen3_swa":
        return cfg.replace(attention="swa", window=16)
    if name == "gemma_int8":
        return cfg.replace(d_model=256, d_ff=512, head_dim=64,
                           serve_quant="int8")
    return cfg


def decode_lengths(name):
    return DECODE_LENGTHS.get(name, (PROMPT, GENERATED))


def decode_params_of(inp, name):
    """The numpy parameters of a decode case."""
    base = "qwen3" if name == "qwen3_swa" else name
    return inp[base].get("decode_params", inp[base]["params"])


def case_config(configs, name):
    kw = {"param_dtype": "float32", "compute_dtype": "float32",
          "fsdp": True}
    if name.startswith("gemma"):
        kw["vocab_size"] = 512
    if name == "gemma_int8":
        kw["opt_state_dtype"] = "int8"
    # the train step over two microbatches (mamba2); one for deepseek,
    # whose smoke config accumulates 8 in bfloat16
    kw["grad_accum"] = 2 if name == "mamba2" else 1
    return configs.get_smoke(CASES[name]).replace(**kw)


def numpy_params(decls, leaves, seed):
    """A seeded numpy draw of every leaf of a port declaration tree
    (``leaves`` = ``common.tree_leaves``): normal / sqrt(fan_in), a leaf
    initialised to ones as 1 + 0.2 normal, to zeros as 0.1 normal, so
    that every gradient shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, d in leaves(decls):
        if d.init == "ones":
            a = 1 + 0.2 * rng.normal(size=d.shape)
        elif d.init == "zeros":
            a = 0.1 * rng.normal(size=d.shape)
        else:
            fan = d.fan_in or (d.shape[-2] if len(d.shape) >= 2
                               else d.shape[-1])
            a = rng.normal(size=d.shape) / np.sqrt(fan)
        out[path] = a.astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# The reference on (2, 2)
# ---------------------------------------------------------------------------
def run_ref(inp):
    # four host devices, each computing on one thread: the tier-1 run
    # shares the host's cores with five other test workers
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import jax
    import jax.numpy as jnp
    import repro.configs as configs
    from repro.checkpoint import save_pytree
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_prefill_step, make_train_step
    from repro.models import axis_env_for_mesh, lm_loss, model_decls
    from repro.models.common import ParamDecl
    from repro.optim import AdamWConfig, adamw_init

    mesh = make_mesh((2, 2), ("data", "model"))
    ax = axis_env_for_mesh(mesh)
    # the unsharded decode: one device, Auto axes as tests/test_torch_zoo.py
    one = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2, devices=jax.devices()[:1])
    out = {}
    for name in CASES:
        cfg = case_config(configs, name)
        flat, tdef = jax.tree_util.tree_flatten_with_path(
            model_decls(cfg, ax), is_leaf=lambda x: isinstance(x, ParamDecl))
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(inp[name]["params"][jax.tree_util.keystr(kp)])
            for kp, _ in flat])
        batch = {k: jnp.asarray(v) for k, v in inp[name]["batch"].items()}
        prefill = np.asarray(jax.jit(make_prefill_step(cfg, ax, mesh))(
            params, batch))
        if name in TRAIN:
            step = jax.jit(make_train_step(cfg, ax, mesh))
            opt = adamw_init(params, AdamWConfig(
                state_dtype=cfg.opt_state_dtype))
            ms = []
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch)
                ms.append(m)
            res = {"loss": tuple(float(m["loss"]) for m in ms),
                   "grad_norm": tuple(float(m["grad_norm"]) for m in ms),
                   "params": params, "state": opt}
            if name == CKPT_CASE:
                save_pytree({"opt": opt, "params": params, "step": STEPS},
                            inp["ckpt"]["ref"], STEPS)
        else:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: lm_loss(p, batch, cfg, ax, mesh)))(params)
            res = {"loss": float(loss), "grads": grads}
        res["prefill"] = prefill
        for k in ("params", "grads", "state"):
            if k in res:
                res[k] = {jax.tree_util.keystr(kp): np.asarray(v)
                          for kp, v in jax.tree_util.tree_flatten_with_path(
                              res[k])[0]}
        out[name] = res
    out["decode"] = {}
    for name in DECODE:
        cfg = decode_config(configs, name)
        flat, tdef = jax.tree_util.tree_flatten_with_path(
            model_decls(cfg, ax), is_leaf=lambda x: isinstance(x, ParamDecl))
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(decode_params_of(inp, name)[
                jax.tree_util.keystr(kp)]) for kp, _ in flat])
        if cfg.serve_quant == "int8":
            from repro.models.quant import quantize_params
            params = quantize_params(params)
            out["decode"][f"{name}/quantized"] = {
                jax.tree_util.keystr(kp): np.asarray(v) for kp, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        base = "qwen3" if name == "qwen3_swa" else name
        for B in DECODE_BATCHES:
            prompt = inp[base]["prompt"][:B, :decode_lengths(name)[0]]
            # one token of an expert-parallel MoE does not cut over data
            on = not (B == 1 and cfg.n_experts)
            m = mesh if on else one
            out["decode"][f"{name}/{B}"] = ref_decode(
                cfg, params, prompt, decode_lengths(name)[1],
                axis_env_for_mesh(m), m)
    return out


def ref_decode(cfg, params, prompt, gen, ax, mesh):
    """The reference's greedy decode of ``prompt`` (teacher-forced), then
    ``gen`` tokens: {"fed": the (B, P + gen - 1) tokens it fed, "logits":
    (B, P + gen - 1, V) float32, "cache": its final caches by path}."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import _cache_sharding_tree
    from repro.models import decode_step, init_cache
    B, P = prompt.shape
    L = P + gen
    cache = init_cache(cfg, B, L)
    if cfg.family == "encdec":
        cache["enc_out"] = jnp.ones((B, L, cfg.d_model), cfg.cdtype)
    if mesh is not None:
        placed = _cache_sharding_tree(cfg, jax.eval_shape(lambda: cache),
                                      mesh, B)
        cache = jax.device_put(cache, jax.tree.map(lambda a: a.sharding,
                                                   placed))
    step = jax.jit(lambda p, t, pos, c: decode_step(p, t, pos, c, cfg, ax,
                                                    mesh))
    tok, fed, logits = prompt[:, :1], [], []
    for pos in range(L - 1):
        fed.append(tok[:, 0])
        lg, cache = step(params, jnp.asarray(tok), jnp.int32(pos), cache)
        lg = np.asarray(lg[:, 0], np.float32)
        logits.append(lg)
        tok = (prompt[:, pos + 1:pos + 2] if pos + 1 < P
               else lg.argmax(-1).astype(np.int32)[:, None])
    return {"fed": np.stack(fed, 1), "logits": np.stack(logits, 1),
            "cache": {jax.tree_util.keystr(kp): np.asarray(v, np.float32)
                      for kp, v in jax.tree_util.tree_flatten_with_path(
                          cache)[0]}}


# ---------------------------------------------------------------------------
# The port on a gloo world
# ---------------------------------------------------------------------------
def collectives(pm):
    """Each collective's forward and gradient on rank-dependent inputs:
    x_r = rank + (0, 1, 2) * 0.5 and a cotangent weight c_r = 1 + rank *
    (1, 2, 3), so that every sum shows which ranks it took."""
    import torch
    r = float(pm.rank)
    base = torch.tensor([0.0, 0.5, 1.0])
    c = 1 + r * torch.tensor([1.0, 2.0, 3.0])
    out = {"coords": dict(pm.coords),
           "axis_index": {a: pm.axis_index(a) for a in ("data", "model")}}
    for axis in ("data", "model"):
        for name, fn in (("psum", lambda x: pm.psum(x, axis)),
                         ("enter", lambda x: pm.enter(x, axis)),
                         ("pmean", lambda x: pm.pmean(x, axis)),
                         ("gather0", lambda x: pm.all_gather(x, axis, 0)),
                         ("gather1", lambda x: pm.all_gather(
                             x.reshape(1, 3), axis, 1).reshape(-1))):
            x = (r + base).requires_grad_(True)
            y = fn(x)
            (y * torch.cat([c] * (y.numel() // 3))).sum().backward()
            out[f"{name}/{axis}"] = (y.detach().numpy(), x.grad.numpy())
        mx = pm.pmax(r + base, axis)
        out[f"pmax/{axis}"] = (mx.numpy(), mx.requires_grad)
    return out


# what each rank of the axis asks of a 6-column leaf cut 3 and 3 (``take``)
TAKE_RANGES = (((4, 6), (0, 1)), ((1, 5), (2, 4)))


def tp_collectives(pm):
    """``take``, ``allsum`` and ``own`` forward and gradient over each
    axis, on x_r = rank + (0, 1, 2) * 0.5 (``own`` on x_r and 1 + x_r,
    six values) against a cotangent weight c_r = 1 + rank * (1, ..., 9):
    every sum shows which ranks it took."""
    import torch
    r = float(pm.rank)
    c = 1 + r * torch.arange(1.0, 10.0)
    out = {}
    for axis in ("data", "model"):
        for name, fn in (
                ("take", lambda x: pm.take(x, axis, 0, TAKE_RANGES)),
                ("allsum", lambda x: pm.allsum(x, axis)),
                ("own", lambda x: pm.own(torch.cat([x, 1 + x]), axis, 0))):
            x = (r + torch.tensor([0.0, 0.5, 1.0])).requires_grad_(True)
            y = fn(x)
            (y * c[:y.numel()]).sum().backward()
            out[f"{name}/{axis}"] = (y.detach().numpy(), x.grad.numpy())
    return out


@contextlib.contextmanager
def model_gathers(pm, params):
    """The paths of the parameter leaves that ``ProcessMesh.gather`` takes
    over ``model`` inside the block (a leaf gathered over data first is
    followed to its model gather)."""
    from repro_torch.launch import dist
    from repro_torch.models.common import tree_leaves
    path_of = {t.untyped_storage().data_ptr(): p
               for p, t in tree_leaves(params)}
    via, seen, gather = {}, [], dist.ProcessMesh.gather

    def recording(self, t, spec, axes=(dist.DATA, dist.MODEL)):
        path = via.get(id(t), path_of.get(t.untyped_storage().data_ptr()))
        out = gather(self, t, spec, axes)
        if dist.MODEL in axes and dist.MODEL in self.spec_axes(spec):
            seen.append(path)
        elif path is not None:
            via[id(out)] = path
        return out

    dist.ProcessMesh.gather = recording
    try:
        yield seen
    finally:
        dist.ProcessMesh.gather = gather


def _port_case(pm, name, inp, ckpt):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs, tally
    from repro_torch.launch.dist import local_shape
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import lm
    from repro_torch.models import moe as pmoe
    from repro_torch.models.common import (param_specs, tree_from_leaves,
                                           tree_leaves, tree_map)
    from repro_torch.optim import AdamWConfig, adamw_init, opt_state_decls

    cfg = case_config(configs, name)
    decls = lm.model_decls(cfg, pm.ax)
    tree = tree_from_leaves(lm.model_decls(cfg), inp["params"])
    params = lm.shard_params(tree, decls, pm.ax, pm.coords, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    with torch.no_grad():
        logits = make_prefill_step(cfg, mesh=pm)(params, batch)
        if pm.for_batch(_rows(batch)).split_data:
            logits = pm.all_gather(logits, "data", 0)
    res = {"prefill": logits.numpy()}
    if name in TRAIN:
        ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        step = make_train_step(cfg, ocfg, mesh=pm)
        opt = adamw_init(params, ocfg, specs=param_specs(decls), mesh=pm)
        ms = []
        for i in range(STEPS):
            with (tally.counting() if i == 0 else contextlib.nullcontext()
                  ) as counted, model_gathers(pm, params) as seen:
                params, opt, m = step(params, opt, batch)
            if i == 0:
                res["tally"] = pm.collectives_by_axis(counted)
                res["model_gathers"] = seen
            ms.append(m)
        if name == CKPT_CASE:
            res.update(_checkpoints(pm, cfg, ocfg, params, opt, ckpt))
        sdecls = dict(tree_leaves(opt_state_decls(decls, ocfg)))
        with torch.no_grad():
            state = tree_map(lambda t, d: pm.gather(t, d.spec), opt,
                             opt_state_decls(decls, ocfg))
        res.update(loss=tuple(float(m["loss"]) for m in ms),
                   grad_norm=tuple(float(m["grad_norm"]) for m in ms),
                   params=lm.gather_params(params, cfg, pm), state=state,
                   # each state leaf against the local shape of its spec
                   state_shapes={p: (tuple(t.shape), local_shape(
                       sdecls[p].shape, sdecls[p].spec, pm.ax))
                       for p, t in tree_leaves(opt)})
    else:
        from repro_torch.launch import dist
        margins, pmax_calls = [], []
        route, pmax = pmoe.route, dist.ProcessMesh.pmax

        def counting(self, x, axis):
            pmax_calls.append(axis)
            return pmax(self, x, axis)

        def recording(xf, router_w, cfg):
            probs, gates, ids = route(xf, router_w, cfg)
            p = probs.detach().sort(dim=-1, descending=True).values
            k = cfg.top_k
            pk, pk1 = p[:, k - 1].numpy(), p[:, k].numpy()
            margins.append(float(((pk - pk1) / np.spacing(pk)).min()))
            return probs, gates, ids

        pmoe.route, dist.ProcessMesh.pmax = recording, counting
        try:
            for _, t in tree_leaves(params):
                t.requires_grad_(True)
            with FlopCounterMode(display=False) as fc, \
                    model_gathers(pm, params) as seen:
                loss = lm.lm_loss(params, batch, cfg, mesh=pm)
                loss.backward()
        finally:
            pmoe.route, dist.ProcessMesh.pmax = route, pmax
        res.update(flops=fc.get_total_flops(), model_gathers=seen)
        grads = tree_map(lambda t: t.grad, params)
        res.update(loss=float(loss), router_margin_ulps=margins,
                   vp_pmax_calls=len(pmax_calls),
                   grads=lm.gather_params(grads, cfg, pm))
    for k in ("params", "grads", "state"):
        if k in res:
            res[k] = {p: t.numpy() for p, t in tree_leaves(res[k])}
    return res


def _checkpoints(pm, cfg, ocfg, params, opt, ckpt):
    """The port's state saved on the mesh (rank 0 writes), and the
    reference's checkpoint restored into this rank's shards: each
    restored leaf's dtype, device and local shape against the template's,
    and the whole restored tree gathered."""
    from repro_torch.checkpoint import Checkpointer, gathered_leaves
    from repro_torch.models import lm
    from repro_torch.models.common import param_specs, tree_leaves
    from repro_torch.optim import opt_state_decls
    decls = lm.model_decls(cfg, pm.ax)
    specs = {"opt": param_specs(opt_state_decls(decls, ocfg)),
             "params": param_specs(decls), "step": ()}
    tree = {"opt": opt, "params": params, "step": STEPS}
    Checkpointer(ckpt["port"], mesh=pm, specs=specs).save(tree, STEPS,
                                                          blocking=True)
    got, step = Checkpointer(ckpt["ref"], mesh=pm, specs=specs
                             ).restore_latest({**tree, "step": 0})
    like = {p: (t.dtype, t.device, tuple(t.shape))
            for p, t in tree_leaves(tree) if hasattr(t, "dtype")}
    return {"ref_ckpt_step": step,
            "ref_ckpt_like_template": all(
                (t.dtype, t.device, tuple(t.shape)) == like[p]
                for p, t in tree_leaves(got) if p in like),
            "ref_ckpt": {p: np.asarray(t.numpy() if hasattr(t, "numpy")
                                       else t)
                         for p, t in gathered_leaves(got, specs, pm)}}


def _rows(batch) -> int:
    return batch["tokens"].shape[0]


@contextlib.contextmanager
def cache_collectives(cache):
    """The (kind, path) of each collective inside the block whose input is
    a leaf of ``cache`` (or a view of one): every all-gather, and the
    all-to-alls of ``take`` and ``recut``."""
    from repro_torch.launch import dist
    from repro_torch.models.common import tree_leaves
    path_of = {t.untyped_storage().data_ptr(): p
               for p, t in tree_leaves(cache)}
    seen = []
    gather, take, recut = (dist._gather, dist.ProcessMesh.take,
                           dist.ProcessMesh.recut)

    def note(kind, t):
        p = path_of.get(t.untyped_storage().data_ptr())
        if p is not None:
            seen.append((kind, p))

    def gathering(x, *a, **k):
        note("all-gather", x)
        return gather(x, *a, **k)

    def taking(self, x, *a, **k):
        note("take", x)
        return take(self, x, *a, **k)

    def recutting(self, x, *a, **k):
        note("recut", x)
        return recut(self, x, *a, **k)

    dist._gather, dist.ProcessMesh.take, dist.ProcessMesh.recut = (
        gathering, taking, recutting)
    try:
        yield seen
    finally:
        dist._gather, dist.ProcessMesh.take, dist.ProcessMesh.recut = (
            gather, take, recut)


def port_decode(cfg, params, fed, mesh=None):
    """The port's decode fed the tokens ``fed`` (B, steps): the logits of
    every step (all rows; the mesh's gathered over data), the final
    caches (gathered whole), the router's top-k margins in float32 ulps,
    and, on a mesh, the collectives that took a cache leaf."""
    import torch
    from repro_torch.launch.steps import init_cache_shards
    from repro_torch.models import lm
    from repro_torch.models import moe as pmoe
    from repro_torch.models.common import tree_leaves
    B, steps = fed.shape
    L = steps + 1
    margins, route = [], pmoe.route

    def recording(xf, router_w, c):
        probs, gates, ids = route(xf, router_w, c)
        p = probs.sort(dim=-1, descending=True).values
        pk, pk1 = p[:, c.top_k - 1].numpy(), p[:, c.top_k].numpy()
        margins.append(float(((pk - pk1) / np.spacing(pk)).min()))
        return probs, gates, ids

    pmoe.route = recording
    logits = []
    try:
        with torch.inference_mode():
            if mesh is None:
                cache = lm.init_cache(cfg, B, L, device="cpu")
            else:
                cache = init_cache_shards(cfg, B, L, mesh)
            if cfg.family == "encdec":
                cache["enc_out"].fill_(1)
            with (cache_collectives(cache) if mesh is not None
                  else contextlib.nullcontext([])) as seen:
                for pos in range(steps):
                    lg, cache = lm.decode_step(
                        params, torch.from_numpy(fed[:, pos:pos + 1]), pos,
                        cache, cfg, mesh=mesh, seq_len=L)
                    if mesh is not None and mesh.for_batch(B).split_data:
                        lg = mesh.all_gather(lg, "data", 0)
                    logits.append(lg[:, 0].numpy())
            if mesh is not None:
                specs = lm.cache_layout(cfg, cache, mesh.ax, B, L)
                cache = {p: mesh.gather(t, s) for (p, t), (_, s) in
                         zip(tree_leaves(cache), tree_leaves(specs))}
            else:
                cache = dict(tree_leaves(cache))
    finally:
        pmoe.route = route
    return {"logits": np.stack(logits, 1), "margins": margins,
            "cache_collectives": list(seen),
            "cache": {p: t.float().numpy() for p, t in cache.items()}}


def _decode_params(pm, inp, name, cfg, shard=True):
    """The case's parameters: the rank's shards (int8 ones quantized on
    the mesh), or one device's tree."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_from_leaves
    from repro_torch.models.quant import quantize_params
    tree = tree_from_leaves(lm.model_decls(cfg), decode_params_of(inp, name))
    if not shard:
        params = lm.lm_params_from_numpy(tree, cfg, device="cpu")
        return (quantize_params(params) if cfg.serve_quant == "int8"
                else params)
    decls = lm.model_decls(cfg, pm.ax)
    params = lm.shard_params(tree, decls, pm.ax, pm.coords, device="cpu")
    if cfg.serve_quant == "int8":
        params = quantize_params(params, mesh=pm, decls=decls)
    return params


def _decode_cases(pm, inp, ref_fed):
    """Every decode case on this world, fed the reference's tokens."""
    from repro_torch import configs
    out = {}
    for name in DECODE:
        cfg = decode_config(configs, name)
        params = _decode_params(pm, inp, name, cfg)
        for B in DECODE_BATCHES:
            out[f"{name}/{B}"] = port_decode(cfg, params,
                                             ref_fed[f"{name}/{B}"], pm)
    return out


def _decode_extras(pm, inp):
    """One serve step's collectives (``TALLY_CASE`` at B 4) and the int8
    case's codes and scales gathered whole."""
    import torch
    from repro_torch import configs, tally
    from repro_torch.launch.steps import init_cache_shards, make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.quant import QuantizedArray
    cfg = decode_config(configs, TALLY_CASE)
    params = _decode_params(pm, inp, TALLY_CASE, cfg)
    B, (P, G) = 4, decode_lengths(TALLY_CASE)
    with torch.inference_mode():
        cache = init_cache_shards(cfg, B, P + G, pm)
        tok = torch.from_numpy(inp[TALLY_CASE]["prompt"][:B, :1])
        with tally.counting() as counted:
            make_serve_step(cfg, mesh=pm, seq_len=P + G)(params, tok, 0,
                                                         cache)
    out = {"decode_tally": pm.collectives_by_axis(counted)}
    cfg = decode_config(configs, "gemma_int8")
    params = _decode_params(pm, inp, "gemma_int8", cfg)
    specs = dict(tree_leaves(lm.model_decls(cfg, pm.ax)))
    with torch.inference_mode():
        out["quantized"] = {
            p: (pm.gather(t.q, specs[p].spec).numpy(), t.s.numpy())
            for p, t in tree_leaves(params) if isinstance(t, QuantizedArray)}
    return out


def port_rank(pm, inp):
    import torch
    torch.set_num_threads(1)
    out = {"collectives": collectives(pm),
           "tp_collectives": tp_collectives(pm)}
    out["decode"] = _decode_cases(pm, inp, inp["decode_fed"])
    out.update(_decode_extras(pm, inp))
    for name in CASES:
        out[name] = _port_case(pm, name, inp[name], inp["ckpt"])
    # B 3 does not divide over the 2 data ranks: the batch is replicated
    three = {**inp["gemma"], "batch": {k: v[:3] for k, v in
                                        inp["gemma"]["batch"].items()}}
    out["gemma_rows3"] = _port_case(pm, "gemma", three, inp["ckpt"])
    return out


def one_device_rank(pm, inp):
    """The (1, 1) world: each case's mesh path, beside the unsharded
    path on the same process (the train step for every case)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import tree_from_leaves, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    out = {}
    for name in CASES:
        cfg = case_config(configs, name)
        ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        tree = tree_from_leaves(lm.model_decls(cfg), inp[name]["params"])
        for kind, kw in (("mesh", {"mesh": pm}), ("plain",
                                                  {"device": "cpu"})):
            params = lm.lm_params_from_numpy(tree, cfg, device="cpu")
            step = make_train_step(cfg, ocfg, **kw)
            opt = adamw_init(params, ocfg)
            ms = []
            for _ in range(STEPS):
                params, opt, m = step(params, opt, dict(inp[name]["batch"]))
                ms.append(m)
            out[f"{name}/{kind}"] = {
                "loss": [m["loss"].numpy() for m in ms],
                "grad_norm": [m["grad_norm"].numpy() for m in ms],
                "params": {p: t.numpy() for p, t in tree_leaves(params)}}
    # the decode: the (1, 1) mesh path beside the unsharded one
    out["decode/mesh"] = _decode_cases(pm, inp, inp["decode_fed"])
    out["decode/plain"] = {}
    for name in DECODE:
        cfg = decode_config(configs, name)
        params = _decode_params(pm, inp, name, cfg, shard=False)
        for B in DECODE_BATCHES:
            out["decode/plain"][f"{name}/{B}"] = port_decode(
                cfg, params, inp["decode_fed"][f"{name}/{B}"])
    return out


def raises_on_rank_one(pm):
    if pm.rank == 1:
        raise ValueError("rank one fails")
    return pm.rank


def run_port(inp):
    from repro_torch.launch import dist
    # the port's decode is fed the reference's tokens
    with open(inp["ref_out"], "rb") as f:
        ref = pickle.load(f)["decode"]
    inp["decode_fed"] = {k: v["fed"] for k, v in ref.items()
                         if "fed" in v}
    return {"2x2": dist.launch(port_rank, (2, 2), ("data", "model"), inp,
                               device="cpu", timeout=600),
            "1x1": dist.launch(one_device_rank, (1, 1), ("data", "model"),
                               inp, device="cpu", timeout=600)[0]}


if __name__ == "__main__":
    side, src, dst = sys.argv[1:4]
    with open(src, "rb") as f:
        inp = pickle.load(f)
    res = run_ref(inp) if side == "ref" else run_port(inp)
    with open(dst, "wb") as f:
        pickle.dump(res, f)
