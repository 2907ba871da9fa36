"""The two sides of tests/test_torch_dist.py, each run as a subprocess of
the test on one numpy input file:

  python tests/dist_harness.py ref  IN OUT   the reference on a (2, 2)
      mesh of 4 forced host devices (``repro.launch.mesh.make_mesh``: its
      axes are Auto; ``jax.make_mesh``'s Explicit axes make
      ``with_sharding_constraint`` raise under jax 0.9)
  python tests/dist_harness.py port IN OUT   the port: one gloo world of
      4 CPU processes on a (2, 2) mesh, one torch thread each, and one
      world of 1 process on a (1, 1) mesh

IN is a pickle of the numpy parameters and batches of each case, and of
two checkpoint directories (``"ckpt"``); OUT a pickle of the losses,
gradients, updated parameters and AdamW states, whole (the port's
gathered over the groups that cut each leaf), the prefill step's
last-position logits of each case (the port's rows gathered over data),
and, on the port's side, the collectives that the first train step of
each ``TRAIN`` case counted (``repro_torch.tally``, by group and kind),
each rank's ``FlopCounterMode`` FLOPs of its loss and gradients, and the
leaves it gathered over ``model``. Every model copy is float32 with
``fsdp=True`` (``case_config``).

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
    return out


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


def port_rank(pm, inp):
    import torch
    torch.set_num_threads(1)
    out = {"collectives": collectives(pm),
           "tp_collectives": tp_collectives(pm)}
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
    return out


def raises_on_rank_one(pm):
    if pm.rank == 1:
        raise ValueError("rank one fails")
    return pm.rank


def run_port(inp):
    from repro_torch.launch import dist
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
