"""Training launcher: any architecture of the zoo, on one device or a mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \\
      --steps 30 [--ckpt-dir /tmp/ckpt] [--device cpu]

``--smoke`` runs the reduced same-family config; without it the full config
runs, on one card, or with ``--mesh DxM`` on a (data, model) mesh of D x M
cards: one process a card (``launch/dist.py``), each holding its shards of
the parameters and the AdamW state in the reference's layout, the batch
cut over data. ``--mesh`` with ``--device cpu`` runs the same on CPU
processes over gloo.
``--ckpt-dir`` works with or without ``--mesh``: on a mesh every rank
joins the save, each leaf is gathered whole and rank 0 writes it, in the
one-device layout, and a restart (on any mesh shape, or on one device)
cuts each rank's slice from the files.
``--shape`` routes the config through ``effective_config`` as the
reference's ``steps.step_fn`` routes a shape: ``--shape long_500k`` trains
the dense archs with sliding-window attention, window 4096, whose band
runs on the hand-written kernels forward and backward. Weights are drawn
from a seeded ``torch.Generator`` on the device; batches come from the
seekable ``TokenStream``. Restart is automatic: if the checkpoint dir holds
a committed step, training resumes from it with identical batches.

Full size on the card, qwen3-4b-swa4096 at 2 x 16,384 tokens:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --shape long_500k --steps 3 --batch 2 --seq 16384

and mamba2-780m at 16 x 4,096 (the SSD chunk scan's forward and backward
kernels; zamba2-7b the same way):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --steps 3 --batch 16 --seq 4096

qwen3-8b, which one card cannot hold with its AdamW state, on four cards,
checkpointing every 10 steps (a rerun of the same command resumes):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --mesh 2x2 --steps 30 --batch 8 --seq 4096 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..checkpoint import Checkpointer
from ..configs import SHAPES, get_config, get_smoke
from ..data import TokenStream
from ..device import resolve_device, synchronize
from ..kernels import (ssd_chunk_bwd_dstate, ssd_chunk_bwd_grads,
                       ssd_chunk_bwd_scan, ssd_chunk_bwd_tc_dbdc,
                       ssd_chunk_bwd_tc_dgs, ssd_chunk_bwd_tc_head,
                       ssd_chunk_bwd_tc_scan, ssd_chunked, ssd_chunked_bwd,
                       ssd_chunked_fma, ssd_chunked_tc, swa_attention,
                       swa_attention_bwd_dkdv,
                       swa_attention_bwd_dq, swa_attention_bwd_stats,
                       swa_attention_bwd_wgmma_dkdv,
                       swa_attention_bwd_wgmma_dq,
                       swa_attention_bwd_wgmma_stats, swa_attention_fma,
                       swa_attention_wgmma)
from ..models.common import (ModelConfig, init_params, param_count,
                             param_specs)
from ..models.lm import model_decls
from ..optim import AdamWConfig, adamw_init, opt_state_decls
from .dist import launch, shard_init
from .steps import effective_config, make_train_step

SEED = 0              # weights (torch.Generator on the device)
LOG_EVERY = 5         # a [train] line every LOG_EVERY steps and the last
# the kernel entries a training step can launch, each counting its launches
COUNTERS = (swa_attention, swa_attention_wgmma, swa_attention_fma,
            swa_attention_bwd_wgmma_stats, swa_attention_bwd_wgmma_dkdv,
            swa_attention_bwd_wgmma_dq, swa_attention_bwd_stats,
            swa_attention_bwd_dkdv, swa_attention_bwd_dq, ssd_chunked,
            ssd_chunked_tc, ssd_chunked_fma, ssd_chunked_bwd,
            ssd_chunk_bwd_dstate, ssd_chunk_bwd_scan, ssd_chunk_bwd_grads,
            ssd_chunk_bwd_tc_scan, ssd_chunk_bwd_tc_dgs,
            ssd_chunk_bwd_tc_dbdc, ssd_chunk_bwd_tc_head)


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    params: dict
    opt: dict
    start: int                  # first step run (after a resume)
    losses: dict                # step -> float loss
    grad_norms: dict            # step -> float grad norm
    seconds: dict               # step -> host clock of the synchronised step
    launches: dict              # step -> {entry: launches in that step}
    tokens_per_step: int


def train(cfg: ModelConfig, *, steps: int = 30, batch: int = 8,
          seq: int = 128, ckpt_dir=None, ckpt_every: int = 10,
          device=None, mesh=None) -> TrainResult:
    """Train ``cfg`` from a seeded init (or the newest committed checkpoint
    in ``ckpt_dir``) up to ``steps``; a checkpoint every ``ckpt_every``
    steps after the first. With ``mesh`` (a ``launch/dist.ProcessMesh``,
    every rank calling) the same seeded draws are cut to this rank's
    shards one leaf at a time, the checkpoint is the whole tree's
    (``checkpoint/ckpt.py``), and only rank 0 prints."""
    dev = resolve_device(device if mesh is None else mesh.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    log = mesh is None or mesh.rank == 0
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    specs = None
    if mesh is None:
        params = init_params(model_decls(cfg), gen, dev, cfg.pdtype)
        opt = adamw_init(params, ocfg)
    else:
        decls = model_decls(cfg, mesh.ax)
        params = shard_init(decls, gen, dev, cfg.pdtype, mesh.ax, mesh.coords)
        opt = adamw_init(params, ocfg, specs=param_specs(decls), mesh=mesh)
        specs = {"params": param_specs(decls),
                 "opt": param_specs(opt_state_decls(decls, ocfg)),
                 "step": ()}
    step_fn = make_train_step(cfg, ocfg, device=dev, mesh=mesh)

    start = 0
    ck = (Checkpointer(ckpt_dir, mesh=mesh, specs=specs) if ckpt_dir
          else None)
    if ck is not None:
        restored, s = ck.restore_latest({"params": params, "opt": opt,
                                         "step": 0})
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = int(restored["step"]) + 1
            if log:
                print(f"[train] resumed from committed step {s}")

    res = TrainResult(cfg, params, opt, start, {}, {}, {}, {}, batch * seq)
    stream = TokenStream(batch, seq, cfg.vocab_size, device=dev).start(start)
    t0 = time.perf_counter()
    try:
        for step in range(start, steps):
            b = stream.get(step)
            if cfg.family == "vlm":
                b["prefix_embeds"] = torch.ones(
                    (batch, cfg.prefix_tokens, cfg.frontend_dim),
                    dtype=torch.float32, device=dev)
            if cfg.family == "encdec":
                b["src_frames"] = torch.ones((batch, seq, cfg.d_model),
                                             dtype=torch.float32, device=dev)
            before = [f.launches for f in COUNTERS]
            synchronize(dev)
            ts = time.perf_counter()
            params, opt, m = step_fn(params, opt, b)
            res.losses[step] = float(m["loss"])
            res.grad_norms[step] = float(m["grad_norm"])
            synchronize(dev)
            res.seconds[step] = time.perf_counter() - ts
            res.launches[step] = {f.__name__: f.launches - n for f, n in
                                  zip(COUNTERS, before) if f.launches != n}
            if log and (step % LOG_EVERY == 0 or step == steps - 1):
                print(f"[train] step {step:5d} loss {res.losses[step]:.4f} "
                      f"gnorm {res.grad_norms[step]:.3f} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if ck is not None and step and step % ckpt_every == 0:
                ck.save({"params": params, "opt": opt, "step": step}, step)
    finally:
        stream.stop()
        if ck is not None:
            ck.wait()
    res.params, res.opt = params, opt
    return res


def _summary(res: TrainResult, dev) -> dict:
    """What ``main`` prints of a run, as plain data (a rank's return)."""
    return {"seconds": res.seconds, "launches": res.launches,
            "tokens_per_step": res.tokens_per_step,
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None)}


def _train_rank(pm, cfg, kw):
    """One rank of ``main --mesh``."""
    return _summary(train(cfg, mesh=pm, **kw), pm.device)


def _mesh_shape(text: str) -> tuple:
    try:
        d, m = (int(n) for n in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh {text!r}: expected DxM, e.g. 2x2") from None
    return d, m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES),
                    help="route the config through effective_config for "
                         "this shape (long_500k: SWA, window 4096)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is no card)")
    ap.add_argument("--mesh", type=_mesh_shape, default=None,
                    help="DxM: a (data, model) mesh, one process a slot "
                         "(a card, or a CPU process with --device cpu)")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.shape:
        cfg = effective_config(cfg, SHAPES[args.shape])
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    name = f"{cfg.name}{' (smoke)' if args.smoke else ''}"
    swa = (f", attention {cfg.attention} window {cfg.window}"
           if cfg.attention == "swa" else "")
    if args.mesh is not None:
        where = f"{args.mesh[0] * args.mesh[1]} devices"
    else:
        dev = resolve_device(args.device)
        where = str(dev)
    print(f"[train] {name}: {param_count(model_decls(cfg)) / 1e6:.1f}M "
          f"params on {where}{swa}", flush=True)
    if args.mesh is not None:
        ranks = launch(_train_rank, args.mesh, ("data", "model"), cfg, kw,
                       device=args.device)
    else:
        ranks = [_summary(train(cfg, device=dev, **kw), dev)]
    res = ranks[0]
    if res["seconds"]:
        last = max(res["seconds"])
        peaks = [r["peak_gib"] for r in ranks]
        print(f"[train] last step {res['seconds'][last] * 1e3:.1f} ms "
              f"({res['tokens_per_step'] / res['seconds'][last]:.1f} "
              f"tok/s); kernel launches {res['launches'][last]}"
              + (f"; peak GiB a card {peaks}" if peaks[0] else ""))
    print("[train] done")


if __name__ == "__main__":
    main()
