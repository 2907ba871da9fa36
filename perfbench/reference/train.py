"""Plain float32 reference of the train step the benchmark drives: the
next-token cross entropy over the whole padded vocabulary, averaged over
every position of the batch, its gradient by autograd (``rows`` rows at
a time, each layer under a checkpoint), and AdamW with global-norm
clipping at the warmup-cosine schedule, as ``launch/train.py`` trains.

Every product and the optimizer's arithmetic run in float32. The
parameters are held as the configuration states them, in bfloat16: each
update is computed in float32 from the bfloat16 values and rounded to
bfloat16 once, as a bfloat16 parameter stores it.
"""
from __future__ import annotations

import math

import torch

from . import lm


def lr_scale(step: int, warmup: int, total: int, min_ratio: float) -> float:
    """Linear warmup from 0 over ``warmup`` steps, then cosine decay to
    ``min_ratio``, at the optimizer's step count before the update."""
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5
                   * (1 + math.cos(math.pi * prog)))


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def rebuild(tree, flat, prefix=""):
    """``tree``'s dict structure with the leaves of ``flat`` (path ->
    leaf), the way back of ``dict(leaves(tree))``."""
    return {k: rebuild(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in tree.items()}


def train_steps(params, batches, cfg, opt: dict, schedule: dict, rows: int,
                prec: str = "float32"):
    """Run ``len(batches)`` steps from ``params`` (a tree of tensors whose
    values are the start; not modified). ``batches`` are (tokens, labels)
    pairs of (B, S). Returns {"loss": [each step's loss], "grad": {leaf:
    the first step's gradient, before the clip}, "change": {leaf: norm of
    the parameters' change over all the steps}}."""
    p = {k: t.detach().float().clone() for k, t in leaves(params)}
    start = {k: t.detach().clone() for k, t in leaves(params)}
    mu = {k: torch.zeros_like(t) for k, t in p.items()}
    nu = {k: torch.zeros_like(t) for k, t in p.items()}
    tree = rebuild(params, p)
    out = {"loss": [], "grad": {}, "change": {}}
    for k, (tokens, labels) in enumerate(batches):
        for t in p.values():
            t.requires_grad_(True)
            t.grad = None
        loss = 0.0
        for r in range(0, tokens.shape[0], rows):
            part = lm.loss_sum(tree, tokens[r:r + rows], labels[r:r + rows],
                               cfg, prec) / tokens.numel()
            part.backward()
            loss += float(part.detach())
        out["loss"].append(loss)
        grads = {n: t.grad for n, t in p.items()}
        if k == 0:
            out["grad"] = {n: g.clone() for n, g in grads.items()}
        adamw_step(p, grads, mu, nu, k, opt, schedule)
        for t in p.values():
            t.grad = None
            t.requires_grad_(False)
    for n, t in p.items():
        out["change"][n] = float((t - start[n].float()).norm())
    return out


@torch.no_grad()
def adamw_step(p, grads, mu, nu, k: int, opt: dict, schedule: dict):
    """Step ``k`` (from 0) of AdamW in place on the float32 tensors ``p``
    (values of bfloat16 parameters), ``mu`` and ``nu``: the gradients
    clipped to a global norm of ``grad_clip``, the bias-corrected update
    with decoupled weight decay at the learning rate of the schedule at
    step ``k``, each new value rounded to bfloat16."""
    b1, b2 = opt["b1"], opt["b2"]
    gn = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
    clip = min(opt["grad_clip"] / max(gn, 1e-12), 1.0)
    lr = opt["lr"] * lr_scale(k, **schedule)
    c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
    for n, t in p.items():
        g = grads[n] * clip
        mu[n].mul_(b1).add_((1 - b1) * g)
        nu[n].mul_(b2).add_((1 - b2) * g.square())
        delta = (mu[n] / c1) / ((nu[n] / c2).sqrt() + opt["eps"]) \
            + opt["weight_decay"] * t
        t.copy_((t - lr * delta).to(torch.bfloat16).float())


def gaps(prog: dict, ref: dict, floor: float = 1e-3) -> dict:
    """The numbers compared, each the worst leaf's. Against the larger of
    the reference's norm of that leaf and of the median leaf:
    ``grad_gap`` the gap between the norms of the program's and the
    reference's first gradient, ``grad_err`` the norm of their
    difference. ``change_gap``: the gap between the norms of a leaf's
    change over the steps, against the larger of the reference's change
    of that leaf and the median change of the leaves the reference
    moves, over the leaves whose reference gradient is at least
    ``floor`` times the median leaf's (smaller ones move by rounding
    alone). At the first steps' learning rates many bfloat16 leaves do
    not move at all, so the median over every leaf would be 0, and a
    leaf that moves one element by one ulp on one side would read 1.
    ``prog["grad"]`` holds the program's first gradient (each leaf on
    any device), ``prog["change"]`` its changes' norms."""
    g_ref = {n: float(g.norm()) for n, g in ref["grad"].items()}
    g_med = _median(g_ref.values())
    grad, err = 0.0, 0.0
    for n, g in ref["grad"].items():
        p = prog["grad"][n].to(g.device)
        scale = max(g_ref[n], g_med)
        grad = max(grad, _rel(float(p.norm()), g_ref[n], scale))
        err = max(err, _rel(float((p - g).norm()), 0.0, scale))
    counted = [n for n, g in g_ref.items() if g >= floor * g_med]
    moving = [ref["change"][n] for n in counted if ref["change"][n] > 0]
    c_med = _median(moving) if moving else 0.0
    change = max((_rel(prog["change"][n], ref["change"][n],
                       max(ref["change"][n], c_med)) for n in counted),
                 default=0.0)
    return {"grad_gap": grad, "grad_err": err, "change_gap": change}


def _median(values) -> float:
    return float(torch.tensor(list(values), dtype=torch.float64).median())


def _rel(a: float, b: float, scale: float) -> float:
    if scale > 0:
        return abs(a - b) / scale
    return 0.0 if a == b else math.inf
