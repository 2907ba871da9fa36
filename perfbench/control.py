"""The control of the correctness check, and the faults it must catch.

``control_step(cell)`` is the reference put in the program's place: a
step with the program's signature that computes with the reference in
float8 (``reference/lm.py``, ``prec="fp8"``), the precision below the
configurations' bfloat16; ``prefill_control_numbers`` reads it on the
prompts a prefill run checks. ``FAULTS[kind]`` wrap the program's step so
that it breaks as a later change might. A run with either in place of
the program has to come out not correct; ``calibrate.py`` reads their
numbers on the card, ``tests/`` at a small size on the CPU.
"""
from __future__ import annotations

import copy

import torch

from reference import lm as ref
from reference import train as ref_train


def _prefill_control(cell):
    """One prompt at a time, so that each prompt's logits, and each
    tensor's float8 scale, are the same whatever batch it came in."""
    cfg = cell.as_run

    def step(params, batch):
        return torch.cat([ref.last_logits(params, t[None], cfg, "fp8")
                          for t in batch["tokens"]])[:, None]
    return step


def prefill_control_numbers(drv) -> dict:
    """The numbers a run with the control in the program's place would
    compare, without its window: a served model's control need not
    serve, only answer the prompts the check reads. ``drv`` is a prefill
    driver; its window is taken to have served each batch of the pool
    once, and each prompt checked is answered by the control step."""
    step = control_step(drv.cell)
    drv.inputs()
    drv.outputs = [None] * len(drv.pool)
    drv.answer = lambda i, r: step(
        drv.params, {"tokens": drv.prompt(i, r)})[0, -1]
    return drv.check()


def _train_control(cell):
    cfg, mix = cell.as_run, cell.mix

    def step(params, opt, batch):
        flat = dict(ref_train.leaves(params))
        p = {n: t.detach().float().clone().requires_grad_(True)
             for n, t in flat.items()}
        tree = ref_train.rebuild(params, p)
        tokens, labels = batch["tokens"], batch["labels"]
        rows = mix["reference_rows"]
        loss = 0.0
        with torch.enable_grad():
            for r in range(0, tokens.shape[0], rows):
                part = ref.loss_sum(tree, tokens[r:r + rows],
                                    labels[r:r + rows], cfg, "fp8") \
                    / tokens.numel()
                part.backward()
                loss += float(part.detach())
        grads = {n: t.grad for n, t in p.items()}
        gn = float(sum(g.square().sum() for g in grads.values()).sqrt())
        p = {n: t.detach() for n, t in p.items()}
        mu = dict(ref_train.leaves(opt["mu"]))
        nu = dict(ref_train.leaves(opt["nu"]))
        ref_train.adamw_step(p, grads, mu, nu, int(opt["step"]),
                             mix["optimizer"], mix["schedule"])
        for n, t in flat.items():
            t.copy_(p[n])
        opt["step"] = opt["step"] + 1
        return params, opt, {"loss": torch.tensor(loss),
                             "grad_norm": torch.tensor(gn)}
    return step


def control_step(cell):
    return {"prefill": _prefill_control,
            "train": _train_control}[cell.mix["kind"]](cell)


# ---------------------------------------------------------------------------
# Faults: each wraps the program's step
# ---------------------------------------------------------------------------
def _answer_altered(step):
    """The first prompt is given the second prompt's logits."""
    def broken(params, batch):
        out = step(params, batch).clone()
        out[0] = out[1]
        return out
    return broken


def _prefill_half_batch(step):
    """Only the first half of the prompts is computed; the rest repeat
    its answers."""
    def broken(params, batch):
        half = batch["tokens"].shape[0] // 2
        out = step(params, {"tokens": batch["tokens"][:half]})
        return torch.cat([out, out], dim=0)[:batch["tokens"].shape[0]]
    return broken


def _state_unchanged(step):
    """The step computes on copies and returns its state unchanged."""
    def broken(params, opt, batch):
        _, _, out = step(copy.deepcopy(params), copy.deepcopy(opt), batch)
        return params, opt, out
    return broken


def _train_half_batch(step):
    """The step leaves out the second half of the batch: its loss and
    gradient are the mean over the first half."""
    def broken(params, opt, batch):
        half = batch["tokens"].shape[0] // 2
        return step(params, opt, {k: v[:half] for k, v in batch.items()})
    return broken


FAULTS = {
    "prefill": {"answer_altered": _answer_altered,
                "half_batch": _prefill_half_batch},
    "train": {"state_unchanged": _state_unchanged,
              "half_batch": _train_half_batch},
}
