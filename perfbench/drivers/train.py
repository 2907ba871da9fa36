"""Training: steps of ``batch`` rows of ``seq_len`` tokens through the
program's train step (``launch/steps.py:make_train_step``) with its AdamW
state, as ``launch/train.py`` trains.

Set-up draws the weights and a pool of ``pool`` distinct batches (tokens
and their next-token labels) from the seed on the card, builds the step
and the optimizer state, and drives that one object through its first
``checked_steps`` steps on the pool's first batches (which warm up the
window's only shape). It keeps what the check reads of them: each
leaf's first gradient, worked out from the moments after one step (mu =
(1 - b1) * clip * g, the clip from the step's gradient norm) and kept in
host memory, and the norm of each leaf's change after the last of them.
The window goes on with the same step, parameters and state, cycling
the pool, with no synchronise between steps. The check runs the float32
reference over the same weights (drawn again from the seed) and batches
and compares ``reference/train.py:gaps``.
"""
from __future__ import annotations

import sys
import time

import torch
from torch.profiler import record_function

import weights
from reference import lm as ref_lm
from reference import train as ref_train


class Driver:
    def __init__(self, cell, seed, dev, wrap_step=None):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.wrap = wrap_step
        self.cfg = cell.as_run
        self.mix = cell.mix

    def _batches(self):
        m = self.mix
        pool = weights.token_pool(self.seed, m["pool"], m["batch"],
                                  m["seq_len"] + 1, self.cfg["vocab_size"],
                                  self.dev)
        return [(b[:, :-1].contiguous(), b[:, 1:].contiguous())
                for b in pool]

    def setup(self):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.common import ModelConfig
        from repro_torch.optim import AdamWConfig, adamw_init
        m, cfg = self.mix, self.cfg
        self.params = weights.make(cfg, self.seed, self.dev)
        self.pool = self._batches()
        ocfg = AdamWConfig(**m["optimizer"],
                           state_dtype=cfg.get("opt_state_dtype", "float32"))
        self.opt = adamw_init(self.params, ocfg)
        step = make_train_step(ModelConfig(**cfg), ocfg, device=self.dev)
        self.step_fn = self.wrap(step) if self.wrap else step
        self.losses = []
        b1, clip_at = m["optimizer"]["b1"], m["optimizer"]["grad_clip"]
        got = {}
        for k in range(m["checked_steps"]):
            t0 = time.perf_counter()
            out = self._call(k)
            print(f"perfbench: set-up step {k + 1} "
                  f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
            if k == 0:
                clip = min(clip_at / max(float(out["grad_norm"]), 1e-12), 1.0)
                got["grad"] = {n: t.to("cpu", copy=True) / ((1 - b1) * clip)
                               for n, t in weights.leaves(self.opt["mu"])}
        # the start drawn again, after the steps' activations are freed,
        # so that no copy of it raises the run's peak
        start = dict(weights.leaves(weights.make(cfg, self.seed, self.dev)))
        got["change"] = {n: float((t.float() - start[n].float()).norm())
                         for n, t in weights.leaves(self.params)}
        self.got = got

    def _call(self, i):
        with record_function("perfbench.batch"):
            tokens, labels = self.pool[i % len(self.pool)]
        with record_function("perfbench.step"):
            self.params, self.opt, out = self.step_fn(
                self.params, self.opt, {"tokens": tokens, "labels": labels})
        return out

    def step(self, i):
        out = self._call(i + self.mix["checked_steps"])
        self.losses.append(out["loss"])
        return self.mix["batch"] * self.mix["seq_len"]

    def window_failures(self):
        return sum(int(not torch.isfinite(x)) for x in self.losses)

    def release(self):
        self.params = self.opt = self.step_fn = None

    def check(self):
        ref_lm.strict_float32()
        m = self.mix
        ref = ref_train.train_steps(
            weights.make(self.cfg, self.seed, self.dev),
            self.pool[:m["checked_steps"]], self.cfg, m["optimizer"],
            m["schedule"], m["reference_rows"])
        print("perfbench: change by leaf, program/reference: " + ", ".join(
            f"{n} {self.got['change'][n]:.6g}/{c:.6g}"
            for n, c in ref["change"].items()), file=sys.stderr)
        return ref_train.gaps(self.got, ref)
