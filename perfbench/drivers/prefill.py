"""Offline prefill: passes of ``batch`` prompts of ``seq_len`` tokens through
the program's prefill step (``launch/steps.py:make_prefill_step``), each
returning the float32 logits of every prompt's last position.

Set-up draws the weights and a pool of ``pool`` distinct batches from
the seed on the card and runs one pass (the warm-up of the only shape
the window uses). The window cycles the pool with no synchronise between
passes and keeps every pass's logits. The check draws ``check_rows``
distinct prompts served in the window from the seed, runs the float32
reference once over each, and compares the logits the window returned
for it: ``logit_err``, the norm of the difference over the whole
(padded) vocabulary relative to the norm of the reference's logits, the
worst prompt's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

import weights
from reference import lm as ref


class Driver:
    def __init__(self, cell, seed, dev, wrap_step=None):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.wrap = wrap_step
        self.cfg = cell.as_run
        self.mix = cell.mix

    def inputs(self):
        """The weights and the pool of batches, drawn from the seed."""
        m = self.mix
        self.params = weights.make(self.cfg, self.seed, self.dev)
        self.pool = weights.token_pool(self.seed, m["pool"], m["batch"],
                                       m["seq_len"], self.cfg["vocab_size"],
                                       self.dev)

    def setup(self):
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models.common import ModelConfig
        self.inputs()
        step = make_prefill_step(ModelConfig(**self.cfg), device=self.dev)
        self.step_fn = self.wrap(step) if self.wrap else step
        self.outputs = []
        with torch.inference_mode():
            self.step_fn(self.params, {"tokens": self.pool[0]})

    def step(self, i):
        with record_function("perfbench.batch"):
            tokens = self.pool[i % len(self.pool)]
        with record_function("perfbench.step"), torch.inference_mode():
            out = self.step_fn(self.params, {"tokens": tokens})
        self.outputs.append(out)
        return tokens.numel()

    def window_failures(self):
        return sum(int(not torch.isfinite(o).all()) for o in self.outputs)

    def release(self):
        self.step_fn = None

    def served(self):
        """(pass, row) of ``check_rows`` distinct prompts of the window,
        drawn from the seed; a prompt is (pool batch, row)."""
        rng = np.random.default_rng(weights.stream_seed(self.seed,
                                                        weights.SAMPLE))
        n, B, P = len(self.outputs), self.mix["batch"], len(self.pool)
        prompts = [(b, r) for b in range(min(n, P)) for r in range(B)]
        take = rng.choice(len(prompts), min(self.mix["check_rows"],
                                            len(prompts)), replace=False)
        out = []
        for j in sorted(take):
            b, r = prompts[j]
            passes = list(range(b, n, P))
            out.append((int(rng.choice(passes)), r))
        return out

    def prompt(self, i, r):
        """Prompt ``r`` of pass ``i``, (1, seq_len)."""
        return self.pool[i % len(self.pool)][r:r + 1]

    def answer(self, i, r):
        """The logits the window returned for prompt ``r`` of pass ``i``."""
        return self.outputs[i][r, -1].float()

    def check(self):
        ref.strict_float32()
        worst = 0.0
        for i, r in self.served():
            want = ref.last_logits(self.params, self.prompt(i, r),
                                   self.cfg)[0]
            got = self.answer(i, r)
            err = (got - want).norm() / want.norm()
            worst = max(worst, float(err))
        return {"logit_err": worst}
