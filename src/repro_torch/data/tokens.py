"""Synthetic token data pipeline for LM training.

Deterministic, seekable (step -> batch) token stream with host-side
prefetching — seekability is what makes checkpoint/restart exact: on
restore, the stream resumes at the saved step with identical batches.
``synthetic_batch`` is the JAX package's, so both packages train on the
same bits; ``TokenStream`` places each batch on an explicit ``device`` as
int32 tensors, from a prefetch thread.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..device import resolve_device


def synthetic_batch(step: int, global_batch: int, seq_len: int,
                    vocab: int, *, seed: int = 1234) -> dict:
    """Deterministic batch for ``step`` (numpy, host)."""
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(step))
    tokens = rng.integers(0, vocab, (global_batch, seq_len), dtype=np.int32)
    # next-token labels with a synthetic learnable pattern (shift + mix) so
    # the loss actually decreases during the e2e example
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = tokens[:, 0]
    return {"tokens": tokens, "labels": labels}


class TokenStream:
    """Prefetching iterator: get(step) -> batch of int32 tensors on
    ``device`` (None is the card, as every entry point of the port)."""

    def __init__(self, global_batch: int, seq_len: int, vocab: int,
                 *, device=None, seed: int = 1234, prefetch: int = 2):
        self.gb, self.sl, self.vocab, self.seed = (global_batch, seq_len,
                                                   vocab, seed)
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = None
        self._stop = threading.Event()

    def _make(self, step: int):
        b = synthetic_batch(step, self.gb, self.sl, self.vocab,
                            seed=self.seed)
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def start(self, start_step: int = 0):
        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, self._make(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def get(self, step: int):
        """Next prefetched batch; falls back to synchronous build if the
        requested step is not the next in the queue (post-restore seek)."""
        if self._thread is not None:
            try:
                s, b = self._q.get(timeout=5.0)
                if s == step:
                    return b
            except queue.Empty:
                pass
        return self._make(step)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
