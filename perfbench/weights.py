"""The benchmark's weights and token batches, made from ``--seed``.

``layout(cfg)`` is the parameter tree of a configuration's ``as_run``
numbers, in the layout the program's LM families take (per-layer leaves
stacked along a leading axis; the family's leaves from its module in
``families/``): each leaf its shape and its init, a normal draw scaled
by 1/sqrt(fan_in), ones, zeros, or Mamba2's published init of the SSM
heads (``A_INIT``, ``DT_INIT``: A uniform in [1, 16], softplus(dt_bias)
log-uniform in [0.001, 0.1] and at least 1e-4, the mamba_ssm
defaults). ``make`` draws every
normal leaf at once, in the served dtype on the device, as views of one
buffer filled by one call of a seeded ``torch.Generator``, then the SSM
heads' leaves, and so gives the same bits for the same seed on the same
device. Both sides of the correctness check are handed these tensors (or
a second ``make`` of the same seed); the reference reads their values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import families
from reference.train import leaves

A_INIT = (1.0, 16.0)
DT_INIT = (1e-3, 1e-1, 1e-4)          # min, max, floor

# the streams drawn from one --seed
WEIGHTS, DATA, SAMPLE = 0, 1, 2


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of ``stream`` (weights, data or the check's sample)
    derived from ``--seed``, any whole number (taken modulo 2**64)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, stream])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def padded_vocab(cfg) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def layout(cfg) -> dict:
    """{name: (shape, init)} nested like the parameters; init is a fan-in
    (a normal draw scaled by its inverse square root), "ones", "zeros",
    "a_log" or "dt_bias". The family's own leaves come from its module
    (``families/<family>.py``)."""
    d, V = cfg["d_model"], padded_vocab(cfg)
    out = {"embedding": ((V, d), d), "final_norm": ((d,), "ones")}
    if not cfg["tie_embeddings"]:
        out["lm_head"] = ((d, V), d)
    return {**out, **families.load(cfg["family"]).layout(cfg)}


def make(cfg, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameter tree drawn from ``seed`` on ``device`` in ``dtype``."""
    lay = layout(cfg)
    normal = [(p, s, i) for p, (s, i) in leaves(lay)
              if not isinstance(i, str)]
    total = sum(int(np.prod(s)) for _, s, _ in normal)
    gen = generator(seed, WEIGHTS, device)
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    views, off = {}, 0
    for path, shape, fan in normal:
        n = int(np.prod(shape))
        views[path] = buf[off:off + n].view(shape).mul_(fan ** -0.5)
        off += n

    def build(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = build(v, path + "/")
            elif v[1] == "ones":
                out[k] = torch.ones(v[0], dtype=dtype, device=device)
            elif v[1] == "zeros":
                out[k] = torch.zeros(v[0], dtype=dtype, device=device)
            elif v[1] in ("a_log", "dt_bias"):
                out[k] = _ssm_init(v[1], v[0], gen, device).to(dtype)
            else:
                out[k] = views[path]
        return out
    return build(lay)


def _ssm_init(kind, shape, gen, device):
    u = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "a_log":
        return u.uniform_(*A_INIT, generator=gen).log_()
    lo, hi, floor = DT_INIT
    dt = u.uniform_(math.log(lo), math.log(hi), generator=gen).exp_() \
        .clamp_min_(floor)
    return dt + torch.log(-torch.expm1(-dt))      # softplus(dt_bias) = dt


def token_pool(seed: int, n: int, batch: int, length: int, vocab: int,
               device) -> torch.Tensor:
    """(n, batch, length) int64 token ids, uniform over the vocabulary."""
    return torch.randint(0, vocab, (n, batch, length), device=device,
                         generator=generator(seed, DATA, device))
