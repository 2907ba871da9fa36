"""Shared by the decode and hybrid parity tests (tests/test_torch_decode.py,
tests/test_torch_hybrid.py): the reference's parameters carried to the
port, and the logits of a teacher-forced decode or of a prefill at every
position, from either package.

Parameters are the reference's ``init_params(PRNGKey(seed))``; the SSM
leaves that it initialises to 0 or 1 (A_log, D, dt_bias, conv_b, norm,
ln) are overwritten with numpy draws, so that a wrong sign of a or a
dropped D * x would show.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.models import lm as tlm
from repro_torch.models import lm_params_from_numpy
from repro_torch.models.layers import logits_from_hidden


def load_jref():
    jax = pytest.importorskip("jax")
    import repro.configs as configs
    import repro.models as models
    from repro.launch import steps
    from repro.models import attention, quant, ssm
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, configs=configs, models=models, steps=steps,
        attention=attention, ssm=ssm, quant=quant)


def draw_ssm_scalars(rng, block):
    """Overwrite the leaves of one (stacked) mamba block ``{"ln", "mix"}``
    that the reference initialises to 0 or 1."""
    mix = dict(block["mix"])
    draws = {"A_log": lambda s: rng.normal(size=s) * 0.5,
             "D": lambda s: 1 + rng.normal(size=s) * 0.5,
             "dt_bias": lambda s: rng.normal(size=s) * 0.5,
             "conv_b": lambda s: rng.normal(size=s) * 0.1,
             "norm": lambda s: 1 + rng.normal(size=s) * 0.2}
    for k, draw in draws.items():
        mix[k] = draw(np.shape(mix[k])).astype(np.asarray(mix[k]).dtype)
    ln = (1 + rng.normal(size=np.shape(block["ln"])) * 0.1).astype(
        np.asarray(block["ln"]).dtype)
    return {"ln": ln, "mix": mix}


def ref_params(jref, rcfg, seed=0):
    """The reference's parameters as a numpy tree, SSM scalars drawn."""
    jax = jref.jax
    tree = jax.tree.map(np.asarray, jref.models.init_params(
        jref.models.model_decls(rcfg, jref.models.CPU_AXES),
        jax.random.PRNGKey(seed), rcfg.pdtype))
    rng = np.random.default_rng(seed + 1)
    for k in sorted(tree):
        if k == "layers" and rcfg.family == "ssm" or k.startswith("mamba"):
            tree[k] = draw_ssm_scalars(rng, tree[k])
    return tree


def carried(jref, rcfg, cfg, seed=0):
    """(reference params as jnp arrays, the same params in the port)."""
    tree = ref_params(jref, rcfg, seed)
    return (jref.jax.tree.map(jref.jnp.asarray, tree),
            lm_params_from_numpy(tree, cfg, device="cpu"))


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def ref_decode_logits(jref, rcfg, params, toks, seq_len):
    """The reference's ``decode_step`` fed ``toks`` (B, S) one a step from
    position 0 against caches of ``seq_len`` positions -> (B, S, V)."""
    jax, jnp = jref.jax, jref.jnp
    step = jax.jit(lambda p, t, pos, c: jref.models.decode_step(
        p, t, pos, c, rcfg, jref.models.CPU_AXES, None))
    cache = jref.models.init_cache(rcfg, toks.shape[0], seq_len)
    out = []
    for pos in range(toks.shape[1]):
        logits, cache = step(params, jnp.asarray(toks[:, pos:pos + 1]),
                             jnp.int32(pos), cache)
        out.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(out, 1)


def port_decode_logits(cfg, params, toks, seq_len):
    """The port's ``decode_step``, as ``ref_decode_logits``."""
    out = []
    with torch.inference_mode():
        cache = tlm.init_cache(cfg, toks.shape[0], seq_len, device="cpu")
        t = torch.from_numpy(toks)
        for pos in range(toks.shape[1]):
            logits, cache = tlm.decode_step(params, t[:, pos:pos + 1], pos,
                                            cache, cfg)
            out.append(logits[:, 0].float().numpy())
    return np.stack(out, 1)


def port_prefill_logits(cfg, params, toks):
    """The port's ``forward`` over ``toks`` -> logits at every position."""
    with torch.inference_mode():
        h = tlm.forward(params, torch.from_numpy(toks), cfg)
        return logits_from_hidden(h, params, cfg).float().numpy()


def share_of_max(out, exp):
    """The largest difference as a share of the largest magnitude of
    ``exp``."""
    return float(np.abs(out - exp).max() / np.abs(exp).max())
