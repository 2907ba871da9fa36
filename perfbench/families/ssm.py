"""The ``ssm`` family: a stack of Mamba2 layers (mamba2-780m), each a
pre-norm Mamba2 mixer with a residual."""
from __future__ import annotations

import counts
from reference import lm as ref


def dims(cfg):
    """(inner width, heads, head size, state size) of the mixer."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    return di, di // cfg["ssm_head_dim"], cfg["ssm_head_dim"], \
        cfg["ssm_state"]


def layout(cfg) -> dict:
    d, W = cfg["d_model"], cfg["conv_width"]
    di, H, _, N = dims(cfg)
    n, ch = cfg["n_layers"], di + 2 * N
    return {"layers": {
        "ln": ((n, d), "ones"),
        "mix": {"in_proj": ((n, d, 2 * di + 2 * N + H), d),
                "conv_w": ((n, W, ch), W),
                "conv_b": ((n, ch), "zeros"),
                "A_log": ((n, H), "a_log"),
                "D": ((n, H), "ones"),
                "dt_bias": ((n, H), "dt_bias"),
                "norm": ((n, di), "ones"),
                "out_proj": ((n, di, d), di)}}}


def layers(params, cfg, prec="float32"):
    return [lambda x, i=i: ref.mamba_layer(ref.layer_slice(params["layers"],
                                                           i), x, cfg, prec)
            for i in range(cfg["n_layers"])]


def ssd_calls(cfg) -> int:
    return cfg["n_layers"]


def forward_flops(cfg, b, L) -> float:
    """The projections in and out, and the chunked scan (``counts.ssd_fwd``)."""
    d = cfg["d_model"]
    di, H, P, N = dims(cfg)
    proj = (2 * d * (2 * di + 2 * N + H) + 2 * di * d) * b * L
    scan = counts.ssd_fwd(b, L, H, P, N, min(cfg["ssm_chunk"], L))[1]
    return cfg["n_layers"] * (proj + scan)
