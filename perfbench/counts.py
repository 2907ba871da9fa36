"""Frozen operation and byte counts of the configurations' work, and the
peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).

Model FLOPs count every matrix product of the architecture once per
application (each family's ``forward_flops``), the SSD scan's chunked
work (``ssd_fwd``) and the unembedding; a train step counts three
forwards (the backward two), the recompute of remat not at all. The SSD
counts read each input byte once and write each output byte once; they
are the operation's, not any kernel's, so they stay right whatever
implements the scan. Nothing here reads the program.
"""
from __future__ import annotations

import families
from weights import padded_vocab

BF16_FLOP_S = 989e12          # dense bf16 tensor cores
HBM_BYTE_S = 3.35e12          # HBM3


def ssd_fwd(b, L, H, P, N, Q, esize=2, param_esize=4):
    """(bytes, FLOPs) of one forward SSD call on x (b, L, H, P), dt (b, L,
    H) and B, C (b, L, N) of element size ``esize``, chunk Q: x, dt, B, C,
    A_log and D read once, y and the float32 final state written once;
    C B^T once per (batch, chunk), the causal triangle of C B^T and W x,
    and the chunk states and their read-out per head."""
    nc, tri = L // Q, Q * (Q + 1) // 2
    nbytes = (2 * b * L * H * P * esize + 2 * b * L * N * esize
              + b * L * H * esize + 2 * H * param_esize + b * H * P * N * 4)
    flops = 2.0 * b * nc * (tri * N + H * (tri * P + 2 * Q * P * N))
    return nbytes, flops


def ssd_bwd(b, L, H, P, N, Q, esize=2):
    """(bytes, FLOPs) of one backward SSD call: x, dy, B, C, the float32
    discretised steps and log decays and the states entering the chunks
    read once; dx, dB, dC, the steps' and log decays' gradients and the
    initial state's written once; the products of the chunked backward
    (dy^T C per head; C B^T, dG B and dG^T C on the causal triangle once
    per (batch, chunk); per head dW, W^T dy, C S^T, dy S, g B and x g)."""
    nc, tri = L // Q, Q * (Q + 1) // 2
    xs, bs, rows = b * L * H * P * esize, b * L * N * esize, b * L * H * 4
    st, fin = b * nc * H * P * N * 4, b * H * P * N * 4
    flops = (2.0 * b * nc * H * Q * P * N + 3.0 * b * nc * H * P * N
             + 2.0 * b * nc * (3 * tri * N
                               + H * (2 * tri * P + 4 * Q * P * N)))
    return 3 * xs + 4 * bs + 4 * rows + st + fin, flops


def least_s(nbytes, flops):
    """The least time of work on one card: bytes at HBM's rate or FLOPs at
    the bf16 tensor cores', whichever is longer."""
    return max(nbytes / HBM_BYTE_S, flops / BF16_FLOP_S)


def forward_flops(cfg, b, L, head_rows):
    """Model FLOPs of one forward over b rows of L tokens, with the
    unembedding applied to ``head_rows`` positions a row."""
    return families.load(cfg["family"]).forward_flops(cfg, b, L) \
        + 2 * cfg["d_model"] * padded_vocab(cfg) * b * head_rows


def step_flops(cfg, mix) -> float:
    """Model FLOPs of one unit of the mix's work: a prefill pass (logits
    of the last position) or a train step (three forwards)."""
    b, L = mix["batch"], mix["seq_len"]
    if mix["kind"] == "prefill":
        return forward_flops(cfg, b, L, 1)
    return 3 * forward_flops(cfg, b, L, L)


def ssd_least_s(cfg, mix) -> float:
    """The least time of the SSD work of one unit of the mix: each of the
    family's SSD calls a forward, and in training a backward too."""
    fam = families.load(cfg["family"])
    _, H, P, N = fam.dims(cfg)
    b, L = mix["batch"], mix["seq_len"]
    dims = (b, L, H, P, N, min(cfg["ssm_chunk"], L))
    t = least_s(*ssd_fwd(*dims))
    if mix["kind"] == "train":
        t += least_s(*ssd_bwd(*dims))
    return fam.ssd_calls(cfg) * t
