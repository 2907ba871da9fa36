"""Plain float32 reference of the LMs the benchmark runs: the embedding,
the layers in the order the family's module (``families/``) gives, the
final norm and the unembedding; the Mamba2 layer (mamba2-780m).

Written from the published equations (Mamba2's SSD, arXiv:2405.21060)
and from the configuration file's ``as_run`` numbers, in plain PyTorch:
no kernel, no cache, no batching tricks, nothing imported from the
program. Every product runs in float32 with TF32 off
(``strict_float32``).

``prec="fp8"`` is the control of the correctness check: the same
arithmetic with both operands of every weight product (the projections
and the unembedding) rounded to float8 e4m3, each tensor scaled by its
largest magnitude, the precision that would tempt a later change
of a bfloat16 model. Its gradient passes straight through the rounding.

Parameters are a nested dict of tensors in the benchmark's layout
(``perfbench/weights.py``), per-layer leaves stacked along a leading
axis; each layer's slice is cast to float32 when it is used, so a
bfloat16 tree costs no float32 copy of itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import families

FP8_MAX = 448.0            # largest finite float8 e4m3 value


def strict_float32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a, w, prec: str = "float32"):
    """a @ w in float32; ``prec="fp8"`` rounds both operands to e4m3."""
    a, w = a.float(), w.float()
    if prec == "fp8":
        a, w = _Fp8Round.apply(a), _Fp8Round.apply(w)
    return a @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def silu(x):
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# SSD (Mamba2's chunked state-space scan)
# ---------------------------------------------------------------------------
def ssd(x, dt, B, C, A_log, D, chunk: int):
    """x (b, L, H, P), dt (b, L, H) before softplus, B and C (b, L, N)
    shared by the heads, A_log and D (H,) -> y (b, L, H, P), float32.

    With a = -exp(A_log), dts = softplus(dt) and la the running sum of
    dts * a inside each chunk of ``chunk`` rows:
      y_s = sum_{t<=s in the chunk} (C_s . B_t) exp(la_s - la_t) dts_t x_t
            + exp(la_s) C_s . S_in + D x_s
      S_out = exp(la_end) S_in + sum_t exp(la_end - la_t) dts_t x_t B_t^T
    the state S (H, P, N) carried from chunk to chunk, zero at the start.
    """
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    nc = L // Q
    x, B, C = x.float(), B.float(), C.float()
    dts = F.softplus(dt.float())
    la = (dts * -torch.exp(A_log.float())).reshape(b, nc, Q, H).cumsum(2)
    dtc = dts.reshape(b, nc, Q, H)
    xc = x.reshape(b, nc, Q, H, P)
    Bc, Cc = B.reshape(b, nc, Q, N), C.reshape(b, nc, Q, N)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]          # (b,c,s,t,H)
    W = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    del seg
    W = W * torch.einsum("bcsn,bctn->bcst", Cc, Bc)[..., None] \
        * dtc[:, :, None]
    y = torch.einsum("bcsth,bcthp->bcshp", W, xc)
    del W
    w_end = torch.exp(la[:, :, -1:] - la) * dtc                 # (b,c,Q,H)
    s_chunk = torch.einsum("bctn,bcthp->bchpn", Bc, xc * w_end[..., None])
    S = x.new_zeros(b, H, P, N)
    s_in = []
    for c in range(nc):
        s_in.append(S)
        S = S * torch.exp(la[:, c, -1])[:, :, None, None] + s_chunk[:, c]
    s_in = torch.stack(s_in, 1)                                  # (b,c,H,P,N)
    y = y + torch.einsum("bcsn,bchpn->bcshp", Cc, s_in) \
        * torch.exp(la)[..., None]
    y = y + D.float()[:, None] * xc
    return y.reshape(b, L, H, P)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def mamba_mixer(p, x, cfg, prec="float32"):
    """Mamba2 mixer of one layer; ``p`` holds the layer's leaves."""
    b, L, _ = x.shape
    N, Pd, W = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["conv_width"]
    di = cfg["ssm_expand"] * cfg["d_model"]
    H = di // Pd
    h = mm(x, p["in_proj"], prec)
    z, xbc = h[..., :di], h[..., di:2 * di + 2 * N]
    dt = h[..., 2 * di + 2 * N:]
    # depthwise causal convolution over time, width W
    w = p["conv_w"].float()                                     # (W, ch)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[:, i:i + L] * w[i] for i in range(W))
    xbc = silu(conv + p["conv_b"].float())
    xs = xbc[..., :di].reshape(b, L, H, Pd)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    y = ssd(xs, dt + p["dt_bias"].float(), Bm, Cm, p["A_log"], p["D"],
            cfg["ssm_chunk"])
    y = rms_norm(y.reshape(b, L, di) * silu(z), p["norm"], cfg["norm_eps"])
    return mm(y, p["out_proj"], prec)


def mamba_layer(p, x, cfg, prec="float32"):
    return x + mamba_mixer(p["mix"], rms_norm(x, p["ln"], cfg["norm_eps"]),
                           cfg, prec)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def layer_slice(tree, i):
    """Layer ``i``'s leaves of a tree of per-layer stacked leaves."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unembedding(params, cfg):
    """(d, V_padded) float32 view of the unembedding."""
    if cfg["tie_embeddings"]:
        return params["embedding"].float().T
    return params["lm_head"].float()


def hidden(params, tokens, cfg, prec="float32", remat=False):
    """tokens (b, S) -> final-norm hidden states (b, S, d), float32. With
    ``remat`` each layer is one checkpoint (for the gradient)."""
    x = params["embedding"][tokens.long()].float()
    for fn in families.load(cfg["family"]).layers(params, cfg, prec):
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return rms_norm(x, params["final_norm"], cfg["norm_eps"])


@torch.no_grad()
def last_logits(params, tokens, cfg, prec="float32"):
    """Logits of the last position (b, V_padded), float32: what the
    prefill step returns."""
    h = hidden(params, tokens, cfg, prec)[:, -1]
    return mm(h, unembedding(params, cfg), prec)


def loss_sum(params, tokens, labels, cfg, prec="float32", chunk=1024):
    """Sum over every position of the cross entropy of the next-token
    label, over the whole padded vocabulary, float32; the logits are made
    ``chunk`` positions at a time under a checkpoint."""
    h = hidden(params, tokens, cfg, prec, remat=True)
    w = unembedding(params, cfg)

    def part(hc, yc):
        logits = mm(hc, w, prec)
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, yc[..., None].long())[..., 0]).sum()

    total = h.new_zeros(())
    for s0 in range(0, h.shape[1], chunk):
        total = total + checkpoint(part, h[:, s0:s0 + chunk],
                                   labels[:, s0:s0 + chunk],
                                   use_reentrant=False)
    return total

