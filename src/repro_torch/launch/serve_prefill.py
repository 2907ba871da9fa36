"""Prefill serving of an LM: the driver of the port's SWA slice (a dense
LM with sliding-window attention), of its SSD slice (mamba2), of the
hybrid family (zamba2, whose mamba blocks run the SSD kernel) and of the
rest of the zoo: the moe family (deepseek: MLA and routed experts), the
encdec family (seamless: the encoder over seeded source frames, then the
decoder) and the vlm family (paligemma: seeded image-prefix embeddings
before the text, on the SWA kernel under long_500k).

The architecture's config goes through ``effective_config`` for the
``--shape`` (default ``long_500k``, which switches the dense archs to the
paper's sliding-window attention, window 4096). Weights are drawn from a
seeded ``torch.Generator`` on the device; the prompt is a numpy
``default_rng(0)`` draw. One batched prefill pass runs under
``torch.inference_mode()``, and the driver prints tokens/s, the greedy
next token of each request and the launches of each kernel route (one a
layer of that kind on the card; 0 on the CPU, where the plain versions
run). ``--prompt-len`` counts every position of a request: for the vlm
family the ``prefix_tokens`` image embeddings (normal draws of
``frontend_dim``) and the text tokens after them; for the encdec family
the source frames (normal draws of ``d_model``) and as many tokens.

Defaults: qwen3-4b at full width and depth, 2 requests x 16,384 tokens
(the long shape's 524,288-token decode cut to a prefill one card holds).
mamba2-780m at full width and depth, 4 requests of the prefill_32k shape
(its global batch of 32 cut to 4), and zamba2-7b the same way:

    PYTHONPATH=src python -m repro_torch.launch.serve_prefill \
        --arch mamba2-780m --shape prefill_32k --batch 4 --prompt-len 32768
    PYTHONPATH=src python -m repro_torch.launch.serve_prefill \
        --arch zamba2-7b --shape prefill_32k --batch 2 --prompt-len 8192
    PYTHONPATH=src python -m repro_torch.launch.serve_prefill \
        --arch paligemma-3b --batch 2 --prompt-len 16384
    PYTHONPATH=src python -m repro_torch.launch.serve_prefill \
        --arch seamless-m4t-large-v2 --shape prefill_32k --batch 2 \
        --prompt-len 8192

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_prefill \
          [--arch qwen3-4b] [--shape long_500k] [--batch 2] \
          [--prompt-len 16384] [--window W] [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import SHAPES, get_config, get_smoke
from ..device import resolve_device, synchronize
from ..kernels import (spmm_blocked_ell, spmm_csr_rows, ssd_chunk_out,
                       ssd_chunk_state, ssd_chunked, ssd_chunked_fma,
                       ssd_chunked_tc, ssd_state_scan, swa_attention,
                       swa_attention_fma, swa_attention_wgmma)
from ..models.common import ModelConfig, init_params, param_count
from ..models.lm import model_decls
from .steps import effective_config, make_prefill_step

SEED = 0              # weights (torch.Generator) and prompt (numpy)
# every kernel entry that counts its launches
COUNTERS = (swa_attention, swa_attention_wgmma, swa_attention_fma,
            ssd_chunked, ssd_chunked_tc, ssd_chunked_fma, ssd_chunk_state,
            ssd_state_scan, ssd_chunk_out, spmm_csr_rows, spmm_blocked_ell)


@dataclasses.dataclass
class PrefillResult:
    cfg: ModelConfig
    params: dict
    batch: dict                 # the step's batch on the device: tokens
                                # (B, S), + prefix_embeds or src_frames
    positions: int              # positions served: B x --prompt-len
    logits: torch.Tensor        # (B, 1, V) float32, last position
    next_tokens: torch.Tensor   # (B,) greedy
    seconds: float              # host clock around one synchronised pass
    kernel_launches: dict       # launches in the pass of each counted
                                # entry that launched

    @property
    def tokens(self) -> torch.Tensor:
        return self.batch["tokens"]

    @property
    def launches(self) -> int:
        """SWA kernel launches in the pass."""
        return self.kernel_launches.get("swa_attention", 0)

    @property
    def ssd_launches(self) -> int:
        """SSD chunk-scan calls in the pass."""
        return self.kernel_launches.get("ssd_chunked", 0)

    @property
    def tok_per_s(self) -> float:
        return self.positions / self.seconds


def _mixer(cfg: ModelConfig) -> str:
    ssd = (f"SSD state {cfg.ssm_state}, {cfg.ssm_heads} heads of "
           f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    att = (f"attention {cfg.attention}"
           f"{f' window {cfg.window}' if cfg.attention == 'swa' else ''}")
    if cfg.family == "moe":
        return (f"MLA of {cfg.n_heads} heads (q_lora {cfg.q_lora_rank}, "
                f"kv_lora {cfg.kv_lora_rank}, nope {cfg.head_dim}, rope "
                f"{cfg.rope_head_dim}, v {cfg.v_head_dim}); MoE of "
                f"{cfg.n_experts} experts top-{cfg.top_k} + "
                f"{cfg.n_shared_experts} shared, expert d_ff "
                f"{cfg.d_ff_expert}, after {cfg.n_dense_layers} dense "
                f"layers of d_ff {cfg.d_ff_dense}")
    if cfg.family == "encdec":
        return (f"encoder of {cfg.enc_layers} bidirectional layers, decoder "
                f"of {cfg.dec_layers} layers with cross-attention; {att}")
    if cfg.family == "vlm":
        return (f"prefix of {cfg.prefix_tokens} embeddings of "
                f"{cfg.frontend_dim}; {att}")
    return {"ssm": ssd, "hybrid": f"{ssd}; shared {att}"}.get(cfg.family,
                                                             att)


def serve_prefill(arch: str = "qwen3-4b", *, shape: str = "long_500k",
                  smoke: bool = False, batch: int = 2,
                  prompt_len: int = 16384, window: int | None = None,
                  device=None) -> PrefillResult:
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = effective_config(get_smoke(arch) if smoke else get_config(arch),
                           SHAPES[shape])
    if window is not None:
        cfg = cfg.replace(window=window)
    decls = model_decls(cfg)
    print(f"[model] {cfg.name}{' (smoke)' if smoke else ''} under {shape}: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{param_count(decls):,} parameters in {cfg.param_dtype}; "
          f"{_mixer(cfg)}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(decls, gen, dev, cfg.pdtype)
    rng = np.random.default_rng(SEED)
    n_text = prompt_len
    if cfg.family == "vlm":
        n_text = prompt_len - cfg.prefix_tokens
    prompt = rng.integers(0, cfg.vocab_size, (batch, n_text), dtype=np.int32)
    data = {"tokens": torch.from_numpy(prompt).to(dev)}
    if cfg.family == "vlm":
        data["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.prefix_tokens, cfg.frontend_dim),
            dtype=np.float32)).to(dev)
    if cfg.family == "encdec":
        data["src_frames"] = torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model), dtype=np.float32)).to(dev)
    step = make_prefill_step(cfg, device=dev)

    before = [f.launches for f in COUNTERS]
    synchronize(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = step(params, data)
    synchronize(dev)
    dt = time.perf_counter() - t0
    launched = {f.__name__: f.launches - n for f, n in zip(COUNTERS, before)
                if f.launches != n}
    res = PrefillResult(cfg, params, data, batch * prompt_len, logits,
                        logits[:, -1].argmax(dim=-1), dt, launched)
    print(f"[serve] {batch} requests x {prompt_len} positions in "
          f"{dt * 1e3:.1f} ms ({res.tok_per_s:.1f} tok/s); kernel launches "
          f"{launched}")
    print(f"[serve] greedy next tokens: {res.next_tokens.tolist()}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--shape", default="long_500k", choices=sorted(SHAPES),
                    help="the input shape whose effective config is served")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's small smoke config")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16384)
    ap.add_argument("--window", type=int, default=None,
                    help="default: the effective config's (4096)")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is no card)")
    args = ap.parse_args(argv)
    serve_prefill(args.arch, shape=args.shape, smoke=args.smoke,
                  batch=args.batch,
                  prompt_len=args.prompt_len, window=args.window,
                  device=args.device)
    print("[done]")


if __name__ == "__main__":
    main()
