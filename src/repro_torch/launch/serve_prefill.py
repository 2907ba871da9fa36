"""Prefill serving of an LM: the driver of the port's SWA slice (a dense
LM with sliding-window attention), of its SSD slice (mamba2) and of the
hybrid family (zamba2, whose mamba blocks run the SSD kernel).

The architecture's config goes through ``effective_config`` for the
``--shape`` (default ``long_500k``, which switches the dense archs to the
paper's sliding-window attention, window 4096). Weights are drawn from a
seeded ``torch.Generator`` on the device; the prompt is a numpy
``default_rng(0)`` draw. One batched prefill pass runs under
``torch.inference_mode()``, and the driver prints tokens/s, the greedy
next token of each request and the number of SWA and SSD kernel launches
(one a layer of that kind on the card; 0 on the CPU, where the plain
versions run).

Defaults: qwen3-4b at full width and depth, 2 requests x 16,384 tokens
(the long shape's 524,288-token decode cut to a prefill one card holds).
mamba2-780m at full width and depth, 4 requests of the prefill_32k shape
(its global batch of 32 cut to 4), and zamba2-7b the same way:

    PYTHONPATH=src python -m repro_torch.launch.serve_prefill \
        --arch mamba2-780m --shape prefill_32k --batch 4 --prompt-len 32768
    PYTHONPATH=src python -m repro_torch.launch.serve_prefill \
        --arch zamba2-7b --shape prefill_32k --batch 2 --prompt-len 8192

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
from ..kernels import ssd_chunked, swa_attention
from ..models.common import ModelConfig, init_params, param_count
from ..models.lm import model_decls
from .steps import effective_config, make_prefill_step

SEED = 0              # weights (torch.Generator) and prompt (numpy)


@dataclasses.dataclass
class PrefillResult:
    cfg: ModelConfig
    params: dict
    tokens: torch.Tensor        # (B, S) prompt on the device
    logits: torch.Tensor        # (B, 1, V) float32, last position
    next_tokens: torch.Tensor   # (B,) greedy
    seconds: float              # host clock around one synchronised pass
    launches: int               # SWA kernel launches in the pass
    ssd_launches: int           # SSD kernel launches in the pass

    @property
    def tok_per_s(self) -> float:
        return self.tokens.numel() / self.seconds


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
    ssd = (f"SSD state {cfg.ssm_state}, {cfg.ssm_heads} heads of "
           f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    att = (f"attention {cfg.attention}"
           f"{f' window {cfg.window}' if cfg.attention == 'swa' else ''}")
    mixer = {"ssm": ssd, "hybrid": f"{ssd}; shared {att}"}.get(cfg.family,
                                                               att)
    print(f"[model] {cfg.name}{' (smoke)' if smoke else ''} under {shape}: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{param_count(decls):,} parameters in {cfg.param_dtype}; {mixer}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(decls, gen, dev, cfg.pdtype)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)
    tokens = torch.from_numpy(prompt).to(dev)
    step = make_prefill_step(cfg, device=dev)

    before = swa_attention.launches, ssd_chunked.launches
    synchronize(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = step(params, {"tokens": tokens})
    synchronize(dev)
    dt = time.perf_counter() - t0
    res = PrefillResult(cfg, params, tokens, logits,
                        logits[:, -1].argmax(dim=-1), dt,
                        swa_attention.launches - before[0],
                        ssd_chunked.launches - before[1])
    print(f"[serve] {batch} requests x {prompt_len} tokens in "
          f"{dt * 1e3:.1f} ms ({res.tok_per_s:.1f} tok/s); swa_attention "
          f"launches {res.launches}, ssd_chunked launches "
          f"{res.ssd_launches}")
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
