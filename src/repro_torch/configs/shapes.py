"""Assigned input shapes for the LM-family architectures (40 cells total)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention. Dense archs run it via the paper's
# sliding-window attention (window=4096); MLA (deepseek) and enc-dec
# (seamless) stay full-attention -> skipped (see DESIGN.md §4).
LONG_SKIP = {"deepseek-v3-671b", "deepseek-v2-236b", "seamless-m4t-large-v2"}
# Dense archs that switch to SWA for long_500k (the paper's technique):
LONG_VIA_SWA = {"gemma-2b", "qwen3-4b", "qwen3-8b", "mistral-large-123b",
                "paligemma-3b"}


def cells():
    """All (arch, shape) cells, including skipped ones (marked)."""
    from . import ARCHS
    out = []
    for arch in ARCHS:
        for s in SHAPES.values():
            skipped = s.name == "long_500k" and arch in LONG_SKIP
            out.append((arch, s.name, skipped))
    return out
