"""paligemma-3b [vlm] — SigLIP (stub) + gemma-2b backbone: 18L d_model=2048
8H (kv=1) d_ff=16384 vocab=257216, 256 image tokens. The vision frontend is a
STUB: input_specs() provides precomputed patch embeddings (B, 256, 1152)
projected into the backbone. [arXiv:2407.07726]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, activation="geglu",
    tie_embeddings=True, embed_scale=True,
    prefix_tokens=256, frontend_dim=1152,
    fsdp=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, prefix_tokens=8, frontend_dim=32,
    fsdp=False, loss_chunk=64, attn_block_k=64,
)
