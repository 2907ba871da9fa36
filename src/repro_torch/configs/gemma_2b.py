"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
GeGLU, head_dim=256, tied embeddings, sqrt(d) embed scale. [arXiv:2403.08295]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, activation="geglu",
    tie_embeddings=True, embed_scale=True, rope_theta=10000.0,
    fsdp=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, fsdp=False, loss_chunk=64, attn_block_k=64,
)
