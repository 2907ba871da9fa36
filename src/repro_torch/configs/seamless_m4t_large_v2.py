"""seamless-m4t-large-v2 [audio] — enc-dec 24L+24L d_model=1024 16H
d_ff=8192 vocab=256206. The speech frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d_model). [arXiv:2308.11596]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206, activation="swiglu",
    fsdp=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, fsdp=False,
    loss_chunk=64, attn_block_k=64,
)
