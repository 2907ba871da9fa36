"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64. Mamba2 blocks + shared attention block (pattern a-m-m x27).
[arXiv:2411.15242]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, activation="swiglu",
    hybrid_pattern="amm", ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    fsdp=True,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
    fsdp=False, loss_chunk=64, attn_block_k=64,
)
