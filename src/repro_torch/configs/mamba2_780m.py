"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    fsdp=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=32, fsdp=False, loss_chunk=64,
)
