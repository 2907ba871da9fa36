"""deepseek-v2-236b [moe] — 60L d_model=5120 128H MLA kv_lora=512,
MoE 160e top-6 (2 shared + 160 routed), expert d_ff=1536, vocab=102400,
first layer dense (d_ff=12288). [arXiv:2405.04434]"""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", attention="mla",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400, activation="swiglu",
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    n_dense_layers=1, d_ff_dense=12288,
    kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64, v_head_dim=128,
    fsdp=True, opt_state_dtype="int8",
    grad_accum=4, accum_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    n_experts=8, n_shared_experts=2, top_k=2, d_ff_expert=32,
    n_dense_layers=1, d_ff_dense=96, kv_lora_rank=32, q_lora_rank=48,
    rope_head_dim=8, v_head_dim=16, vocab_size=512, fsdp=False,
    loss_chunk=64, attn_block_k=64, opt_state_dtype="float32",
)
