"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA, MoE 256e top-8
(1 shared + 256 routed), expert d_ff=2048, vocab=129280, kv_lora=512,
q_lora=1536, first 3 layers dense (d_ff=18432). [arXiv:2412.19437]

int8 optimizer states: the full fp32-moment Adam state would not fit a
256-chip v5e pod; blockwise int8 moments do (see optim/adamw.py)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", attention="mla",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=2048, vocab_size=129280, activation="swiglu",
    n_experts=256, n_shared_experts=1, top_k=8, d_ff_expert=2048,
    n_dense_layers=3, d_ff_dense=18432,
    kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64, v_head_dim=128,
    fsdp=True, opt_state_dtype="int8",
    grad_accum=8, accum_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    n_experts=8, n_shared_experts=1, top_k=2, d_ff_expert=32,
    n_dense_layers=1, d_ff_dense=96, kv_lora_rank=32, q_lora_rank=48,
    rope_head_dim=8, v_head_dim=16, vocab_size=512, fsdp=False,
    loss_chunk=64, attn_block_k=64, opt_state_dtype="float32",
)
