"""Optimizer substrate: AdamW with float32, bfloat16 or int8 state, the
cosine schedule, and error-feedback top-k gradient compression."""
from .adamw import AdamWConfig, adamw_init, adamw_update, opt_state_decls
from .schedules import cosine_schedule
from .grad_compression import topk_compress_update, CompressionState, init_compression
