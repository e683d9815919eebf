"""olmoe-1b-7b — MoE LM, 64 experts top-8 [arXiv:2409.02060; hf]
(port of repro/configs/olmoe_1b_7b.py; field values copied).

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    n_experts=64, n_experts_active=8, expert_capacity_factor=1.25,
    dtype=torch.bfloat16, remat=True, grad_accum=1,
    notes="MoE 64e top-8; experts shard over the model axis (64/16=4 per chip)."
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab_size=512,
    n_experts=8, n_experts_active=2, expert_capacity_factor=2.0,
    dtype=torch.float32, remat=False,
)
