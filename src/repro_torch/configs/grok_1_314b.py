"""grok-1-314b — MoE LM, 8 experts top-2 [hf:xai-org/grok-1; unverified]
(port of repro/configs/grok_1_314b.py; field values copied).

64L d_model=6144 48H (GQA kv=8) d_ff=32768/expert vocab=131072."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    n_experts=8, n_experts_active=2, expert_capacity_factor=1.25,
    dtype=torch.bfloat16, remat=True, use_fsdp=True, grad_accum=8,
    notes="8 experts don't divide the 16-way model axis: per-expert d_ff "
          "shards over model instead; params FSDP over data (+pod)."
)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    n_experts=4, n_experts_active=2, expert_capacity_factor=2.0,
    dtype=torch.float32, remat=False,
)
