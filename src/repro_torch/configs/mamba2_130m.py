"""mamba2-130m — attention-free SSD LM [arXiv:2405.21060; unverified]
(port of repro/configs/mamba2_130m.py; field values copied).

24L d_model=768 vocab=50280 ssm_state=128 (SSD: expand 2, head_dim 64)."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,   # unused (attn-free)
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, ssm_chunk=256,
    dtype=torch.bfloat16, remat=True, grad_accum=1,
    notes="Attention-free: runs long_500k (state-space decode is O(1) per "
          "token). d_inner=1536 -> 24 SSD heads."
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_head_dim=16, ssm_chunk=8,
    dtype=torch.float32, remat=False,
)
