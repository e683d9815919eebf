"""granite-20b — dense code LM, llama-arch, MQA [arXiv:2405.04324; hf]
(port of repro/configs/granite_20b.py; field values copied).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    mlp_gated=False,
    dtype=torch.bfloat16, remat=True, use_fsdp=True, grad_accum=2,
    notes="MQA (kv=1): KV heads replicated across the model axis."
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
    d_ff=128, vocab_size=512, mlp_gated=False, dtype=torch.float32, remat=False,
)
