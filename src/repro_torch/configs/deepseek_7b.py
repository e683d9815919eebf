"""deepseek-7b — dense llama-arch LM, MHA [arXiv:2401.02954; hf]
(port of repro/configs/deepseek_7b.py; field values copied).

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    dtype=torch.bfloat16, remat=True, grad_accum=1,
    notes="Full MHA (kv=32); d_ff=11008=16*688 shards over model."
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
    d_ff=172, vocab_size=512, dtype=torch.float32, remat=False,
)
