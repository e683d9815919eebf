"""minitron-8b — pruned nemotron dense LM [arXiv:2407.14679; hf]
(port of repro/configs/minitron_8b.py; field values copied).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    mlp_gated=False,
    dtype=torch.bfloat16, remat=True, grad_accum=2,
    notes="256k vocab: embedding+head shard over model; CE loss computed "
          "in vocab chunks to bound the f32 logits buffer."
)

SMOKE = ModelConfig(
    name="minitron8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab_size=512, mlp_gated=False, dtype=torch.float32, remat=False,
)
