"""minitron-4b — pruned nemotron dense LM [arXiv:2407.14679; hf]
(port of repro/configs/minitron_4b.py; field values copied).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    mlp_gated=False,
    dtype=torch.bfloat16, remat=True, grad_accum=1,
    notes="24 heads don't divide model=16: heads replicate, mlp/vocab shard. "
          "(24%16!=0 -> heads unsharded; d_ff=9216 divides 16.)"
)

SMOKE = ModelConfig(
    name="minitron4b-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    d_ff=96, vocab_size=512, mlp_gated=False, dtype=torch.float32, remat=False,
)
