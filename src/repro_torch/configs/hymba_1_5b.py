"""hymba-1.5b — hybrid parallel attn+mamba heads [arXiv:2411.13676; hf]
(port of repro/configs/hymba_1_5b.py; field values copied).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16 vocab=32001.
Sliding-window attention everywhere except 3 global layers (first/middle/
last, per the paper); the SSM path gives O(1)-state long-range memory, so
long_500k decode runs with bounded attention cache."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, ssm_chunk=256,
    attn_window=1024, global_layers=(0, 15, 31),
    dtype=torch.bfloat16, remat=True, grad_accum=1,
    notes="25 heads / kv=5 / d_ff=5504 / vocab=32001 are all 16-indivisible:"
          " attention+mlp replicate over model; batch carries parallelism."
          " Hymba meta-tokens omitted (backbone assignment). For long_500k"
          " the 3 global layers fall back to sliding window (cache bound);"
          " production would use a dual global/SWA cache."
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    ssm_state=8, ssm_expand=2, ssm_conv=4, ssm_head_dim=16, ssm_chunk=8,
    attn_window=8, global_layers=(0,),
    dtype=torch.float32, remat=False,
)
