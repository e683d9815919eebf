"""llava-next-34b — VLM backbone (anyres tiling) [hf:llava-hf/llava-v1.6;
unverified] (port of repro/configs/llava_next_34b.py; field values
copied). 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

The vision frontend is a stub: callers pass precomputed patch embeddings — anyres 5 tiles x 576 patches = 2880 image
tokens prepended to the text sequence."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    n_img_tokens=2880,
    dtype=torch.bfloat16, remat=True, use_fsdp=True, grad_accum=4,
    notes="56 heads don't divide model=16 -> heads replicate; mlp shards. "
          "anyres: 4 tiles + 1 base x 576 patches = 2880 stub patch embeds."
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab_size=512, n_img_tokens=16,
    dtype=torch.float32, remat=False,
)
