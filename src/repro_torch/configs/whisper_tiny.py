"""whisper-tiny — enc-dec audio backbone [arXiv:2212.04356; unverified]
(port of repro/configs/whisper_tiny.py; field values copied).

4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865. The conv/mel
frontend is a stub: callers pass precomputed frame embeddings
(B, 1500, 384)."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, enc_seq_len=1500,
    mlp_gated=False,
    dtype=torch.bfloat16, remat=True, grad_accum=1,
    notes="Assigned shapes exceed whisper's native 448-token decoder context;"
          " applied mechanically to the backbone per the assignment. 6 heads"
          " replicate over model=16; mlp=1536 shards (96/chip)."
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, enc_seq_len=16,
    mlp_gated=False, dtype=torch.float32, remat=False,
)
