"""Shared LM substrate: config, norms, rotary, init, loss (port of
``repro/models/common.py``).

Models are parameter trees of tensors; per-layer parameters are stacked
on a leading layer axis, as in the reference, so that
``bridge.params_from_numpy`` carries a reference tree across leaf by
leaf. ``ModelConfig.dtype`` is a torch dtype."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bridge import host_constant


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    expert_capacity_factor: float = 1.25
    mlp_gated: bool = True                   # SwiGLU; False = 2-matrix GELU
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # --- hybrid / windowed attention ---
    attn_window: int = 0                     # 0 = full attention
    global_every: int = 0                    # hybrid: every k-th layer is global
    global_layers: Tuple[int, ...] = ()      # explicit global layer ids
    # physical padding of q-heads to a TP-divisible count; padded heads are
    # output-masked
    pad_heads_to: int = 0
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq_len: int = 1500
    # --- vlm (llava) ---
    n_img_tokens: int = 0
    # --- numerics / execution ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attn_chunk: int = 2048                   # blockwise attention threshold/chunk
    attn_impl: str = "blockwise"             # blockwise | dense
    scan_unroll: int = 1
    # --- distribution knobs (the reference's launch/; kept for parity) ---
    pure_dp: bool = False
    use_fsdp: bool = False
    remat: bool = True
    remat_policy: str = "nothing"
    comm_barrier: bool = False
    grad_accum: int = 1
    notes: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def h_phys(self) -> int:
        """Physical q-head count (>= n_heads when pad_heads_to is set)."""
        return max(self.pad_heads_to, self.n_heads) if self.pad_heads_to \
            else self.n_heads

    @property
    def d_inner(self) -> int:                # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        dh, hq, hkv = self.dh, self.n_heads, self.n_kv_heads
        attn = d * dh * hq + 2 * d * dh * hkv + dh * hq * d
        if self.family == "ssm":
            attn = 0
        nmat = 3 if self.mlp_gated else 2
        mlp = nmat * d * f
        if self.n_experts:
            mlp = nmat * d * f * self.n_experts + d * self.n_experts
        ssm = 0
        if self.ssm_state:
            di, n, hs = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * n + hs) + di * d + self.ssm_conv * (di + 2 * n)
        per_layer = attn + (mlp if self.family != "ssm" else 0) + ssm + 2 * d
        total = l * per_layer + 2 * v * d
        if self.family == "encdec":
            enc = self.n_enc_layers * (d * dh * hq * 2 + 2 * d * dh * hkv
                                       + nmat * d * f + 2 * d)
            total += enc + l * (d * dh * hq + 2 * d * dh * hkv + dh * hq * d)
        return int(total)

    def active_param_count(self) -> int:
        if not self.n_experts:
            return self.param_count()
        d, f, l = self.d_model, self.d_ff, self.n_layers
        nmat = 3 if self.mlp_gated else 2
        dense_mlp = nmat * d * f * self.n_experts
        active_mlp = nmat * d * f * self.n_experts_active
        return int(self.param_count() - l * (dense_mlp - active_mlp))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The variance in float32; the rsqrt cast to ``x.dtype`` before it
    scales x, as in the reference."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope_freq(dh: int, theta: float) -> np.ndarray:
    """Rotary frequencies in float32, computed with numpy as the
    reference computes them."""
    half = dh // 2
    return 1.0 / (theta ** (np.arange(half, dtype=np.float32) / half))


@host_constant
def _rope_freq_tensor(dh: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_freq` on ``device``, built once per (dh, theta, device)."""
    return torch.from_numpy(rope_freq(dh, theta)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) int32. cos and sin in
    float32, cast to ``x.dtype`` before they rotate x."""
    half = x.shape[-1] // 2
    freq = _rope_freq_tensor(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].float() * freq                    # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)               # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def init_dense(gen: torch.Generator, shape, scale_dim: int, dtype,
               device=None) -> torch.Tensor:
    """Standard normal / sqrt(scale_dim), drawn in float32 on the
    generator's device and cast to ``dtype`` on ``device``. Torch's
    random bits are not JAX's: parity goes through converted reference
    params."""
    w = torch.randn(tuple(shape), generator=gen, device=gen.device) \
        / math.sqrt(scale_dim)
    return w.to(device=device if device is not None else gen.device,
                dtype=dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,S,V) upcast to float32; labels (B,S) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")
