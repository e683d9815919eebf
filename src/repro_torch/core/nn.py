"""Tiny NN primitives for the DETR-family models (port of repro/core/nn.py).

Layouts follow the reference: linear ``w`` is (d_in, d_out) applied as
``x @ w``; conv weights are OIHW on NCHW inputs."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bridge import host_constant, scalar_constant


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, device="cpu") -> dict:
    w = torch.randn((d_in, d_out), generator=gen) * (1.0 / math.sqrt(d_in))
    return {"w": w.to(device=device, dtype=dtype),
            "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def layer_norm_init(d: int, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Population variance (not torch.var's unbiased default), eps 1e-5."""
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int,
              dtype=torch.float32, device="cpu") -> dict:
    w = torch.randn((c_out, c_in, k, k), generator=gen) \
        * (1.0 / math.sqrt(c_in * k * k))
    return {"w": w.to(device=device, dtype=dtype),
            "b": torch.zeros((c_out,), dtype=dtype, device=device)}


def same_padding(n: int, k: int, stride: int) -> tuple:
    """lax ``"SAME"`` padding of one spatial axis: (low, high).

    The output has ``ceil(n / stride)`` elements and the extra padding
    goes to the HIGH side — stride 2, kernel 3 on an even input pads
    (0, 1), not torch's symmetric 1."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(p: dict, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x: (B, C, H, W) NCHW, weights OIHW."""
    kh, kw = p["w"].shape[2:]
    if padding == "SAME":
        ph = same_padding(x.shape[2], kh, stride)
        pw = same_padding(x.shape[3], kw, stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"unsupported padding {padding!r}")
    return F.conv2d(x, p["w"], p["b"], stride=stride)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi). Where x lies exactly on a bound
    its gradient is 1/2, as JAX's maximum and minimum share a tie;
    ``torch.clamp`` would pass all of it. A Python bound becomes a cached
    0-dim tensor (:func:`~repro_torch.bridge.scalar_constant`)."""
    def bound(a):
        if isinstance(a, torch.Tensor):
            return a.to(dtype=x.dtype, device=x.device)
        return scalar_constant(float(a), x.dtype, x.device)
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit(x) with clamping — the reference-point refinement inverse."""
    x = clip(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def sine_pos_embed_2d(h: int, w: int, d: int, temperature: float = 10000.0,
                      device="cpu") -> torch.Tensor:
    """(H*W, D) 2-D sine position embedding (DETR-style), built once per
    (h, w, d, temperature, device); callers only read it."""
    return _sine_pos_embed_2d(int(h), int(w), int(d), float(temperature),
                              torch.device(device))


@host_constant
def _sine_pos_embed_2d(h: int, w: int, d: int, temperature: float,
                       device: torch.device) -> torch.Tensor:
    if d % 4:
        raise ValueError(f"d must be a multiple of 4, got {d}")
    d4 = d // 4
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    omega = 1.0 / (temperature ** (np.arange(d4) / d4))
    out = []
    for coord in (ys, xs):
        ang = coord.reshape(-1, 1) * omega[None, :]
        out.extend([np.sin(ang), np.cos(ang)])
    return torch.as_tensor(np.concatenate(out, axis=1), dtype=torch.float32,
                           device=device)


def reference_points_for_levels(level_shapes, device="cpu") -> torch.Tensor:
    """Normalized pixel-centre reference points, concatenated: (N_in, 2),
    built once per (level_shapes, device); callers only read it."""
    return _reference_points(tuple((int(h), int(w)) for h, w in level_shapes),
                             torch.device(device))


@host_constant
def _reference_points(level_shapes, device: torch.device) -> torch.Tensor:
    pts = []
    for (h, w) in level_shapes:
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                             indexing="ij")
        pts.append(np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1))
    return torch.as_tensor(np.concatenate(pts, axis=0), dtype=torch.float32,
                           device=device)
