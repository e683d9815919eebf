"""Bridge between the JAX package's param pytrees and the port's params.

The port keeps the reference layouts at every public function:

  * linear ``w`` is ``(d_in, d_out)`` and is applied as ``x @ w``;
  * conv weights are OIHW;
  * MSDA weights are ``(d, h, k)`` and ``(h, dh, d)``.

So converting a reference param tree is a leaf-by-leaf copy: the
nested dict/list structure is kept, each numpy array becomes a tensor
on the requested device. JAX's PRNG bits cannot be reproduced in torch,
so parity always goes through converted reference params; the port's
own ``init_*`` functions draw from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the entry points' default) raises on a machine without a
    CUDA device: a default call must never run on the CPU quietly. Pass
    ``device="cpu"`` for the plain PyTorch path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def _leaf_to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from jax arrays
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C")).to(device)   # own copy


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Reference param pytree (nested dict/list/tuple of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, init_detector(key, cfg))``) -> the
    same structure of tensors on ``device``, layouts unchanged."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    return _leaf_to_tensor(tree, dev)


def tree_to(tree: Any, device) -> Any:
    """Move every tensor leaf of a param tree to ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev)

