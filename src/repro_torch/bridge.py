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

import functools
from typing import Any, Callable, List

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


#: every function wrapped by :func:`host_constant`, for cache statistics
HOST_CONSTANTS: List[Callable] = []


def host_constant(fn: Callable) -> Callable:
    """Cache a function that builds a tensor from host values (shapes,
    bounds, position tables), once per argument tuple, e.g. (shapes,
    dtype, device).

    Building such a tensor on the card copies it from pageable host
    memory, which a CUDA graph cannot hold (the copy would read a
    temporary host array at replay), and which costs a host sync per
    call. A forward built from these functions makes the copy once, the
    first time it runs. The tensor is built outside inference mode and
    autograd, so a model that trains can use it as well as a server;
    callers only read it."""
    @functools.lru_cache(maxsize=256)
    def cached(*args):
        with torch.inference_mode(False), torch.no_grad():
            return fn(*args)
    HOST_CONSTANTS.append(cached)
    return functools.wraps(fn)(cached)


def host_constant_misses() -> int:
    """Tensors built so far by every :func:`host_constant` function."""
    return sum(f.cache_info().misses for f in HOST_CONSTANTS)


@host_constant
def scalar_constant(value: float, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A 0-dim tensor holding ``value`` (a fill, cached per dtype and
    device)."""
    return torch.full((), value, dtype=dtype, device=device)


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

