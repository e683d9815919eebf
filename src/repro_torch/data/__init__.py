"""Synthetic data of the port: rectangle detection with its AP
evaluation (``detection``) and the LM token pipeline (``tokens``).

Batches are drawn from a ``torch.Generator`` keyed by (seed, index)
through :func:`fold_in`, the counterpart of ``jax.random.fold_in``: a
batch is a function of its step, never of an iterator's position, so a
restarted run sees the batches an uninterrupted one sees. JAX's PRNG
bits themselves cannot be reproduced."""
from __future__ import annotations

import numpy as np
import torch


def fold_in(seed: int, data: int) -> torch.Generator:
    """A CPU generator keyed by (seed, data), independent across keys."""
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))
