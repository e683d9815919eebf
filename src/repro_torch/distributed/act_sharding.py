"""The activation-sharding policy (port of
``repro/distributed/act_sharding.py``).

Models are mesh-agnostic, so the policy rides a context variable set by
the launch layer (the dry run's ``--opt`` cells, through
``launch.input_specs._maybe_policy``). The MoE reads
:func:`model_axis_size` to take its expert-parallel path. The
reference's ``constrain_*`` hints (and ``layers._constrain_attn``) are
not ported: they pin the sharding of activations that XLA's SPMD
partitioner computes on, where the port's model paths compute on plain
tensors, gathered whole on each rank, so each would be an identity. They
wait for tensor-parallel compute (ROADMAP.md section 1), and with them
the reference's ``seq_shard`` flag (the pure-DP strategy's sequence
sharding, which only those hints read) and ``policy_active``."""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from repro_torch.distributed.collectives import mesh_shape

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)


@contextlib.contextmanager
def activation_policy(mesh, batch_axes, model_axis: Optional[str] = "model"):
    """Set the policy: batch dims over `batch_axes`, experts over
    `model_axis` (None where the mesh has no such axis)."""
    token = _POLICY.set({"mesh": mesh, "batch": batch_axes,
                         "model": model_axis if (model_axis in mesh_shape(mesh))
                         else None})
    try:
        yield
    finally:
        _POLICY.reset(token)


def current_policy() -> Optional[dict]:
    return _POLICY.get()


def model_axis_size() -> int:
    """TP degree under the active policy (0 = no policy / no model axis)."""
    pol = _POLICY.get()
    if pol is None or pol["model"] is None:
        return 0
    return mesh_shape(pol["mesh"])[pol["model"]]
