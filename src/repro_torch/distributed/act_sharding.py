"""The activation-sharding policy and the tensor-parallel context (port of
``repro/distributed/act_sharding.py``).

Models are mesh-agnostic, so both ride context variables set by the
launch layer.

* The **policy** (the dry run's ``--opt`` cells, through
  ``launch.input_specs._maybe_policy``): the MoE reads
  :func:`model_axis_size` to take its expert-parallel path when it is
  called on global tensors.
* The **tensor-parallel context** (:func:`tensor_parallel`, set by a
  serving cell's rank body, ``launch.input_specs._serve_body``): the
  rank's place on the model axis. Under it the serving paths of
  ``models/`` compute on the rank's parameter shards, as the reference's
  SPMD partitioner splits each matmul: a layer finds from a leaf's shape
  whether its spec split it (query heads, KV heads, the MLP and expert
  FFN dims, experts, the vocabulary), computes its part and asks for
  the model axis's sum (:func:`model_sum`) where the reference's
  partitioner reduces. A rank body sets it with ``with`` and the
  in-process runner gives every rank a context of its own
  (``collectives.run_in_process``).

The reference's ``constrain_*`` hints (and ``layers._constrain_attn``)
are not ported: they pin the sharding of activations that XLA then
propagates, where the port's rank bodies split each layer explicitly.
With them wait the reference's ``seq_shard`` flag and ``policy_active``
(ROADMAP.md)."""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import mesh_shape

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)
_TP: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel", default=None)


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


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place on the model axis: ``rank`` is its rank body's
    context (its index and the size along every mesh axis)."""
    rank: C.RankContext
    axis: str = "model"

    @property
    def size(self) -> int:
        return self.rank.size[self.axis]

    @property
    def index(self) -> int:
        return self.rank.index[self.axis]


@contextlib.contextmanager
def tensor_parallel(rank: C.RankContext, axis: str = "model"):
    """Inside the block the model paths compute on this rank's shards of
    the leaves ``axis`` splits. A mesh without ``axis``, or with one rank
    on it, sets no context."""
    tp = TensorParallel(rank, axis) if rank.size.get(axis, 1) > 1 else None
    token = _TP.set(tp)
    try:
        yield tp
    finally:
        _TP.reset(token)


def tensor_parallel_context() -> Optional[TensorParallel]:
    return _TP.get()


def model_sum(x):
    """Rank body step: the model axis's sum of every rank's partial ``x``
    (a row-parallel product), summed in float32 in rank order and
    rounded once to ``x``'s dtype."""
    tp = _TP.get()
    if tp is None:
        raise RuntimeError("model_sum outside a tensor-parallel context")
    out = yield C.psum(tp.axis, x.float())
    return out.to(x.dtype)
