"""The activation-sharding policy and the tensor-parallel context (port of
``repro/distributed/act_sharding.py``).

Models are mesh-agnostic, so both ride context variables set by the
launch layer.

* The **policy** (the dry run's ``--opt`` cells, through
  ``launch.input_specs._maybe_policy``): the MoE reads
  :func:`model_axis_size` to take its expert-parallel path when it is
  called on global tensors, and ``seq_shard`` (the pure-DP strategy,
  ``cfg.pure_dp``) makes a cell's rank body split the sequence over the
  model axis (:func:`seq_split`, below).
* The **tensor-parallel context** (:func:`tensor_parallel`, set by a
  serving or training cell's rank body, ``launch.input_specs``): the
  rank's place on the model axis. Under it the paths of ``models/``
  compute on the rank's parameter shards, as the reference's SPMD
  partitioner splits each matmul: a layer finds from a leaf's shape
  whether its spec split it (query heads, KV heads, the MLP and expert
  FFN dims, experts, the vocabulary), computes its part and asks for
  the model axis's sum (:func:`model_sum`) where the reference's
  partitioner reduces. A rank body sets it with ``with`` and the
  in-process runner gives every rank a context of its own
  (``collectives.run_in_process``). Training adds Megatron's pair of
  gradients (``collectives``' convention): :func:`model_copy` where a
  replicated value enters a region each rank computes a part of (the
  input of a column-parallel product, a replicated leaf a rank uses in
  part), whose backward sums the ranks' cotangents, and :func:`model_sum`
  back into a replicated value, whose backward is the identity.

* The **cache length split** (:func:`cache_split`, set by a decode
  cell's rank body when the cell's specs split the KV cache's length
  over the data axis, as the reference's ``shard_len`` does at
  ``long_500k``): the rank holds one contiguous slice of every layer's
  ring-buffer slots. Under it ``models.layers`` writes a token only on
  the rank that owns its slot and merges the ranks' partial attentions
  (K5's partial mode) instead of gathering the cache.

* The **batch split** (:func:`batch_split`, set by a training rank body
  and by the DETR serve body): a statistic of the whole batch asks for
  the data axes' reduction (:func:`batch_mean`; :func:`batch_max` for the
  DEFA INT12 scale, one max over the whole array in the reference).

* The **sequence split** (:func:`seq_split`, set by a train or prefill
  cell's rank body under a policy with ``seq_shard``): the rank holds
  one contiguous block of the token rows of its data group, where the
  reference's ``constrain_stream`` pins every (B, S, ...) stream's dim 1
  to the model axis. ``_constrain``'s rule holds: a stream whose length
  does not divide the axis stays whole on every rank
  (:func:`stream_split`). Under it the models compute the rank's rows:
  attention over K / V gathered over the axis (:func:`seq_gather`, whose
  backward reduce-scatters the group's summed cotangents), the SSD scan
  passing its state from rank to rank, and the loss as the axis's sum
  of the ranks' token sums (:func:`seq_sum`).

The reference's ``constrain_*`` hints themselves (and
``layers._constrain_attn``) are not ported: they pin the sharding of
activations that XLA then propagates, where the port's rank bodies
split each layer explicitly; the pure-DP sequence split above is what
they ask for under ``--opt``."""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import mesh_shape

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)
_TP: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel", default=None)
_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "batch_split", default=())
_CACHE: contextvars.ContextVar = contextvars.ContextVar(
    "cache_split", default=None)
_SEQ: contextvars.ContextVar = contextvars.ContextVar(
    "seq_split", default=None)


@contextlib.contextmanager
def activation_policy(mesh, batch_axes, model_axis: Optional[str] = "model",
                      seq_shard: bool = False):
    """Set the policy: batch dims over `batch_axes`, experts over
    `model_axis` (None where the mesh has no such axis). ``seq_shard``
    (pure-DP strategy): the model axis carries the SEQUENCE of the
    (B, S, ...) streams and the weights stay replicated."""
    token = _POLICY.set({"mesh": mesh, "batch": batch_axes,
                         "model": model_axis if (model_axis in mesh_shape(mesh))
                         else None,
                         "seq": seq_shard})
    try:
        yield
    finally:
        _POLICY.reset(token)


def policy_active() -> bool:
    return _POLICY.get() is not None


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
    rounded once to ``x``'s dtype; the result is replicated, so its
    backward hands each rank its own cotangent."""
    tp = _TP.get()
    if tp is None:
        raise RuntimeError("model_sum outside a tensor-parallel context")
    out = yield C.row_sum(tp.axis, x.float())
    return out.to(x.dtype)


def model_copy(x):
    """Rank body step: ``x``, a value every rank of the model axis holds
    alike, entering a region each rank computes a part of; backward, the
    axis's sum of the ranks' cotangents, in float32 in rank order and
    rounded once to ``x``'s dtype (as :func:`model_sum`'s forward). Asks
    for nothing where no gradient flows (serving) or off the
    tensor-parallel context."""
    tp = _TP.get()
    if tp is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    out = yield C.model_copy(tp.axis, x.float())
    return out.to(x.dtype)


def model_reduce(op: str, x, grad: bool):
    """Rank body step: the model axis's ``op`` ("sum" or "max") of ``x``,
    with gradient (a sum into a replicated value, as :func:`model_sum`
    but in ``x``'s own dtype) or without (``x`` detached, as a softmax's
    running max is)."""
    tp = _TP.get()
    if tp is None:
        raise RuntimeError("model_reduce outside a tensor-parallel context")
    if not grad:
        x = x.detach()
    if op == "max":
        if grad:
            raise ValueError("a max over the model axis carries no gradient")
        return (yield C.pmax(tp.axis, x))
    return (yield C.row_sum(tp.axis, x))


@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """A rank's slice of a KV cache whose length lies split over
    ``axes``: slice ``index`` of ``size`` (row-major over the axes, as
    ``collectives.local_slices`` cuts a dim split over several)."""
    rank: C.RankContext
    axes: tuple

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= self.rank.size[a]
        return n

    @property
    def index(self) -> int:
        i = 0
        for a in self.axes:
            i = i * self.rank.size[a] + self.rank.index[a]
        return i


@contextlib.contextmanager
def cache_split(rank: C.RankContext, axes: tuple):
    """Inside the block the KV cache a decode step is handed is this
    rank's slice of its length, split over ``axes``; axes of one rank
    (or none) set no context."""
    split = CacheSplit(rank, tuple(axes))
    token = _CACHE.set(split if split.size > 1 else None)
    try:
        yield
    finally:
        _CACHE.reset(token)


def cache_split_context() -> Optional[CacheSplit]:
    return _CACHE.get()


def data_axes(rank: C.RankContext) -> tuple:
    """The rank's batch axes of more than one rank ("pod", "data")."""
    return tuple(a for a in ("pod", "data") if rank.size.get(a, 1) > 1)


@contextlib.contextmanager
def batch_split(rank: C.RankContext):
    """Inside the block (a training rank body) the rank holds its rows of
    a batch split over its batch axes, and a statistic of the whole
    batch (the MoE's balance loss) asks for their mean
    (:func:`batch_mean`)."""
    token = _BATCH.set(data_axes(rank))
    try:
        yield
    finally:
        _BATCH.reset(token)


def batch_mean(x):
    """Rank body step: the mean of ``x`` over the batch axes under
    :func:`batch_split` (rows split evenly: the whole batch's mean of a
    per-row mean), with gradient; ``x`` itself elsewhere."""
    axes = _BATCH.get()
    if not axes:
        return x
    return (yield C.pmean(axes, x))


def batch_max(x):
    """Rank body step: the max of ``x`` over the batch axes under
    :func:`batch_split`, taken on detached values (exact in any order;
    a quantization scale sits inside the straight-through estimator's
    detached term, so it needs no gradient); ``x`` itself elsewhere."""
    axes = _BATCH.get()
    if not axes:
        return x
    return (yield C.pmax(axes, x.detach()))


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A rank's block of a stream of ``total`` rows split over ``axis``:
    rows ``[start, start + rows)``. ``total`` 0: the cell's token stream
    does not divide the axis and stays whole (:func:`stream_split` may
    still split another stream)."""
    rank: C.RankContext
    total: int
    axis: str = "model"

    @property
    def size(self) -> int:
        return self.rank.size[self.axis]

    @property
    def index(self) -> int:
        return self.rank.index[self.axis]

    @property
    def rows(self) -> int:
        return self.total // self.size

    @property
    def start(self) -> int:
        return self.index * self.rows

    def cut(self, x: torch.Tensor, dim: int = 1, extra: int = 0):
        """This rank's rows of ``x`` along ``dim`` (and ``extra`` more
        after them: the labels' shift)."""
        return x.narrow(dim, self.start, self.rows + extra)


@contextlib.contextmanager
def seq_split(rank: C.RankContext, total: int, axis: str = "model"):
    """Inside the block (a train or prefill cell's rank body) the rank
    holds its block of the ``total`` token rows where a policy with
    ``seq_shard`` is active, ``axis`` has more than one rank and
    ``total`` divides it (``_constrain``'s rule); yields the
    :class:`SeqSplit` (None where the sequence stays whole). Where the
    policy splits but ``total`` does not divide, the context still lets
    :func:`stream_split` cut another stream."""
    split = None
    if policy_active() and current_policy().get("seq") \
            and current_policy()["model"] == axis \
            and rank.size.get(axis, 1) > 1:
        split = SeqSplit(rank, total if total % rank.size[axis] == 0 else 0,
                         axis)
    token = _SEQ.set(split)
    try:
        yield split if split is not None and split.total else None
    finally:
        _SEQ.reset(token)


def seq_split_context() -> Optional[SeqSplit]:
    """The split of the cell's token stream (None: whole)."""
    split = _SEQ.get()
    return split if split is not None and split.total else None


def stream_split(total: int) -> Optional[SeqSplit]:
    """The split of another (B, ``total``, ...) stream under the sequence
    split (whisper's encoder frames): None where it does not divide the
    axis, as ``_constrain`` drops such a split."""
    split = _SEQ.get()
    if split is None or total % split.size:
        return None
    return dataclasses.replace(split, total=total)


def seq_gather(split: SeqSplit, x, dim: int = 1):
    """Rank body step: the ranks' blocks of ``x`` concatenated along
    ``dim`` in rank order, an all-gather over the split's axis that the
    ranks compute different rows from (not ``replicated``): its backward
    hands each rank its block of the group's summed cotangents."""
    return (yield C.all_gather(split.axis, x, dim))


def seq_sum(split: SeqSplit, x):
    """Rank body step: the axis's sum of the ranks' ``x`` (a token sum),
    in float32 in rank order, one replicated value (``row_sum``'s
    convention: each rank's ``x`` receives its own cotangent)."""
    return (yield C.row_sum(split.axis, x.float()))
