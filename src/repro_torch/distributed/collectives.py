"""The collectives of the port's sharded bodies, and the two ways to run
those bodies (the port's counterpart of the reference's ``shard_map``).

A reference ``shard_map`` body becomes a *rank body*: a Python generator
``body(ctx, *rank_tensors)`` that computes on its rank's tensors and
``yield``s a :class:`Collective` wherever the reference calls a
``jax.lax`` collective; the runner sends the result back and the body
``return``s its output. ``ctx`` is a :class:`RankContext` (the rank's
index and size along each mesh axis: ``axis_index`` and the axis size).

Two runners run a body, and the caller names which:

* :func:`run_spmd` runs one body per process, the collectives going over
  ``torch.distributed`` process groups of a ``DeviceMesh`` (NCCL for
  CUDA tensors, gloo for CPU tensors);
* :func:`run_in_process` runs the bodies of every rank of an
  :class:`InProcessMesh` in one process, in turn, each up to its next
  collective, which it then computes over the list of the ranks'
  tensors. This runs an N-rank axis on one card or on the CPU, as the
  reference's tests run N virtual devices. Each rank's steps run in a
  ``contextvars.Context`` of its own, so a context variable a body sets
  (the tensor-parallel context of ``distributed.act_sharding``) is that
  rank's alone while the ranks take turns.

:func:`run_local` runs a body that asks for no collective (a model path
off any mesh) and returns its output.

Both compute every collective with the same operations in the same
order, so they agree bitwise. A floating-point SUM adds each element's
operands in rank order, where a ring all-reduce would add in an order
that depends on the rank and the chunk: on a process group it is an
all-to-all of the tensors' n chunks, the sum in rank order of the chunk
each rank receives, and an all-gather of the summed chunks, which costs
a rank twice its tensor's bytes, as a ring all-reduce does. Integer
sums and MAX, which are exact in any order, go through ``all_reduce``.
A data-parallel gradient mean calls ``all_reduce`` itself
(``train.step``).

Gradients. A rank body that trains asks for its gradients with
:func:`grad` (a step like a collective: the in-process runner takes the
gradients of every rank's outputs in one call, since the backward of a
collective needs every rank's cotangents; :func:`run_spmd` takes its
own rank's). Both runners give the same gradients, by one convention:
**each rank differentiates its own output, and the objective is the sum
of the ranks' outputs, where a value that a collective declares
replicated (``replicated=True``: every rank of the group holds it alike)
counts once for the group.** So each collective's backward is the
adjoint of its forward under that count:

* ``sum`` / ``mean`` (:func:`psum`, :func:`pmean`): every rank's output
  is a term of its own, so each input receives the group's sum of the
  outputs' cotangents (the expert-parallel convention of ``moe_apply_ep``
  and a data-parallel mean); with ``replicated=True`` (:func:`row_sum`,
  Megatron's row-parallel sum into a replicated activation) the output is
  one value and each rank's input receives its own output's cotangent;
* ``copy`` (:func:`model_copy`, Megatron's copy into a tensor-parallel
  region): the identity forward, whose input is one replicated value
  that every rank's region uses in part, so each rank's input receives
  the group's sum of the cotangents;
* ``all_gather``: each input receives its slice of the group's summed
  cotangents (a reduce-scatter: the FSDP gather over the data axes, a
  weight or a K / V block gathered over a sequence split); with
  ``replicated=True`` (a leaf gathered over the model axis to compute a
  replicated region whole) its slice of its own cotangent;
* ``max`` and ``exchange`` carry no gradient: both runners raise if one
  is handed a tensor that requires grad while grad mode is on (a body
  takes a max of detached values, as the vocabulary-parallel softmax
  does).

Every sum of a backward is the same ordered sum as a forward's, so the
two runners' gradients agree bitwise too. :class:`CommStats` records
the backward's sums and reduce-scatters as they run, beside the
forward's (``backward``). Grad mode is the caller's: a body must not
switch it around a ``yield`` (the in-process runner's ranks take turns
on one thread)."""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, Generator, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

AxisNames = Tuple[str, ...]


class Collective(NamedTuple):
    """One collective a rank body asks for (see the module docstring)."""
    op: str                    # exchange | all_gather | sum | max | mean | copy | grad
    axis: AxisNames
    tensors: Tuple[torch.Tensor, ...]
    dim: int = 0
    replicated: bool = False   # the result counts once for the group (gradients)
    extra: Any = None          # grad: (inputs, grad_outputs)


def _axes(axis) -> AxisNames:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def ring_exchange(axis: str, bottom: torch.Tensor,
                  top: torch.Tensor) -> Collective:
    """Send ``bottom`` to rank i+1 and ``top`` to rank i-1 (mod n) of the
    axis; the result is (from_above, from_below): rank i-1's bottom and
    rank i+1's top (the reference's two ``ppermute``s)."""
    return Collective("exchange", _axes(axis), (bottom, top))


def all_gather(axis: str, x: torch.Tensor, dim: int,
               replicated: bool = False) -> Collective:
    """The axis's tensors concatenated along ``dim`` in rank order
    (``all_gather(..., tiled=True)``)."""
    return Collective("all_gather", _axes(axis), (x,), dim, replicated)


def psum(axis, x: torch.Tensor) -> Collective:
    return Collective("sum", _axes(axis), (x,))


def row_sum(axis, x: torch.Tensor) -> Collective:
    """The sum whose result is one replicated value (backward: each
    rank's own cotangent)."""
    return Collective("sum", _axes(axis), (x,), replicated=True)


def model_copy(axis, x: torch.Tensor) -> Collective:
    """``x`` itself, entering a region every rank computes a part of
    (backward: the group's sum of the cotangents). Moves no bytes
    forward."""
    return Collective("copy", _axes(axis), (x,))


def grad(outputs: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor],
         grad_outputs: Sequence[torch.Tensor] | None = None) -> Collective:
    """The gradients of ``outputs`` (with ``grad_outputs``, default ones)
    with respect to ``inputs``, zeros for an input they do not reach; the
    runner takes every rank's at once (see the module docstring)."""
    return Collective("grad", (), tuple(outputs),
                      extra=(tuple(inputs), None if grad_outputs is None
                             else tuple(grad_outputs)))


def pmax(axis, x: torch.Tensor) -> Collective:
    return Collective("max", _axes(axis), (x,))


def pmean(axis, x: torch.Tensor) -> Collective:
    return Collective("mean", _axes(axis), (x,))


@dataclasses.dataclass(frozen=True)
class RankContext:
    index: Dict[str, int]      # the rank's coordinate along each mesh axis
    size: Dict[str, int]       # each mesh axis's size


@dataclasses.dataclass
class CommStats:
    """Bytes each rank handed to the collectives, by op (what it sends),
    and by op and mesh axis (``by_axis[rank][op]["pod/data"]``): the
    forward's, and those of the backward (``backward[rank][op]``, its
    sums and reduce-scatters, counted in ``sent`` and ``by_axis`` too).
    A ``copy`` moves nothing forward and is not recorded there."""
    sent: Dict[int, Dict[str, int]] = dataclasses.field(default_factory=dict)
    by_axis: Dict[int, Dict[str, Dict[str, int]]] = dataclasses.field(
        default_factory=dict)
    backward: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def record(self, rank: int, req: "Collective") -> None:
        if req.op not in ("copy", "grad"):
            self.add(rank, req.op, "/".join(req.axis), _nbytes(req))

    def add(self, rank: int, op: str, axis: str, nbytes: int,
            backward: bool = False) -> None:
        per = self.sent.setdefault(rank, {})
        per[op] = per.get(op, 0) + nbytes
        axes = self.by_axis.setdefault(rank, {}).setdefault(op, {})
        axes[axis] = axes.get(axis, 0) + nbytes
        if backward:
            bwd = self.backward.setdefault(rank, {})
            bwd[op] = bwd.get(op, 0) + nbytes

    def rank_bytes(self, rank: int = 0) -> int:
        return sum(self.sent.get(rank, {}).values())


_RECORDING: contextvars.ContextVar = contextvars.ContextVar(
    "collective_recording", default=None)


@contextlib.contextmanager
def recording(stats: CommStats):
    """Inside the block :func:`run_spmd` records into ``stats`` the
    collectives its rank bodies ask for, where its caller passes none
    (the dry run's trace of a cell's rank program)."""
    token = _RECORDING.set(stats)
    try:
        yield stats
    finally:
        _RECORDING.reset(token)


class InProcessMesh:
    """A device mesh whose ranks all run in this process, in turn, on one
    device: rank r sits at the row-major coordinate of r in ``shape``,
    as a ``DeviceMesh`` over ``arange(n).reshape(shape)`` places it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = 1
        for s in self.shape.values():
            self.size *= s

    def coords(self, rank: int) -> Dict[str, int]:
        out, rem = {}, rank
        for a in reversed(self.axis_names):
            out[a] = rem % self.shape[a]
            rem //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def __repr__(self) -> str:
        return f"InProcessMesh({self.shape})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for an :class:`InProcessMesh` or a ``DeviceMesh``
    with named dims."""
    if isinstance(mesh, InProcessMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def rank_context(mesh) -> RankContext:
    """This process's context on a ``DeviceMesh``."""
    sizes = mesh_shape(mesh)
    return RankContext({a: int(mesh.get_local_rank(a)) for a in sizes}, sizes)


# --------------------------------------------------------------------------
# the collectives over a list of the ranks' tensors (in-process)
# --------------------------------------------------------------------------

def _ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _ordered_max(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(op: str, tensors) -> None:
    if op in ("max", "exchange") and _needs_grad(tensors):
        raise NotImplementedError(f"{op} carries no gradient")


def _chunks(x: torch.Tensor, n: int, dim: int) -> List[torch.Tensor]:
    return list(torch.chunk(x, n, dim=dim))


class _LocalSum(torch.autograd.Function):
    """The group's ordered sum, one output per rank (see the module
    docstring for the backward)."""

    @staticmethod
    def forward(ctx, replicated, record, *xs):
        ctx.replicated, ctx.record = replicated, record
        out = _ordered_sum(xs)
        return tuple(out.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.replicated:
            return (None, None) + gs
        ctx.record("sum", gs[0])
        tot = _ordered_sum(gs)
        return (None, None) + tuple(tot.clone() for _ in gs)


class _LocalCopy(torch.autograd.Function):
    """Each rank's tensor itself; backward, the group's ordered sum."""

    @staticmethod
    def forward(ctx, record, *xs):
        ctx.record = record
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.record("sum", gs[0])
        tot = _ordered_sum(gs)
        return (None,) + tuple(tot.clone() for _ in gs)


class _LocalGather(torch.autograd.Function):
    """The group's tensors concatenated, one output per rank; backward,
    each input's slice of the ordered sum of the cotangents (its own
    cotangent's slice where the result is replicated)."""

    @staticmethod
    def forward(ctx, dim, replicated, record, *xs):
        ctx.dim, ctx.replicated, ctx.record = dim, replicated, record
        out = torch.cat(xs, dim=dim)
        return tuple(out.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        n = len(gs)
        parts = [_chunks(g, n, ctx.dim) for g in gs]
        if ctx.replicated:
            return (None, None, None) + tuple(
                parts[j][j].contiguous() for j in range(n))
        ctx.record("reduce_scatter", gs[0])
        return (None, None, None) + tuple(
            _ordered_sum([p[j] for p in parts]).contiguous() for j in range(n))


def _local_group(op: str, xs: List[Tuple[torch.Tensor, ...]], dim: int,
                 replicated: bool = False, record=None):
    """One single-axis collective over the group's ranks, in axis order;
    returns each rank's result. ``record(op, cotangent)`` hears of each
    sum or reduce-scatter the backward runs."""
    n = len(xs)
    flat = [t for x in xs for t in x]
    _refuse_grad(op, flat)
    grad_on = _needs_grad(flat)
    if op == "exchange":
        return [(xs[(i - 1) % n][0], xs[(i + 1) % n][1]) for i in range(n)]
    if op == "copy":
        return list(_LocalCopy.apply(record, *flat)) if grad_on else flat
    if op == "all_gather":
        if grad_on:
            return list(_LocalGather.apply(dim, replicated, record, *flat))
        out = torch.cat(flat, dim=dim)
        return [out] * n
    if op == "sum":
        if grad_on:
            return list(_LocalSum.apply(replicated, record, *flat))
        out = _ordered_sum(flat)
    elif op == "max":
        out = _ordered_max(flat)
    else:
        raise ValueError(f"unknown collective {op!r}")
    return [out] * n


# --------------------------------------------------------------------------
# the same collectives over a process group (one rank per process)
# --------------------------------------------------------------------------

def _all_gather_flat(out, x, group):
    """``all_gather_single`` where torch has it (newer releases deprecate
    its old name ``all_gather_into_tensor``)."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _wire_sum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The group's tensors summed in rank order: rank i receives chunk i
    of every rank's tensor (all-to-all), adds them in rank order, and the
    summed chunks are gathered."""
    flat = x.contiguous().reshape(-1)
    chunk = -(-flat.numel() // n)
    send = torch.nn.functional.pad(flat, (0, n * chunk - flat.numel()))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    mine = _ordered_sum(list(recv.view(n, chunk).unbind(0)))
    out = torch.empty_like(send)
    _all_gather_flat(out, mine, group=group)
    return out[:flat.numel()].view(x.shape)


def _wire_reduce_scatter(g: torch.Tensor, group, n: int, dim: int):
    """Slice i along ``dim`` of the group's tensors, summed in rank order,
    to rank i: an all-to-all of the slices, then the ordered sum."""
    parts = [c.contiguous().reshape(-1) for c in _chunks(g, n, dim)]
    send = torch.cat(parts)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    mine = _ordered_sum(list(recv.view(n, -1).unbind(0)))
    return mine.view(_chunks(g, n, dim)[0].shape)


def _wire_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, x.contiguous().reshape(-1), group=group)
    return torch.cat(list(out.view((n,) + tuple(x.shape)).unbind(0)), dim=dim)


class _WireSum(torch.autograd.Function):
    """:func:`_wire_sum`; backward, the same ordered sum of the output's
    cotangents (the cotangent itself where the result is replicated)."""

    @staticmethod
    def forward(ctx, x, group, n, replicated, record):
        ctx.group, ctx.n, ctx.replicated, ctx.record = group, n, replicated, record
        return _wire_sum(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.replicated:
            ctx.record("sum", grad)
            grad = _wire_sum(grad, ctx.group, ctx.n)
        return grad, None, None, None, None


class _WireCopy(torch.autograd.Function):
    """The tensor itself; backward, the group's ordered sum."""

    @staticmethod
    def forward(ctx, x, group, n, record):
        ctx.group, ctx.n, ctx.record = group, n, record
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        ctx.record("sum", grad)
        return _wire_sum(grad, ctx.group, ctx.n), None, None, None


class _WireGather(torch.autograd.Function):
    """:func:`_wire_gather`; backward, this rank's slice of the group's
    ordered sum of the cotangents (of its own cotangent where the result
    is replicated)."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim, replicated, record):
        ctx.args = (group, n, index, dim, replicated, record)
        return _wire_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, grad):
        group, n, index, dim, replicated, record = ctx.args
        if replicated:
            g = _chunks(grad, n, dim)[index].contiguous()
        else:
            record("reduce_scatter", grad)
            g = _wire_reduce_scatter(grad, group, n, dim)
        return g, None, None, None, None, None, None


def _wire_group(op: str, tensors: Tuple[torch.Tensor, ...], dim: int,
                group, index: int, n: int, replicated: bool = False,
                record=None):
    _refuse_grad(op, tensors)
    grad_on = _needs_grad(tensors)
    if op == "exchange":
        bottom, top = (t.contiguous() for t in tensors)
        if n == 1:                    # the pair (0, 0): a local copy
            return bottom.clone(), top.clone()
        from_above = torch.empty_like(bottom)
        from_below = torch.empty_like(top)
        down = dist.get_global_rank(group, (index + 1) % n)
        up = dist.get_global_rank(group, (index - 1) % n)
        # both directions in one batch: posted one by one, a ring of
        # blocking sends would deadlock
        ops = [dist.P2POp(dist.isend, bottom, down, group),
               dist.P2POp(dist.isend, top, up, group),
               dist.P2POp(dist.irecv, from_above, up, group),
               dist.P2POp(dist.irecv, from_below, down, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return from_above, from_below
    (x,) = tensors
    x = x.contiguous()
    if op == "copy":
        return _WireCopy.apply(x, group, n, record) if grad_on else x
    if op == "sum" and x.is_floating_point():
        if grad_on:
            return _WireSum.apply(x, group, n, replicated, record)
        return _wire_sum(x, group, n)
    if op == "all_gather":
        if grad_on:
            return _WireGather.apply(x, group, n, index, dim, replicated,
                                     record)
        return _wire_gather(x, group, n, dim)
    if op in ("sum", "max"):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
        return out
    raise ValueError(f"unknown collective {op!r}")


def _steps(req: Collective):
    """A request as single-axis steps: a reduction over several axes runs
    axis by axis in the order given; ``mean`` is a sum divided by the
    group's size."""
    if req.op in ("exchange", "all_gather") and len(req.axis) != 1:
        raise ValueError(f"{req.op} runs over one axis, got {req.axis}")
    op = "sum" if req.op == "mean" else req.op
    return [(op, a) for a in req.axis]


def _nbytes(req: Collective) -> int:
    return sum(t.numel() * t.element_size() for t in req.tensors)


def _finish(req: Collective, out, sizes: Dict[str, int]):
    if req.op != "mean":
        return out
    n = 1
    for a in req.axis:
        n *= sizes[a]
    return out / n


def _recorder(stats: CommStats | None, ranks: Sequence[int], axis: str):
    """``record(op, cotangent)`` for the backward: each of ``ranks``
    hands the cotangent's bytes to the op over ``axis``."""
    def record(op: str, g: torch.Tensor) -> None:
        if stats is not None:
            for r in ranks:
                stats.add(r, op, axis, g.numel() * g.element_size(), True)
    return record


def _autograd(reqs: Sequence[Collective]) -> list:
    """Every request's gradients, in one call: each output's cotangent
    ones unless given, and zeros for an input no output reaches."""
    outs, gouts, ins = [], [], []
    for r in reqs:
        inputs, given = r.extra
        outs += list(r.tensors)
        gouts += list(given) if given is not None else \
            [torch.ones_like(t) for t in r.tensors]
        ins += list(inputs)
    live = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in live], ins,
                              [g for _, g in live], allow_unused=True) \
        if live else [None] * len(ins)
    got = [torch.zeros_like(x) if g is None else g for x, g in zip(ins, got)]
    res, at = [], 0
    for r in reqs:
        k = len(r.extra[0])
        res.append(tuple(got[at:at + k]))
        at += k
    return res


def run_spmd(body: Generator, mesh, stats: CommStats | None = None):
    """Drive this process's rank body over ``mesh`` (a ``DeviceMesh``);
    returns what the body returns."""
    stats = stats if stats is not None else _RECORDING.get()
    sizes = mesh_shape(mesh)
    index = {a: int(mesh.get_local_rank(a)) for a in sizes}
    me = dist.get_rank()
    try:
        req = next(body)
        while True:
            if req.op == "grad":
                req = body.send(_autograd([req])[0])
                continue
            if stats is not None:
                stats.record(me, req)
            cur = req.tensors
            for op, a in _steps(req):
                out = _wire_group(op, cur, req.dim, mesh.get_group(a),
                                  index[a], sizes[a], req.replicated,
                                  _recorder(stats, [me], a))
                cur = out if isinstance(out, tuple) else (out,)
            res = cur if req.op == "exchange" else _finish(req, cur[0], sizes)
            req = body.send(res)
    except StopIteration as stop:
        return stop.value


def run_local(body: Generator):
    """Drive a rank body that asks for no collective (its gradients at
    most); returns its output."""
    try:
        req = next(body)
        while req.op == "grad":
            req = body.send(_autograd([req])[0])
    except StopIteration as stop:
        return stop.value
    raise RuntimeError(f"a {req.op} over {req.axis} asked outside a mesh")


def run_in_process(make_body: Callable[[int, RankContext], Generator],
                   mesh: InProcessMesh, stats: CommStats | None = None) -> list:
    """Run the rank bodies of every rank of ``mesh`` in this process:
    ``make_body(rank, ctx)`` makes rank ``rank``'s body. Each runs up to
    its next collective, in a context of its own; once all have asked,
    the collective runs over the list of their tensors. Returns the
    ranks' outputs in rank order."""
    sizes = mesh_shape(mesh)
    bodies = [make_body(r, RankContext(mesh.coords(r), sizes))
              for r in range(mesh.size)]
    contexts = [contextvars.copy_context() for _ in bodies]
    try:
        return _take_turns(bodies, contexts, mesh, sizes, stats)
    except BaseException:
        # a rank failed: close every body in its own context (a body's
        # context managers reset their variables there)
        for c, b in zip(contexts, bodies):
            c.run(b.close)
        raise


def _take_turns(bodies, contexts, mesh, sizes, stats) -> list:
    reqs = [c.run(next, b) for c, b in zip(contexts, bodies)]
    results: list = [None] * mesh.size
    while True:
        if any(r is None for r in reqs):
            if not all(r is None for r in reqs):
                raise RuntimeError("rank bodies ended at different steps")
            return results
        ops = {(r.op, r.axis, r.dim) for r in reqs}
        if len(ops) != 1:
            raise RuntimeError(f"ranks asked for different collectives: {ops}")
        req0 = reqs[0]
        if req0.op == "grad":
            _send_all(bodies, contexts, reqs, results, _autograd(reqs))
            continue
        if stats is not None:
            for rank, r in enumerate(reqs):
                stats.record(rank, r)
        cur = [r.tensors for r in reqs]
        for op, a in _steps(req0):
            nxt: list = [None] * mesh.size
            groups: Dict[tuple, list] = {}
            for rank in range(mesh.size):
                c = mesh.coords(rank)
                key = tuple(v for k, v in c.items() if k != a)
                groups.setdefault(key, []).append((c[a], rank))
            for members in groups.values():
                members.sort()
                outs = _local_group(
                    op, [cur[rk] for _, rk in members], req0.dim,
                    req0.replicated,
                    _recorder(stats, [rk for _, rk in members], a))
                for (_, rk), o in zip(members, outs):
                    nxt[rk] = o if isinstance(o, tuple) else (o,)
            cur = nxt
        _send_all(bodies, contexts, reqs, results, [
            cur[rank] if req0.op == "exchange"
            else _finish(req0, cur[rank][0], sizes)
            for rank in range(mesh.size)])


def _send_all(bodies, contexts, reqs, results, res) -> None:
    """Hand each rank its result and take its next request (or its
    output, where its body returns)."""
    for rank, b in enumerate(bodies):
        try:
            reqs[rank] = contexts[rank].run(b.send, res[rank])
        except StopIteration as stop:
            reqs[rank] = None
            results[rank] = stop.value


def spec_axes(entry) -> AxisNames:
    """The mesh axes one dim of a PartitionSpec names (``()`` for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def gather_dims(x: torch.Tensor, spec, sizes, dims=None, keep=None,
                replicated=()):
    """Rank body step: ``x``'s shards gathered along ``dims`` (default:
    every sharded dim), each dim over the axes ``spec`` names for it
    (those in ``keep`` only, where given), minor to major, so the shards
    land in the order :func:`local_slices` cut them; an axis of one rank
    (``sizes``) holds the whole dim already. A gather over an axis in
    ``replicated`` feeds a computation every rank of the axis repeats
    (its gradient: each rank's own slice)."""
    for d in range(len(spec)) if dims is None else dims:
        if d >= len(spec):
            continue
        for a in reversed(spec_axes(spec[d])):
            if sizes[a] > 1 and (keep is None or a in keep):
                x = yield all_gather(a, x, d, a in replicated)
    return x


def local_slices(spec: Sequence[Any], shape: Sequence[int],
                 sizes: Dict[str, int], index: Dict[str, int]) -> tuple:
    """The slice of a tensor of ``shape`` that the rank at ``index`` holds
    under ``spec`` (a PartitionSpec: per dim ``None``, an axis name or a
    tuple of names). A dim split over several axes splits major to minor
    in the order named, as JAX's ``NamedSharding`` does."""
    out = []
    for d, n_d in enumerate(shape):
        s = spec[d] if d < len(spec) else None
        if s is None:
            out.append(slice(None))
            continue
        idx, n = 0, 1
        for a in _axes(s):
            idx = idx * sizes[a] + index[a]
            n *= sizes[a]
        if n_d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways ({s})")
        c = n_d // n
        out.append(slice(idx * c, (idx + 1) * c))
    return tuple(out)


def assemble(parts: Dict[int, torch.Tensor], spec: Sequence[Any],
             shape: Sequence[int], mesh: InProcessMesh) -> torch.Tensor:
    """The full tensor from the in-process ranks' shards (ranks that hold
    the same slice must agree; the lowest rank's is taken)."""
    sizes = mesh_shape(mesh)
    first = next(iter(parts.values()))
    out = torch.empty(tuple(shape), dtype=first.dtype, device=first.device)
    seen = set()
    for rank in sorted(parts):
        sl = local_slices(spec, shape, sizes, mesh.coords(rank))
        key = tuple((s.start, s.stop) for s in sl)
        if key not in seen:
            seen.add(key)
            out[sl] = parts[rank]
    return out

