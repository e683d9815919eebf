"""Logical-axis sharding rules (port of ``repro/distributed/sharding.py``).

Every parameter leaf in the model zoo carries a tuple of *logical* axis
names (one per tensor dim, ``None`` for unsharded dims). A rule table maps
logical axes onto physical mesh axes ``("pod", "data", "model")``. Two
rule tables ship by default:

  * DEFAULT_RULES — tensor parallelism only (params replicated over data);
  * FSDP_RULES    — additionally shards the *fsdp-tagged* dim over "data"
                    (+"pod" when present).

A :class:`PartitionSpec` is the port's counterpart of JAX's: one entry
per tensor dim, ``None``, a mesh-axis name or a tuple of names (the dim
then splits over those axes, major to minor). On a ``DeviceMesh`` a spec
becomes DTensor placements (:func:`spec_placements`): ``Shard(d)`` on
every mesh dim that names tensor dim ``d``, ``Replicate()`` on the rest.
A mesh is a ``DeviceMesh`` with named dims or an
:class:`~repro_torch.distributed.collectives.InProcessMesh`."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence

from repro_torch.distributed.collectives import mesh_shape


class MeshAxes:
    POD = "pod"
    DATA = "data"
    MODEL = "model"


class PartitionSpec(tuple):
    """A tuple of per-dim mesh axes (``P(None, "model")``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> physical mesh axis (str, tuple or None)."""
    rules: Mapping[str, Any]

    def physical(self, logical: Optional[str]) -> Any:
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.rules[logical]


_BASE = {
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "expert_mlp": "model",
    "vocab": "model",
    "conv": None,
    "state": None,
    "fsdp": None,           # DEFAULT: no FSDP
    "q_per_kv": None,
    "head_dim": None,
}

DEFAULT_RULES = AxisRules(dict(_BASE))
FSDP_RULES = AxisRules({**_BASE, "fsdp": "data"})


def fsdp_rules_for_mesh(mesh) -> AxisRules:
    """FSDP over ("pod","data") when the mesh has a pod axis, else ("data",)."""
    if "pod" in mesh_shape(mesh):
        return AxisRules({**_BASE, "fsdp": ("pod", "data")})
    return FSDP_RULES


def is_logical_axes(x: Any) -> bool:
    """A leaf of a logical-axes tree: a plain tuple of names and Nones."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def is_spec(x: Any) -> bool:
    return isinstance(x, PartitionSpec)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool]) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``): dicts keep their keys, lists, tuples and NamedTuples their
    type."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def logical_to_spec(axes: Sequence[Optional[str]], rules: AxisRules) -> P:
    """Tuple of logical axis names (len == ndim) -> PartitionSpec."""
    return P(*[rules.physical(a) for a in axes])


def specs_for_tree(logical_tree: Any, rules: AxisRules) -> Any:
    """Map a tree of logical-axes tuples to a tree of PartitionSpecs."""
    return tree_map(lambda axes: logical_to_spec(axes, rules), logical_tree,
                    is_leaf=is_logical_axes)


def _split(entry: Any, sizes: Mapping[str, int]) -> int:
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[a]
    return n


def sanitize_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop sharding on dims the mesh axes don't divide (replicate them).

    Centralized divisibility guard: odd dims (SSD in_proj=3352, 25 heads,
    vocab=32001, ...) fall back to replication instead of erroring."""
    sizes = mesh_shape(mesh)
    new = []
    for i, s in enumerate(spec):
        if s is None:
            new.append(None)
            continue
        new.append(s if (i < len(shape) and shape[i] % _split(s, sizes) == 0)
                   else None)
    return P(*new)


def sanitize_specs_tree(spec_tree: Any, shape_tree: Any, mesh) -> Any:
    """``shape_tree``'s leaves are anything with a ``.shape``."""
    return tree_map(lambda sp, sh: sanitize_spec(sp, tuple(sh.shape), mesh),
                    spec_tree, shape_tree, is_leaf=is_spec)


def spec_placements(spec: Sequence[Any], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim, in
    the mesh's order): ``Shard(d)`` where the mesh dim names tensor dim
    ``d``. A dim over several axes must name them in the mesh's order,
    which is the order DTensor splits them (major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    by_axis = {}
    for d, s in enumerate(spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for a in axes:
            if a in by_axis:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in names)


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def named_sharding_tree(spec_tree: Any, mesh) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=is_spec)


def batch_spec(mesh, *, replicate: bool = False) -> P:
    """PartitionSpec for the leading batch dim: shard over (pod, data)."""
    if replicate:
        return P(None)
    names = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in names]
    return P(tuple(axes) if len(axes) > 1 else axes[0])


def seq_spec(mesh) -> Any:
    """Axis to shard a sequence dim over (sequence parallelism for batch=1)."""
    return "data" if "data" in mesh_shape(mesh) else None
