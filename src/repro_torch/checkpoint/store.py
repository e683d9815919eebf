"""Checkpointing: atomic per-leaf .npy stores with a JSON manifest and an
async writer thread (port of ``repro/checkpoint/store.py``).

Layout, the reference's byte for byte:

    <dir>/step_<N>.tmp-<pid>/ ... -> atomic rename -> <dir>/step_<N>/
    <dir>/step_<N>/manifest.json  {"step", "leaves": {key: {file, shape, dtype}}}
    <dir>/step_<N>/<key with "/" -> "__">.npy, one per flattened leaf

List and tuple items are keyed ``__seq<i>`` and NamedTuples are stored as
dicts. numpy has no bfloat16: the reference writes an ml_dtypes bfloat16
leaf as a 2-byte void (``'<V2'`` in the .npy header) with ``"bfloat16"``
in the manifest. The port writes a bfloat16 tensor the same way and
reads such a leaf back by its manifest dtype; the reference's own
``restore_into`` cannot cast that void array back.

Fault-tolerance contract: a crash mid-write never corrupts the latest
complete checkpoint (the tmp directory is abandoned and
:func:`latest_step` ignores it).

Deviation from the reference: :meth:`AsyncCheckpointer.wait` returns once
every queued write has finished (``Queue.join``); the reference polls
``Queue.empty()``, which is true as soon as the writer takes an item,
before the item is written. :meth:`AsyncCheckpointer.close` joins the
writer thread without a timeout, where the reference's 10 s timeout
could drop a longer write without an error.

Sharded trees: a DTensor leaf is gathered whole on every rank (a
collective: every rank saves), rank 0 writes, and :func:`save_checkpoint`
holds the other ranks at a barrier until the store is published.
:func:`restore_into` lays a DTensor template leaf out as the template
is, and :func:`reshard` places a tree on another mesh (elastic restore
onto a different mesh shape)."""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import flatten_dict, unflatten_dict

#: the .npy header descr the reference's ml_dtypes bfloat16 leaves carry
BF16_DESCR = "<V2"


def _as_dict(tree: Any) -> Any:
    """NamedTuples -> dicts so flatten/unflatten round-trips through JSON."""
    if hasattr(tree, "_asdict"):
        return {k: _as_dict(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {f"__seq{i}": _as_dict(v) for i, v in enumerate(tree)}
    return tree


def _is_dtensor(v: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(v, DTensor)


def _host_leaf(v: Any) -> Any:
    """A host copy of one leaf: a CPU tensor for a tensor (a device tensor
    is copied synchronously; a DTensor is gathered whole first), else a
    numpy array."""
    if _is_dtensor(v):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return np.asarray(v)


def _sharded(tree: Any) -> bool:
    """Whether any leaf is a DTensor (then every rank of its mesh saves)."""
    return any(_is_dtensor(v) for v in flatten_dict(_as_dict(tree)).values())


def _writer() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(tree: Any, keep: bool = True) -> Optional[dict]:
    """Host copies of the tree's leaves. Every DTensor is gathered whole
    (a collective each rank of its mesh joins); a rank that does not
    write passes ``keep=False`` and copies nothing to the host."""
    flat = flatten_dict(_as_dict(tree))
    if not keep:
        for v in flat.values():
            if _is_dtensor(v):
                v.full_tensor()
        return None
    return {k: _host_leaf(v) for k, v in flat.items()}


def _fn_safe(key: str) -> str:
    return key.replace("/", "__")


def _write_leaf(path: str, v: Any) -> tuple:
    """Write one host leaf as .npy; returns (shape, manifest dtype)."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        bits = v.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False,
                    "shape": tuple(bits.shape)})
            f.write(bits.tobytes())
        return list(bits.shape), "bfloat16"
    arr = v.contiguous().numpy() if isinstance(v, torch.Tensor) else v
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _sharded(tree):                # every rank gathers; rank 0 writes
        import torch.distributed as dist
        flat = _to_host(tree, keep=_writer())
        if flat is not None:
            _write_store(ckpt_dir, final, step, flat)
        dist.barrier()
        return final
    return _write_store(ckpt_dir, final, step, _to_host(tree))


def _write_store(ckpt_dir: str, final: str, step: int, flat: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for k, v in flat.items():
        fname = _fn_safe(k) + ".npy"
        shape, dtype = _write_leaf(os.path.join(tmp, fname), v)
        manifest[k] = {"file": fname, "shape": shape, "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":                     # 2-byte void payload
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> tuple[int, dict]:
    """Returns (step, nested dict of CPU tensors), each leaf of its
    manifest dtype. Use :func:`restore_into` to place them."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {k: _read_leaf(os.path.join(path, meta["file"]), meta["dtype"])
            for k, meta in manifest["leaves"].items()}
    return manifest["step"], unflatten_dict(flat)


def restore_into(template: Any, loaded: dict, *, in_place: bool = False) -> Any:
    """Map a loaded nested dict back into the structure of ``template``
    (NamedTuples / tuples restored). A tensor leaf comes back on its
    template leaf's device and dtype: bitwise the saved values where the
    dtypes agree. A DTensor template leaf gives a DTensor on its mesh,
    laid out as the template is. ``in_place``: every tensor leaf (not a
    DTensor) is written into the template's own tensor, which the result
    holds (a captured train step's standing state keeps its addresses)."""
    def rec(tmpl, node):
        if hasattr(tmpl, "_asdict"):
            return type(tmpl)(**{k: rec(v, node[k])
                                 for k, v in tmpl._asdict().items()})
        if isinstance(tmpl, dict):
            return {k: rec(v, node[k]) for k, v in tmpl.items()}
        if isinstance(tmpl, (list, tuple)):
            vals = [rec(v, node[f"__seq{i}"]) for i, v in enumerate(tmpl)]
            return type(tmpl)(vals) if isinstance(tmpl, list) else tuple(vals)
        t = node if isinstance(node, torch.Tensor) else torch.as_tensor(node)
        if _is_dtensor(tmpl):
            return _place(t.to(tmpl.dtype), tmpl.device_mesh, tmpl.placements)
        if isinstance(tmpl, torch.Tensor):
            if in_place:
                with torch.no_grad():
                    return tmpl.copy_(t.to(dtype=tmpl.dtype))
            return t.to(device=tmpl.device, dtype=tmpl.dtype)
        if hasattr(tmpl, "dtype"):
            return t.numpy().astype(tmpl.dtype)
        return t
    return rec(template, loaded)


def _place(full: torch.Tensor, mesh, placements):
    """A full tensor laid out on ``mesh`` with ``placements``: each rank
    keeps its own slice (no communication), bitwise the full values."""
    from torch.distributed.tensor import distribute_tensor
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return distribute_tensor(full.to(dev), mesh, placements,
                             src_data_rank=None)


def reshard(tree: Any, shardings: Any) -> Any:
    """Elastic placement: lay each leaf out with its sharding (a
    ``distributed.sharding.NamedSharding``, the tree of them from
    ``named_sharding_tree``); works across meshes other than the one the
    tree was saved or placed on. A DTensor leaf is gathered whole first
    (every rank of its mesh must call)."""
    from repro_torch.distributed.sharding import tree_map

    def one(leaf, sh):
        full = leaf.full_tensor() if _is_dtensor(leaf) else leaf
        return _place(full, sh.mesh, sh.placements)
    return tree_map(one, tree, shardings,
                    is_leaf=lambda x: isinstance(x, torch.Tensor))


class AsyncCheckpointer:
    """Background writer: snapshot to the host synchronously, write in a
    thread (training continues during serialization), keep the newest
    ``keep`` checkpoints. The snapshot is a blocking copy on the current
    stream, so it has finished before the next step (a replay that
    rewrites a standing state in place) is queued; only the file write
    overlaps training. ``snapshot_s`` and ``write_s`` hold each save's
    snapshot and write seconds; ``busy`` says whether a write is queued
    or in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.snapshot_s: list[float] = []
        self.write_s: list[float] = []
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, host_tree = item
                t0 = time.perf_counter()
                try:
                    save_checkpoint(self.ckpt_dir, step, host_tree)
                    self._gc()
                except BaseException as e:      # surfaced on next save/wait
                    self._err = e
                self.write_s.append(time.perf_counter() - t0)
            finally:
                self._q.task_done()

    def _gc(self):
        names = sorted(n for n in os.listdir(self.ckpt_dir)
                       if n.startswith("step_") and ".tmp" not in n)
        for name in names[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, name), ignore_errors=True)

    @property
    def busy(self) -> bool:
        return self._q.unfinished_tasks > 0

    def save(self, step: int, tree: Any):
        if self._err:
            raise self._err
        t0 = time.perf_counter()
        # sync snapshot, async write; of a sharded tree rank 0 writes
        host_tree = _to_host(tree, keep=_writer())
        self.snapshot_s.append(time.perf_counter() - t0)
        if host_tree is not None:
            self._q.put((step, host_tree))

    def wait(self):
        """Block until every queued write has finished."""
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._t.join()
