"""Statistics of one traced rank program: FLOPs, memory, collective bytes
and the roofline (port of ``repro/launch/hlo_stats.py``).

The reference reads XLA's compiled executable: ``cost_analysis()``
(FLOPs), ``memory_analysis()`` (buffer assignment) and the partitioned
HLO text, whose collective ops it parses with regexes
(``collective_stats``). The port has no compiler and no HLO, so
``collective_stats`` and its regexes have no counterpart here. Its
statistics come from one run of the rank program (``launch.dryrun``:
fake tensors on a fake process group), watched by two dispatch modes:

  * ``torch.utils.flop_counter.FlopCounterMode`` counts FLOPs (the
    kernels K1-K5 count through the formulas of their operators,
    ``kernels.library``);
  * :class:`TraceStats` follows the storages the run makes (memory, by
    weak references, as ``torch.distributed._tools.mem_tracker`` does),
    the collectives it hands ``torch.distributed`` (the
    ``_c10d_functional`` and ``c10d`` operators, with the process group
    each runs on, so the mesh axis) and the kernel operators it calls.

Collective bytes keep the reference's ring convention per chip:
all-gather, reduce-scatter, all-to-all and collective-permute (a
``send``) count their result bytes once, all-reduce twice (reduce and
broadcast phases). ``handed_bytes`` is what the rank hands the
operators on the wire (their inputs); what a rank body asked of each
collective (``collectives.CommStats``'s convention) is the dry run's
``collectives["requested"]``.

Keys the port cannot count are present and ``None`` (listed under
``absent``): ``cost["bytes accessed"]`` and ``cost["transcendentals"]``
(per-op HLO counts; the roofline's memory term uses
:func:`structural_bytes`, as the reference's does) and
``memory["generated_code_bytes"]`` (no compiled code).

Hardware model: one NVIDIA H100 SXM per rank."""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 Tensor Core GPU data sheet (SXM5): dense BF16 tensor-core
# rate without sparsity, and the HBM3 bandwidth
PEAK_FLOPS = 989e12          # FLOP/s / chip
HBM_BW = 3.35e12             # bytes/s / chip
# the same sheet: NVLink 4 at 900 GB/s per GPU, both directions together,
# so 450 GB/s each way; a 16 x 16 pod of 256 cards is one NVLink domain
# (DGX H100 SuperPOD with the NVLink Switch System, 256 GPUs)
ICI_BW = 450e9               # bytes/s / chip, one direction
# between pods: one ConnectX-7 InfiniBand NDR port of 400 Gb/s per GPU
# (NVIDIA DGX H100 user guide, networking), 50 GB/s each way
DCN_BW = 50e9                # bytes/s / chip, one direction, over "pod"

_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}

#: operator -> (collective kind, index of its process-group or group-name
#: argument, index of its input, index of its result (None: the output))
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 2, 0, None),
    "_c10d_functional::all_reduce": ("all-reduce", 2, 0, None),
    "_c10d_functional::all_reduce_": ("all-reduce", 2, 0, None),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 3, 0, None),
    "_c10d_functional::all_to_all_single": ("all-to-all", 3, 0, None),
    "c10d::_allgather_base_": ("all-gather", 2, 1, 0),
    "c10d::allreduce_": ("all-reduce", 1, 0, 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 2, 1, 0),
    "c10d::alltoall_base_": ("all-to-all", 2, 1, 0),
    "c10d::send": ("collective-permute", 1, 0, 0),
}

ABSENT = {
    "cost.bytes accessed": "per-op memory traffic of a compiled HLO module; "
                           "the roofline uses structural_bytes instead",
    "cost.transcendentals": "an HLO cost-analysis count; FlopCounterMode "
                            "counts none",
    "memory.generated_code_bytes": "no compiled code",
}


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _group_name(arg) -> str:
    if isinstance(arg, str):
        return arg
    return dist.ProcessGroup.unbox(arg).group_name


class TraceStats(TorchDispatchMode):
    """Memory, collectives and kernel operators of a run (see the module
    docstring). ``axes`` maps a process group's name to its mesh axis,
    ``sizes`` an axis to its size (a collective over an axis of one rank
    moves nothing and is not counted); :meth:`arguments` registers the
    rank's inputs before the run."""

    def __init__(self, axes: Optional[Dict[str, str]] = None,
                 sizes: Optional[Dict[str, int]] = None):
        super().__init__()
        self.axes = axes or {}
        self.sizes = sizes or {}
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._args: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._fake_mode = None
        self.by_kind: Dict[str, dict] = defaultdict(
            lambda: {"count": 0, "bytes": 0, "handed_bytes": 0})
        self.by_axis: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, int] = defaultdict(int)

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        if t.device.type == "meta":
            return 0
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, n: int) -> None:
        self.live -= n

    def _walk(self, x, fn) -> None:
        if isinstance(x, torch.Tensor):
            fn(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                self._walk(v, fn)
        elif isinstance(x, dict):
            for v in x.values():
                self._walk(v, fn)

    def arguments(self, tree) -> None:
        """Register the rank's inputs (their storages, each once)."""
        def add(t):
            t = _local(t)
            self._args[t.untyped_storage()] = True
            self.argument_bytes += self._track(t)
        self._walk(tree, add)

    def new_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree`` that are not an argument's:
        the run's output bytes."""
        seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

        def add(t):
            st = _local(t).untyped_storage()
            if st not in self._args and st not in seen:
                seen[st] = st.nbytes()
        self._walk(tree, add)
        return int(sum(seen.values()))

    # -- dispatch ----------------------------------------------------------
    def __enter__(self):
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor or (isinstance(t, type) and issubclass(t, DTensor))
               for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        name = func._overloadpacket._qualified_op_name
        if name == "_c10d_functional::wait_tensor":
            out = args[0]            # a fake run's wait makes a new tensor
        else:
            out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode:
            return out               # DTensor's own shape propagation
        if name.startswith("repro_torch::"):
            self.kernels[name.split("::", 1)[1]] += 1
        coll = _COLLECTIVES.get(name)
        axis = None if coll is None else self.axes.get(
            _group_name(args[coll[1]]), "?")
        if coll is not None and self.sizes.get(axis) != 1:
            kind, _, in_ix, res_ix = coll
            result = out if res_ix is None else args[res_ix]
            rb = _nbytes(result)
            entry = self.by_kind[kind]
            entry["count"] += 1
            entry["bytes"] += int(rb * _FACTOR[kind])
            entry["handed_bytes"] += _nbytes(args[in_ix])
            self.by_axis[axis] += int(rb * _FACTOR[kind])
        self._walk(out, self._track)
        return out

    # -- results -----------------------------------------------------------
    def collectives(self) -> dict:
        by_kind = {k: dict(v) for k, v in self.by_kind.items()}
        return {"by_kind": by_kind,
                "total_bytes": int(sum(v["bytes"] for v in by_kind.values())),
                "handed_bytes": int(sum(v["handed_bytes"]
                                        for v in by_kind.values())),
                "by_axis": dict(self.by_axis),
                "pod_bytes": int(self.by_axis.get("pod", 0))}


def structural_bytes(mem: dict) -> int:
    """HBM-traffic estimate from the buffers of the run: arguments are
    read (params/opt/cache: read+written when donated/updated), temps are
    written+read once each, outputs written (the reference's formula)."""
    return int(2 * mem["argument_bytes"] + mem["output_bytes"]
               + 2 * mem["temp_bytes"])


def roofline_terms(cost: dict, coll: dict, meta: dict,
                   mem: dict | None = None) -> dict:
    """Three roofline terms (seconds) from per-chip quantities: the
    reference's formulas, with the bytes that cross pods (``pod_bytes``
    of ``coll``, where present) over :data:`DCN_BW` and the rest over
    :data:`ICI_BW`."""
    flops = float(cost.get("flops", 0.0))
    if mem is not None:
        bytes_hbm = float(structural_bytes(mem))
    else:
        bytes_hbm = float(cost.get("bytes accessed") or 0.0)
    bytes_coll = float(coll["total_bytes"])
    bytes_pod = float(coll.get("pod_bytes", 0))
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_hbm / HBM_BW
    t_coll = (bytes_coll - bytes_pod) / ICI_BW + bytes_pod / DCN_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]

    # useful-FLOPs ratio: MODEL_FLOPS / traced FLOPs (per chip)
    n_active = meta.get("active_params", meta.get("params", 0))
    tokens = meta["global_batch"] * (meta["seq_len"] if meta["kind"] == "train"
                                     else (meta["seq_len"] if meta["kind"] == "prefill" else 1))
    factor = 6.0 if meta["kind"] == "train" else 2.0
    model_flops_global = factor * n_active * tokens
    model_flops_chip = model_flops_global / meta["n_chips"]
    useful = model_flops_chip / flops if flops else 0.0

    step_time = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "hbm_bytes_chip": bytes_hbm, "collective_bytes_chip": bytes_coll,
        "model_flops_chip": model_flops_chip, "hlo_flops_chip": flops,
        "useful_flops_ratio": useful,
        "roofline_step_s": step_time,
        "model_flops_util": (model_flops_chip / PEAK_FLOPS) / step_time
        if step_time else 0.0,
    }


def summarize(run: Any, meta: dict) -> dict:
    """The reference's summary of a traced run (``launch.dryrun.FakeRun``:
    its ``flops``, ``memory`` and ``collectives``)."""
    mem = dict(run.memory)
    mem["generated_code_bytes"] = None
    mem["peak_bytes_per_chip"] = int(mem["argument_bytes"] + mem["temp_bytes"]
                                     + mem["output_bytes"])
    out = {
        "meta": meta,
        "cost": {"flops": float(run.flops), "bytes accessed": None,
                 "transcendentals": None},
        "memory": mem,
        "collectives": run.collectives,
        "absent": dict(ABSENT),
    }
    out["roofline"] = roofline_terms(out["cost"], run.collectives, meta, mem)
    return out
