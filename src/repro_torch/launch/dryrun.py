"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): trace every
(arch × shape × mesh) cell's rank program on fake tensors and a fake
process group of the mesh's world, show that the distribution config is
coherent (sharding, memory per chip, collectives), and emit the
roofline inputs.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/dryrun_torch]
  python -m repro_torch.launch.dryrun --all --detr          # include DETR family
  python -m repro_torch.launch.dryrun --table --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --opt --arch mamba2-130m --device cpu --out DIR

``--opt`` traces the reference's optimized configuration (:func:`_opt_cfg`)
under the activation policy: the pure-DP archs' train and prefill cells
split each data group's sequence over the model axis
(``act_sharding.seq_split``). ``--device cpu`` traces on CPU tensors
standing for the card's, also on a CUDA build (to hold the two traces
against each other).

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` with the
reference's top-level keys (``meta``, ``cost``, ``memory``,
``collectives``, ``roofline``, ``timings``; the LM cells also
``raw_cost_uncorrected`` and ``collectives_corrected``) plus ``fits``
(the predicted peak against the card's memory) and ``trace`` (the
device the trace stood for, what the DETR plans were made for, the
kernel operators called, the world; an LM cell's parameter leaves
computed whole on every rank, ``input_specs.computed_whole``).
``collectives["requested"]`` holds the bytes the rank's bodies asked of
each collective by mesh axis (``collectives.CommStats``; a train cell's
backward sums and reduce-scatters included), where the other counts
follow the operators on the wire: a float sum there is an all-to-all and
an all-gather (the rank-order rule of ``distributed.collectives``). Existing results are skipped
(``--force`` redoes them). The output goes to ``results/dryrun_torch``,
never to the reference's ``results/dryrun``.

How a cell runs: one call of the cell's rank program (``Cell.fn``) for
rank 0, under ``FakeTensorMode`` (nothing is allocated, no kernel runs:
the kernels are operators with fake implementations,
``kernels.library``), on a fake process group of the mesh's world (256
or 512 ranks; ``torch.testing._internal.distributed.fake_pg``) with a
named ``DeviceMesh`` (``init_device_mesh``). On a build of PyTorch with
CUDA the fake tensors are on the card; on a build without it they are
CPU tensors standing for the H100's (``kernels.library.card_stand_in``),
because such a build cannot run every operator on fake CUDA tensors.

No two-point scan correction: the reference compiles each cell twice
more with a 1- and 2-layer scan unroll because XLA's cost analysis
counts a while loop's body once whatever its trip count. The port's
layers are a Python loop, so one trace counts every layer once each;
``raw_cost_uncorrected`` and ``collectives_corrected`` hold that single
count. A cell that does not fit the card is a result (``fits``), not a
failure: the train step gathers parameters whole, and the largest
models do not fit even split. A cell that raises is a failure; failures are collected and the
exit code is non-zero, as in the reference."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import tree_map as spec_tree_map
from repro_torch.kernels.library import H100_SXM, Card, card_stand_in
from repro_torch.launch.hlo_stats import TraceStats, summarize

# §Perf optimized configuration (--opt): activation-sharding constraints
# (O1/O2 via the cell's policy), save_comm remat (O6) and grad-accum
# boosts sized so train cells fit 16 GB/chip (O5).
OPT_ACCUM = {
    "olmoe-1b-7b": 4, "grok-1-314b": 8, "granite-20b": 8, "minitron-8b": 4,
    "minitron-4b": 4, "deepseek-7b": 4, "mamba2-130m": 4,
    "llava-next-34b": 8, "whisper-tiny": 2, "hymba-1.5b": 4,
}

# O2': physical q-head padding to the next TP-divisible count (output-masked,
# exact semantics) — removes the 16x attention replication for head counts
# that don't divide the model axis.
OPT_PAD_HEADS = {
    "llava-next-34b": 64,
}

# Small archs: TP-16 all-reduce cost (∝B·S·D) dwarfs their compute
# (∝B·S·D²/TP). Strategy switch: replicate weights, model axis carries
# sequence parallelism, ZeRO shards optimizer state (O7).
OPT_PURE_DP = {"minitron-4b", "mamba2-130m", "hymba-1.5b", "whisper-tiny"}

DEFAULT_OUT = "results/dryrun_torch"
DETR_CELLS = (("deformable-detr", ("serve", "train")),
              ("deformable-detr-defa", ("serve", "train", "banded")),
              ("dino", ("serve", "train")))


def _opt_cfg(arch: str, cfg, kind: str = "train"):
    """Kind-aware optimization: decode is weight-read bound — TP sharding of
    weights is already optimal there, and pure-DP / head padding / activation
    constraints REGRESSED decode cells (measured in §Perf). Exception: MoE
    decode keeps the explicit-EP path (olmoe decode collective 10.8→0.13 ms)."""
    if kind == "decode":
        return cfg, (cfg.family == "moe" and cfg.n_experts % 16 == 0)
    return dataclasses.replace(cfg, remat_policy="save_comm",
                               grad_accum=OPT_ACCUM.get(arch, cfg.grad_accum),
                               pad_heads_to=OPT_PAD_HEADS.get(arch, 0),
                               pure_dp=arch in OPT_PURE_DP), True


# --------------------------------------------------------------------------
# the fake world and the trace
# --------------------------------------------------------------------------

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def trace_device() -> str:
    """Where a fake trace's tensors lie: the card on a CUDA build, else
    CPU tensors standing for the card's."""
    return "cuda" if torch.version.cuda is not None else "cpu"


def card() -> Card:
    """The card the trace stands for: this machine's, else an H100 SXM."""
    if torch.cuda.is_available():
        p = torch.cuda.get_device_properties(0)
        return Card(p.name, int(p.L2_cache_size), int(p.total_memory),
                    int(p.multi_processor_count))
    return H100_SXM


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of ``world`` ranks (this process is
    rank 0): collectives on fake tensors return fake tensors of the
    right shape and move nothing. Any process group already set up is
    destroyed first and the fake one after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(names))


def axis_of_groups(mesh) -> Dict[str, str]:
    """Process-group name -> mesh axis, for ``TraceStats``."""
    return {mesh.get_group(a).group_name: a for a in C.mesh_shape(mesh)}


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor)


def rank_inputs(cell, mesh, device, make=None) -> tuple:
    """This rank's slice of every input leaf of ``cell``: ``make(shape,
    dtype, device)`` (default ``torch.empty``) per leaf."""
    make = make or (lambda shape, dtype, dev: torch.empty(shape, dtype=dtype,
                                                          device=dev))
    ctx = C.rank_context(mesh)

    def leaf(t, spec):
        sl = C.local_slices(spec, tuple(t.shape), ctx.size, ctx.index)
        shape = tuple(len(range(*s.indices(n))) for s, n in zip(sl, t.shape))
        return make(shape, t.dtype, device)

    return tuple(spec_tree_map(leaf, sds, sh, is_leaf=_is_leaf)
                 for sds, sh in zip(cell.in_specs, cell.in_shardings))


class FakeRun(NamedTuple):
    flops: int
    flops_by_op: Dict[str, int]
    memory: Dict[str, int]        # argument, output, temp bytes
    collectives: dict
    kernels: Dict[str, int]       # kernel operators called, by name
    planned_for: Optional[str]    # the platform a plan made now is for
    seconds: float


def _flops_by_op(fc) -> Dict[str, int]:
    counts = fc.get_flop_counts().get("Global", {})
    return {str(k): int(v) for k, v in counts.items()}


def trace(cell, mesh, device: Optional[str] = None) -> FakeRun:
    """One fake run of ``cell.fn`` for this process's rank of ``mesh``
    (a ``DeviceMesh`` over the fake world)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.msda.plan import platform_key
    device = device or trace_device()
    t0 = time.perf_counter()
    stand_in = card_stand_in() if device == "cpu" else contextlib.nullcontext()
    with FakeTensorMode(allow_non_fake_inputs=True), stand_in:
        planned_for = platform_key(device)
        inputs = rank_inputs(cell, mesh, device)
        stats = TraceStats(axis_of_groups(mesh), C.mesh_shape(mesh))
        stats.arguments(inputs)
        requested = C.CommStats()
        with FlopCounterMode(display=False) as fc, stats, \
                C.recording(requested):
            out = cell.fn(*inputs)
        out_bytes = stats.new_bytes(out)
        memory = {"argument_bytes": int(stats.argument_bytes),
                  "output_bytes": int(out_bytes),
                  "temp_bytes": int(max(0, stats.peak - stats.argument_bytes
                                        - out_bytes))}
    collectives = stats.collectives()
    collectives["requested"] = requested.by_axis.get(dist.get_rank(), {})
    return FakeRun(int(fc.get_total_flops()), _flops_by_op(fc), memory,
                   collectives, dict(stats.kernels), planned_for,
                   time.perf_counter() - t0)


def real_inputs(cell, mesh, device, gen: torch.Generator) -> tuple:
    """This rank's slices as real tensors on ``device``: floats drawn from
    ``gen`` (normal, scaled by 0.02), integers 0."""
    def make(shape, dtype, dev):
        if dtype.is_floating_point:
            return (torch.randn(shape, generator=gen, device=dev) * 0.02
                    ).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=dev)
    return rank_inputs(cell, mesh, device, make)


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    from repro_torch.optim.adamw import tree_leaves
    return int(sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in tree_leaves(tree)}.values()))


def run_real(make_cell, device, reps: int = 5, seed: int = 0,
             mesh_shape=((1, 1), ("data", "model"))) -> dict:
    """The cell's rank program run for real on ``device``, in a world of
    one rank (NCCL on a card, gloo on the CPU) on a mesh of one rank: the
    counterpart of one fake trace. Returns the FLOPs of its first call
    (``FlopCounterMode``), the bytes of the placed inputs, the card's
    peak above what was allocated before them (None on the CPU), and the
    host-clock ms of ``reps`` more calls (each ending in a
    synchronize)."""
    from torch.utils.flop_counter import FlopCounterMode
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if dist.is_initialized():
        dist.destroy_process_group()
    device = torch.device(device)
    card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if card else (lambda: None)
    dist.init_process_group("nccl" if card else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=device if card else None)
    try:
        shape, names = mesh_shape
        mesh = device_mesh(shape, names, device.type)
        cell = make_cell(mesh)
        base = torch.cuda.memory_allocated(device) if card else 0
        inputs = real_inputs(cell, mesh, device,
                             torch.Generator(device=device).manual_seed(seed))
        sync()
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        with FlopCounterMode(display=False) as fc:
            out = cell.fn(*inputs)
        sync()
        peak = torch.cuda.max_memory_allocated(device) - base if card else None
        del out
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = cell.fn(*inputs)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            del out
        return {"flops": int(fc.get_total_flops()),
                "flops_by_op": _flops_by_op(fc),
                "argument_bytes": _storage_bytes(inputs),
                "peak_bytes": peak, "step_ms": ms, "calls": 1 + reps,
                "meta": cell.meta}
    finally:
        dist.destroy_process_group()


def fits(peak: int, the_card: Card) -> dict:
    return {"card": the_card.name, "card_memory_bytes": the_card.memory_bytes,
            "peak_bytes_per_chip": int(peak),
            "fits": bool(peak <= the_card.memory_bytes)}


def result_of(run: FakeRun, cell, world: int, device: str) -> dict:
    result = summarize(run, cell.meta)
    the_card = card()
    result["fits"] = fits(result["memory"]["peak_bytes_per_chip"], the_card)
    result["trace"] = {
        "fake": True, "device": device, "stands_for": the_card.name,
        "world": world, "planned_for": run.planned_for,
        "kernels": run.kernels, "flops_by_op": run.flops_by_op,
        "torch": torch.__version__}
    if cell.computed_whole is not None:
        result["trace"]["computed_whole"] = cell.computed_whole
    result["timings"] = {"trace_s": run.seconds}
    return result


def run_fake(make_cell, mesh_kind: Optional[str],
             device: Optional[str] = None, mesh_shape=None) -> dict:
    """Build a cell on the mesh (``make_cell(mesh)``; the mesh of
    ``mesh_kind``, or ``mesh_shape`` = (shape, axis names)) inside a fake
    world and trace it; returns the cell's result dict."""
    shape, names = mesh_shape or MESHES[mesh_kind]
    world = math.prod(shape)
    device = device or trace_device()
    with fake_world(world):
        mesh = device_mesh(shape, names, device)
        cell = make_cell(mesh)
        return result_of(trace(cell, mesh, device), cell, world, device)


def _write(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def _print(tag: str, result: dict) -> None:
    ma, rf = result["memory"], result["roofline"]
    print(f"[dryrun] {tag}: OK  peak={ma['peak_bytes_per_chip']/2**30:.2f}GiB/chip "
          f"fits={result['fits']['fits']} "
          f"compute={rf['t_compute_s']*1e3:.2f}ms mem={rf['t_memory_s']*1e3:.2f}ms "
          f"coll={rf['t_collective_s']*1e3:.2f}ms dom={rf['dominant']} "
          f"useful={rf['useful_flops_ratio']:.2f} "
          f"(trace {result['timings']['trace_s']:.1f}s)", flush=True)


def lm_cell(arch: str, shape, opt: bool = False, **cfg_fields):
    """``cell(mesh)`` of an LM cell: ``shape`` a name of ``SHAPES`` or a
    ``ShapeSpec``; ``opt`` the ``--opt`` configuration and policy;
    ``cfg_fields`` replace config fields (e.g. a cut depth)."""
    from repro_torch.launch.input_specs import build_cell
    cfg = dataclasses.replace(get_config(arch), **cfg_fields)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    use_policy = False
    if opt:
        cfg, use_policy = _opt_cfg(arch, cfg, shape.kind)
    return lambda mesh: build_cell(arch, cfg, shape, mesh, policy=use_policy)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, verbose: bool = True,
             mesh_shape=None, opt: bool = False,
             device: Optional[str] = None) -> dict:
    """Trace one LM cell (see the module docstring); ``opt`` the
    ``--opt`` configuration, ``device`` where the fake tensors lie
    (default :func:`trace_device`)."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    result = run_fake(lm_cell(arch, shape_name, opt), mesh_kind,
                      device=device, mesh_shape=mesh_shape)
    result["raw_cost_uncorrected"] = dict(result["cost"])
    result["collectives_corrected"] = {
        "total_bytes": result["collectives"]["total_bytes"],
        "by_kind": result["collectives"]["by_kind"],
        "note": "one trace counts every layer: no scan correction"}
    if verbose:
        _print(tag, result)
    _write(path, result)
    return result


def detr_cell(name: str, shape_kind: str, **kw):
    """``cell(mesh)`` of a DETR cell (``kw``: ``build_detr_cell``'s
    batch / backend, ``build_banded_detr_cell``'s batch)."""
    from repro_torch.launch.detr_cells import (build_banded_detr_cell,
                                               build_detr_cell)
    if shape_kind == "banded":
        return lambda mesh: build_banded_detr_cell(name, mesh, **kw)
    return lambda mesh: build_detr_cell(name, shape_kind, mesh, **kw)


def run_detr_cell(name: str, shape_kind: str, mesh_kind: str, out_dir: str,
                  force: bool = False, mesh_shape=None) -> dict:
    """DETR-family cells (the paper's own benchmark workload).

    shape_kind "banded" = the halo-exchange band-sharded serve variant."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{name}__{shape_kind}__{mesh_kind}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    result = run_fake(detr_cell(name, shape_kind), mesh_kind,
                         mesh_shape=mesh_shape)
    _print(tag, result)
    _write(path, result)
    return result


def table(out_dir: str) -> str:
    """A markdown table of the cells under ``out_dir``, one row per cell,
    each figure as single-pod / multi-pod: peak GiB per rank, fits, the
    three roofline terms (ms), the dominant term and the useful-FLOPs
    ratio."""
    import glob
    cells: Dict[Tuple[str, str], Dict[str, dict]] = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        name, shape, mesh = os.path.basename(path)[:-5].split("__")
        with open(path) as f:
            cells.setdefault((name, shape), {})[mesh] = json.load(f)

    def pair(runs, fmt):
        return " / ".join(fmt(runs[m]) if m in runs else "—"
                          for m in ("single", "multi"))
    ms = lambda key: lambda r: f"{r['roofline'][key] * 1e3:.2f}"
    rows = ["| cell | peak GiB / rank | fits | compute ms | memory ms "
            "| collective ms | dominant | useful |",
            "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for (name, shape), runs in cells.items():
        rows.append(" | ".join([
            f"| {name} {shape}",
            pair(runs, lambda r: f"{r['memory']['peak_bytes_per_chip'] / 2 ** 30:.1f}"),
            pair(runs, lambda r: "yes" if r["fits"]["fits"] else "no"),
            pair(runs, ms("t_compute_s")), pair(runs, ms("t_memory_s")),
            pair(runs, ms("t_collective_s")),
            pair(runs, lambda r: r["roofline"]["dominant"]),
            pair(runs, lambda r: f"{r['roofline']['useful_flops_ratio']:.3f}")])
            + " |")
    return "\n".join(rows)


def _run_task(fn, args, out_dir, force):
    """One cell; returns the error's text, or None."""
    try:
        fn(*args, out_dir, force=force)
        return None
    except Exception as e:                         # a failed cell is a result
        traceback.print_exc()
        return repr(e)


def _run_tasks(tasks, out_dir, force, jobs):
    """Yield (task, error or None) for every task: in this process, or in
    ``jobs`` worker processes (spawned: each has its own fake world)."""
    if jobs <= 1:
        for task in tasks:
            yield task, _run_task(*task, out_dir, force)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                                max_tasks_per_child=1) as pool:
        futs = {pool.submit(_run_task, *task, out_dir, force): task
                for task in tasks}
        for fut in cf.as_completed(futs):
            yield futs[fut], fut.result()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--detr", action="store_true", help="include DETR family")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="§Perf optimized config (O1-O6)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the fake tensors lie (default: the card "
                         "on a CUDA build, else CPU tensors standing for it)")
    ap.add_argument("--table", action="store_true",
                    help="print the cells under --out as a table and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            fam = get_config(arch).family
            cells += [(arch, s) for s in shapes_for(fam)]
    elif args.arch:
        shapes = [args.shape] if args.shape else shapes_for(
            get_config(args.arch).family)
        cells += [(args.arch, s) for s in shapes]

    lm = functools.partial(run_cell, opt=args.opt, device=args.device)
    tasks = [(lm, (arch, shape, mk)) for arch, shape in cells
             for mk in meshes]
    if args.detr:
        tasks += [(run_detr_cell, (name, kind, mk)) for name, kinds in DETR_CELLS
                  for kind in kinds for mk in meshes]
    t0 = time.perf_counter()
    failures = []
    for task, error in _run_tasks(tasks, args.out, args.force, args.jobs):
        if error is not None:
            failures.append(task[1] + (error,))
            print(f"[dryrun] {'/'.join(task[1])}: FAIL {error}")

    print(f"\n[dryrun] done in {time.perf_counter() - t0:.1f}s. "
          f"{len(failures)} failures.")
    for f in failures:
        print("  FAIL:", f)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
