"""Rank programs for the port's distributed tests (not a test module).

Each ``*_ranks`` function is one gloo rank on the CPU, started by
:func:`spawn` in its own process (``spawn`` start method, so a rank
imports torch and the port and never JAX). Ranks meet through a
``file://`` store in the test's temporary directory (no port to collide
between pytest workers), read their inputs from a ``torch.save`` file and
write what they computed to ``<out>/rank<r>.pt``."""
from __future__ import annotations

import copy
import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 60          # a collective that waits longer fails the rank


def spawn(fn, world: int, tmp_path, inputs: dict, timeout: float = 300.0):
    """Run ``fn(rank, world, init_file, inputs_file, out_dir)`` on
    ``world`` gloo ranks; returns each rank's saved result, in rank order.
    Kills every rank and fails if they are not all done in ``timeout``."""
    inputs_file = os.path.join(tmp_path, "inputs.pt")
    out_dir = os.path.join(tmp_path, "out")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(inputs, inputs_file)
    init_file = os.path.join(tmp_path, "rendezvous")
    ctx = mp.start_processes(fn, args=(world, init_file, inputs_file, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} gloo ranks not done in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _join(rank: int, world: int, init_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _local(t, spec, mesh):
    from repro_torch.distributed import collectives as C
    ctx = C.rank_context(mesh)
    return t[C.local_slices(spec, t.shape, ctx.size, ctx.index)]


def banded_ranks(rank, world, init_file, inputs_file, out_dir):
    """The banded layer on each case's mesh: this rank's output."""
    from repro_torch.core.distributed_msdeform import msdeform_attn_banded
    from repro_torch.core.msdeform_attn import MSDeformAttnConfig
    from repro_torch.distributed.collectives import CommStats
    _join(rank, world, init_file)
    inputs = torch.load(inputs_file, weights_only=False)
    out = {}
    for name, case in inputs["cases"].items():
        mesh = _mesh(case["mesh"], ("data", "model"))
        ba = tuple(case["batch_axes"])
        spec = ((ba[0] if len(ba) == 1 else ba) if ba else None, "model", None)
        cfg = MSDeformAttnConfig(**case["cfg"])
        stats = CommStats()
        got = msdeform_attn_banded(
            case["params"], cfg, _local(case["q"], spec, mesh),
            _local(case["refs"], spec, mesh), _local(case["x"], spec, mesh),
            case["padded_shapes"], mesh, batch_axes=ba, stats=stats)
        out[name] = {"out": got, "sent": stats.sent.get(rank, {})}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def world8_ranks(rank, world, init_file, inputs_file, out_dir):
    """The 8-rank world of tests/test_torch_distributed.py: the sharded
    train step (4 x 2), the elastic reshard (4 x 2 -> 2 x 4), the layouts
    of four configs (4 x 2), EP (2 x 4), the compressed psum (pod 2 x
    data 4) and the launcher's production mesh."""
    from repro_torch.checkpoint.store import (latest_step, load_checkpoint,
                                              reshard, restore_into,
                                              save_checkpoint)
    from repro_torch.distributed import act_sharding as acts
    from repro_torch.distributed.sharding import named_sharding_tree
    from repro_torch.models import layers as L
    from repro_torch.models.common import ModelConfig
    from repro_torch.optim.adamw import OptConfig, tree_leaves
    from repro_torch.optim.compress import compressed_psum_body
    from repro_torch.distributed import collectives as C
    from repro_torch.train.step import (
        build_sharded_train_step, local_batch, place_train_state,
        train_state_shardings)
    _join(rank, world, init_file)
    inputs = torch.load(inputs_file, weights_only=False)
    res: dict = {}

    # --- the sharded train step on a 4 x 2 mesh ---------------------------
    cfg = ModelConfig(**inputs["train_cfg"])
    opt = OptConfig(**inputs["opt_cfg"])
    mesh_a = _mesh((4, 2), ("data", "model"))
    state = inputs["state"]
    specs = train_state_shardings(cfg, mesh_a, state)
    placed = place_train_state(state, specs, mesh_a)
    step = build_sharded_train_step(cfg, opt, mesh_a, specs)
    new, metrics = step(placed, local_batch(inputs["batch"], mesh_a))
    res["train"] = {
        "loss": metrics["loss"],
        "params": [p.full_tensor() for p in tree_leaves(new.params)],
        "placements": [tuple(str(pl) for pl in x.placements)
                       for x in tree_leaves(new)],
        "local": [x.to_local() for x in tree_leaves(new)],
    }

    # --- elastic reshard: save from 4 x 2, restore onto 2 x 4 --------------
    ckpt = inputs["ckpt_dir"]
    save_checkpoint(ckpt, 3, placed)
    mesh_b = _mesh((2, 4), ("data", "model"))
    specs_b = train_state_shardings(cfg, mesh_b, state)
    _, loaded = load_checkpoint(ckpt)
    restored = reshard(restore_into(state, loaded),
                       named_sharding_tree(specs_b, mesh_b))
    res["reshard"] = [x.full_tensor() for x in tree_leaves(restored)]
    moved = reshard(placed, named_sharding_tree(specs_b, mesh_b))
    res["reshard_live"] = [x.full_tensor() for x in tree_leaves(moved)]

    # --- each config's layout on 4 x 2: every leaf's local shard ----------
    res["layouts"] = {}
    for name, (cfg_kw, st) in inputs["layouts"].items():
        c = ModelConfig(**cfg_kw)
        sp = train_state_shardings(c, mesh_a, st)
        res["layouts"][name] = [x.to_local()
                                for x in tree_leaves(place_train_state(st, sp, mesh_a))]

    # --- expert parallelism on (data 2, model 4) ---------------------------
    ep = inputs["ep"]
    ecfg = ModelConfig(**ep["cfg"])
    mesh_ep = _mesh((2, 4), ("data", "model"))
    with acts.activation_policy(mesh_ep, "data"):
        out, aux = L.moe_apply(ep["params"], ecfg,
                               _local(ep["x"], ("data", None, None), mesh_ep))
    res["ep"] = {"out": out, "aux": aux}
    # backward through EP: rank (d, m)'s loss is (out . c_d) / 4 + aux / 8,
    # so the ranks' losses sum to the whole batch's (out . c) + aux
    prm = {k: v.clone().requires_grad_(True) for k, v in ep["params"].items()}
    xl = _local(ep["x"], ("data", None, None), mesh_ep).clone().requires_grad_(True)
    with acts.activation_policy(mesh_ep, "data"):
        out_g, aux_g = L.moe_apply(prm, ecfg, xl)
    c = _local(ep["c"], ("data", None, None), mesh_ep)
    ((out_g * c).sum() / 4 + aux_g / world).backward()
    res["ep_grad"] = dict({k: v.grad for k, v in prm.items()}, x=xl.grad)

    # --- the compressed psum over "pod" of a (pod 2, data 4) mesh ----------
    mesh_pd = _mesh((2, 4), ("pod", "data"))
    g = _local(inputs["g"], (("pod", "data"), None), mesh_pd)
    ctx = C.rank_context(mesh_pd)
    out1, res1, q1 = C.run_spmd(compressed_psum_body(ctx, g, "pod", 8,
                                                     torch.zeros_like(g)), mesh_pd)
    out2, res2, q2 = C.run_spmd(compressed_psum_body(ctx, g, "pod", 8, res1),
                                mesh_pd)
    res["compress"] = {"out": out1, "res": res1, "q": q1, "out2": out2,
                       "res2": res2, "q2": q2}

    # --- the launcher over the world: train, checkpoint, resume ----------
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu", "--batch",
            "8", "--seq", "16", "--ckpt-dir", inputs["launch_ckpt"],
            "--ckpt-every", "1"]
    first = launch_train.main(argv + ["--steps", "2"])
    resume_from = latest_step(inputs["launch_ckpt"])     # what run 2 restores
    res["launch_train"] = [first, resume_from,
                           launch_train.main(argv + ["--steps", "3"])]

    # --- the launcher's production mesh on a world of 8 --------------------
    try:
        launch_train.main(["--arch", "deepseek-7b", "--smoke", "--device",
                           "cpu", "--steps", "1", "--production-mesh"])
        res["launch"] = "no error"
    except Exception as e:              # the error is the result
        res["launch"] = f"{type(e).__name__}: {e}"

    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def tp_serve_ranks(rank, world, init_file, inputs_file, out_dir):
    """The serving cells of tests/test_torch_tp.py on a world of gloo
    ranks: each case's prefill and decode rank programs (``Cell.fn``) on
    this rank's slices of the global inputs; this rank's logits and cache
    shards after each."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.launch.input_specs import build_cell
    from repro_torch.models.common import ModelConfig
    from repro_torch.optim.adamw import tree_leaves
    _join(rank, world, init_file)
    inputs = torch.load(inputs_file, weights_only=False)
    out = {}
    for name, case in inputs["cases"].items():
        cfg = ModelConfig(**case["cfg"])
        mesh = _mesh(case["mesh"], ("data", "model"))
        w, b = case["w_b"]
        local = lambda tree, specs: spec_map(
            lambda t, sp: _local(t, sp, mesh).clone(), tree, specs,
            is_leaf=lambda x: isinstance(x, torch.Tensor))
        pre = build_cell("tp", cfg, ShapeSpec("p", "prefill", w, b), mesh)
        args = tuple(local(x, sp) for x, sp in
                     zip(case["prefill"], pre.in_shardings))
        logits, cache = pre.fn(*args)
        res = {"prefill": logits,
               "prefill_cache": [t.clone() for t in tree_leaves(cache)]}
        dec = build_cell("tp", cfg, ShapeSpec("d", "decode", w, b), mesh)
        tok, pos = (local(x, sp) for x, sp in
                    zip(case["decode"], dec.in_shardings[2:]))
        logits, cache = dec.fn(args[0], cache, tok, pos)
        res["decode"] = logits
        res["decode_cache"] = list(tree_leaves(cache))
        out[name] = res
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def tp_train_ranks(rank, world, init_file, inputs_file, out_dir):
    """The train cells of tests/test_torch_tp_train.py on a world of gloo
    ranks: each case's rank program (``Cell.fn``) on this rank's slices of
    the state and the batch; this rank's slices of the new state and its
    metrics."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.launch.input_specs import build_cell
    from repro_torch.models.common import ModelConfig
    from repro_torch.optim.adamw import OptConfig, tree_leaves
    _join(rank, world, init_file)
    inputs = torch.load(inputs_file, weights_only=False)
    out = {}
    for name, case in inputs["cases"].items():
        cfg = ModelConfig(**case["cfg"])
        mesh = _mesh(case["mesh"], ("data", "model"))
        s, b = case["s_b"]
        cell = build_cell("tp", cfg, ShapeSpec("t", "train", s, b), mesh,
                          OptConfig(**case["opt"]))
        args = tuple(spec_map(lambda t, sp: _local(t, sp, mesh).clone(), x, sp,
                              is_leaf=lambda v: isinstance(v, torch.Tensor))
                     for x, sp in zip(case["inputs"], cell.in_shardings))
        state, metrics = cell.fn(*args)
        out[name] = {"state": list(tree_leaves(state)), "metrics": metrics}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def seq_shard_ranks(rank, world, init_file, inputs_file, out_dir):
    """The pure-DP ``--opt`` train and prefill cells of
    tests/test_torch_seq_shard.py on a world of gloo ranks: each cell's
    rank program (``Cell.fn``, under the cell's policy) on this rank's
    slices; this rank's slices of the new state and its metrics, and its
    prefill logits and cache."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.launch.dryrun import _opt_cfg
    from repro_torch.launch.input_specs import build_cell
    from repro_torch.models.common import ModelConfig
    from repro_torch.optim.adamw import OptConfig, tree_leaves
    _join(rank, world, init_file)
    inputs = torch.load(inputs_file, weights_only=False)
    mesh = _mesh(inputs["mesh"], ("data", "model"))
    is_t = lambda v: isinstance(v, torch.Tensor)
    out = {}
    for name, case in inputs["cases"].items():
        base = ModelConfig(name=case["arch"], dtype=torch.float32, remat=True,
                           **case["cfg_kw"])
        s, b = case["s_b"]
        got = {}
        for kind in ("train", "prefill"):
            cfg, _ = _opt_cfg(case["arch"], base, kind)
            cell = build_cell(case["arch"], cfg, ShapeSpec("c", kind, s, b),
                              mesh, OptConfig(**case["opt"]), policy=True)
            args = tuple(spec_map(lambda t, sp: _local(t, sp, mesh).clone(),
                                  x, sp, is_leaf=is_t)
                         for x, sp in zip(case[kind], cell.in_shardings))
            first, second = cell.fn(*args)
            got[kind] = {"state": list(tree_leaves(first)),
                         "metrics": second} if kind == "train" else \
                {"logits": first, "cache": list(tree_leaves(second))}
        out[name] = got
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def sharded_capture_ranks(rank, world, init_file, inputs_file, out_dir):
    """The sharded train step of tests/test_torch_sharded_capture.py on a
    world of gloo ranks (``train.step.ShardedTrainStep``: eager here, as
    off the card). Per case: the step, its ``capture=False`` oracle and
    the composition it replaced (``train_rank_body`` through ``run_spmd``,
    new DTensors every step) over the case's batches; this rank's shards
    and metrics after each step, the standing shards' addresses, whether
    the same DTensors and placements came back, the caller's state
    untouched, the ``CommStats`` of each, a second batch shape's key, and
    the errors of a state laid out otherwise and of ranks whose batches
    differ in shape (at a step's first call, and with one rank on a key
    it has seen)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import P, spec_placements
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.models.common import ModelConfig
    from repro_torch.optim.adamw import OptConfig, tree_leaves, tree_unflatten
    from repro_torch.train.step import (
        TrainState, build_sharded_train_step, local_batch, place_train_state,
        spec_leaves, train_rank_body, train_state_shardings)
    _join(rank, world, init_file)
    inputs = torch.load(inputs_file, weights_only=False)
    out = {}
    for name, case in inputs["cases"].items():
        cfg = ModelConfig(**case["cfg"])
        opt = OptConfig(**case["opt"])
        mesh = _mesh(case["mesh"], ("data", "model"))
        state = case["state"]
        specs = train_state_shardings(cfg, mesh, state)
        placed = place_train_state(state, specs, mesh)
        batches = [local_batch(b, mesh) for b in case["batches"]]
        body = train_rank_body(cfg, opt, specs)
        ctx = C.rank_context(mesh)
        places = [spec_placements(sp, mesh) for sp in spec_leaves(specs)]

        def replaced(st, batch, stats):
            """The eager step as it was: functional, new DTensors."""
            loc = tree_unflatten(tuple(st), [x.to_local()
                                             for x in tree_leaves(tuple(st))])
            with torch.enable_grad():
                p, o, n, m = C.run_spmd(body(ctx, *loc, batch), mesh, stats)
            return TrainState(*tree_unflatten(tuple(st), [
                DTensor.from_local(t, mesh, pl, run_check=False)
                for t, pl in zip(tree_leaves((p, o, n)), places)])), m

        stats = {"replaced": C.CommStats(), "step": C.CommStats()}
        step = build_sharded_train_step(cfg, opt, mesh, specs,
                                        stats=stats["step"])
        oracle = build_sharded_train_step(cfg, opt, mesh, specs,
                                          capture=False)
        runs = {"replaced": placed, "step": placed, "oracle": placed}
        res = {k: [] for k in runs}
        res.update(ptrs=[], same_objects=[], placements=[])
        for i, b in enumerate(batches):
            runs["replaced"], m_r = replaced(
                runs["replaced"], b, stats["replaced"] if i == 0 else None)
            runs["step"], m_s = step(runs["step"], b)
            runs["oracle"], m_o = oracle(runs["oracle"], b)
            for k, m in (("replaced", m_r), ("step", m_s), ("oracle", m_o)):
                res[k].append(([x.to_local().clone()
                                for x in tree_leaves(tuple(runs[k]))],
                               {n: v.clone() for n, v in m.items()}))
            leaves = tree_leaves(tuple(runs["step"]))
            res["ptrs"].append([x.to_local().data_ptr() for x in leaves])
            res["same_objects"].append(all(
                a is c for a, c in zip(leaves, tree_leaves(tuple(step.state)))))
            res["placements"].append(all(
                tuple(x.placements) == pl for x, pl in zip(leaves, places)))
        res["caller_untouched"] = all(
            torch.equal(x.to_local(), _local(full, sp, mesh))
            for x, full, sp in zip(tree_leaves(tuple(placed)),
                                   tree_leaves(tuple(state)),
                                   spec_leaves(specs)))
        res["stats"] = copy.deepcopy({k: (s.sent, s.by_axis, s.backward)
                                      for k, s in stats.items()})
        # a second batch shape: a key of its own, recorded once
        half = {k: v[:, :v.shape[1] // 2 + 1] for k, v in batches[0].items()}
        step(runs["step"], half)
        step(runs["step"], half)
        res["keys"] = len(step._batches)
        res["stats_two_keys"] = (stats["step"].sent, stats["step"].backward)
        once = C.CommStats()
        replaced(place_train_state(state, specs, mesh), half, once)
        res["stats_half"] = (once.sent, once.backward)
        # a state laid out otherwise: every leaf replicated
        flat = spec_map(lambda sp: P(), specs,
                        is_leaf=lambda x: isinstance(x, P))
        try:
            step(place_train_state(state, flat, mesh), batches[0])
            res["other_layout"] = "no error"
        except ValueError as e:
            res["other_layout"] = str(e)
        # ranks whose batches differ in shape, at a step's first call
        odd = {k: v[:, :v.shape[1] - 1 - rank] for k, v in batches[0].items()}
        try:
            build_sharded_train_step(cfg, opt, mesh, specs)(placed, odd)
            res["uneven_keys"] = "no error"
        except RuntimeError as e:
            res["uneven_keys"] = str(e)
        # one rank replays a key it has seen while another meets a new one
        try:
            step(runs["step"], batches[0] if rank == 0 else odd)
            res["mixed_keys"] = "no error"
        except RuntimeError as e:
            res["mixed_keys"] = str(e)
        out[name] = res
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
