"""The multi-rank train steps as the reference jits them: the in-process
ranks' step (``train.step.InProcessTrainStep``) and the process-group
step (``train.step.ShardedTrainStep``, ``build_sharded_train_step``),
each over a standing state written in place, one graph per batch shape
on the card and eager here.

Checks (2 layers, d_model 64, float32):

  * (a) the in-process step over 3 steps on (1, 2) and (2, 2) meshes,
    its body written in place (``build_cell(..., in_place=True)``),
    bitwise the eager functional cell (``run_in_process`` of
    ``Cell.body``, new tensors every step); against the reference's
    jitted one-device step the loss and grad norm of every step within
    rtol 1e-5 and the moments after the first within atol 1e-5 of the
    leaf's largest |m| or |v| (``tests/test_torch_tp_train.py``'s
    tolerance against the reference's cells); the DETR train cell in
    place bitwise its functional cell;
  * (b) the standing tensors keep their addresses from step to step, the
    caller's first state is left untouched, and a state of another
    structure, shape or layout raises;
  * (c) one key per batch shape: the same shape reuses its key, another
    adds one;
  * (d) ``ShardedTrainStep`` on 2 gloo ranks (``torch_dist_ranks``),
    (data, model) (1, 2) and (2, 1) with FSDP, bitwise the composition it
    replaced and its ``capture=False`` oracle; the same DTensors and
    placements come back; ranks whose batches differ in shape raise;
  * (e) ``CommStats`` records the first call of each key only: after 3
    steps it holds one eager step's bytes, and a second key adds its
    own once;
  * the bodies a step would capture read nothing back to the host and,
    after their first run, make no tensor from host data (the TP,
    expert-parallel, DETR and ``--opt`` sequence-split train cells: both
    refused inside ``CapturedGraphs._call``, the reads as
    ``tests/test_torch_train_capture.py`` refuses them).
"""
import contextlib
import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import registry as RR  # noqa: E402
from repro.models.common import ModelConfig as RModelConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.core.encoder import init_encoder  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import tree_map as spec_map  # noqa: E402
from repro_torch.launch import detr_cells  # noqa: E402
from repro_torch.launch.input_specs import build_cell  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: E402
                                     tree_leaves)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.dryrun import _opt_cfg  # noqa: E402
from repro_torch.train.step import (InProcessTrainStep,  # noqa: E402
                                    TrainState, make_train_state, spec_leaves)
from repro_torch.utils.graphs import CapturedGraphs  # noqa: E402
from repro_torch.utils.tree import tree_map_with_path_str  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

BASE = dict(family="dense", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
            d_ff=128, vocab_size=256, remat=False)
LAYOUTS = {"split": BASE, "fsdp": dict(BASE, use_fsdp=True),
           # at tp 4 the 2 KV heads replicate, each rank reads one
           "kv_block": dict(BASE, n_kv_heads=2),
           "moe_ep": dict(BASE, family="moe", d_ff=32, n_experts=8,
                          n_experts_active=2, expert_capacity_factor=2.0)}
MESHES = ((1, 2), (2, 2))
S, B, STEPS = 8, 4, 3
OPT_KW = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.0)
# (2, 2) on four ranks: a shard of a leaf split on both axes views its
# standing DTensor's local tensor with other strides on a dim of size 1
GLOO = (("split", (1, 2)), ("fsdp", (2, 1)), ("split", (2, 2)))
is_t = lambda x: isinstance(x, torch.Tensor)


def _cfg(lay):
    return ModelConfig(dtype=torch.float32, **LAYOUTS[lay])


def _inputs(lay):
    """Params (the reference's init, crossed to the port), the reference's
    own params, and STEPS batches, from seeds."""
    rcfg = RModelConfig(dtype=jnp.float32, **LAYOUTS[lay])
    rparams = RR.get_api(rcfg).init(
        jax.random.PRNGKey(sorted(LAYOUTS).index(lay)), rcfg)
    rng = np.random.RandomState(len(lay) + 3)
    batches = [{"tokens": rng.randint(0, 256, (B, S + 1)).astype(np.int32)}
               for _ in range(STEPS)]
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    return params, rparams, batches


def _state(params):
    return TrainState(params, adamw_init(params),
                      torch.zeros((), dtype=torch.int32))


def _local(tree, specs, ctx):
    return spec_map(lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size,
                                                   ctx.index)].clone(),
                    tree, specs, is_leaf=is_t)


def _clone(tree):
    return tree_map_with_path_str(lambda _, t: t.clone(), tree)


def _ctxs(mesh):
    return [C.RankContext(mesh.coords(r), C.mesh_shape(mesh))
            for r in range(mesh.size)]


def _cells(lay, mesh):
    shape = ShapeSpec("t", "train", S, B)
    return (build_cell("tp", _cfg(lay), shape, mesh, OptConfig(**OPT_KW)),
            build_cell("tp", _cfg(lay), shape, mesh, OptConfig(**OPT_KW),
                       in_place=True))


def _runs(lay, mesh_shape, stats=None):
    """STEPS steps of the eager functional cell and of the in-process step
    over the in-place cell from one state: per step each one's rank
    outputs, and the step, its first rank states and batches."""
    params, _, batches = _inputs(lay)
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    cell, cell_ip = _cells(lay, mesh)
    sspec, bspec = cell.in_shardings
    ctxs = _ctxs(mesh)
    first = [_local(_state(params), sspec, c) for c in ctxs]
    rows = [[_local({k: torch.from_numpy(v) for k, v in b.items()}, bspec, c)
             for c in ctxs] for b in batches]
    step = InProcessTrainStep(cell_ip.body, mesh, stats=stats)
    eager, state, got = [], first, []
    for i in range(STEPS):
        with torch.enable_grad():
            outs = C.run_in_process(lambda r, ctx: cell.body(
                ctx, state[r], rows[i][r]), mesh)
        state = [o[0] for o in outs]
        eager.append(outs)
        out = step([(first[r] if i == 0 else step.ranks[r][0], rows[i][r])
                    for r in range(mesh.size)])
        # the standing state changes under a caller at the next step
        got.append([(_clone(o[0]), o[1], [t.data_ptr() for t in
                                           tree_leaves(o[0])]) for o in out])
    return eager, got, step, first, rows


@pytest.mark.parametrize("lay", sorted(LAYOUTS))
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_in_process_step_is_bitwise_the_eager_cell(lay, mesh_shape):
    eager, got, _, _, _ = _runs(lay, mesh_shape)
    for i, (outs, mine) in enumerate(zip(eager, got)):
        for r, (o, m) in enumerate(zip(outs, mine)):
            a, b = tree_leaves(o[0]), tree_leaves(m[0])
            assert len(a) == len(b) > 0
            assert all(x.dtype == y.dtype and torch.equal(x, y)
                       for x, y in zip(a, b)), (i, r)
            assert sorted(o[1]) == sorted(m[1])
            assert all(torch.equal(o[1][k], m[1][k]) for k in o[1]), (i, r)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_in_process_step_matches_the_reference(mesh_shape):
    lay = "split"
    _, rparams, batches = _inputs(lay)
    rcfg = RModelConfig(dtype=jnp.float32, **LAYOUTS[lay])
    r_state = rstep.TrainState(rparams, radamw.adamw_init(rparams),
                               jnp.zeros((), jnp.int32))
    r_step = jax.jit(rstep.build_train_step(rcfg, radamw.OptConfig(**OPT_KW)))
    _, got, step, _, _ = _runs(lay, mesh_shape)
    mesh = step.mesh
    cell, _ = _cells(lay, mesh)
    specs = spec_leaves(cell.in_shardings[0])
    for i, b in enumerate(batches):
        r_state, r_m = r_step(r_state, {"tokens": jnp.asarray(b["tokens"])})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[i][0][1][k]), float(r_m[k]),
                                       rtol=1e-5, err_msg=f"{k} step {i}")
        if i:
            continue
        n = len(tree_leaves(r_state.params))
        want = jax.tree.leaves(r_state.opt["m"]) + \
            jax.tree.leaves(r_state.opt["v"])
        for j, w in enumerate(want):
            at = n + j + (j >= n)              # the port's order: m, step, v
            whole = C.assemble({r: tree_leaves(g[0])[at] for r, g
                                in enumerate(got[0])}, specs[at],
                               tuple(w.shape), mesh)
            w = np.asarray(w)
            np.testing.assert_allclose(whole.numpy(), w, rtol=0, atol=1e-5 * max(
                float(np.abs(w).max()), 1e-30), err_msg=f"moment {j}")


def test_detr_train_cell_in_place_is_bitwise_its_functional_cell(monkeypatch):
    name = "deformable-detr-defa"
    acfg = detr_cells.DETR_CONFIGS[name]
    enc = acfg.encoder
    enc = dataclasses.replace(enc, n_blocks=2, dtype=torch.float32,
                              attn=dataclasses.replace(enc.attn,
                                                       dtype=torch.float32))
    levels = ((8, 12), (4, 6), (2, 3), (1, 2))
    monkeypatch.setitem(detr_cells.DETR_CONFIGS, name, dataclasses.replace(
        acfg, level_shapes=levels, train_batch=2, encoder=enc))
    mesh = C.InProcessMesh((2, 2), ("data", "model"))
    cell = detr_cells.build_detr_cell(name, "train", mesh, enc_cfg=enc)
    cell_ip = detr_cells.build_detr_cell(name, "train", mesh, enc_cfg=enc,
                                         in_place=True)
    params = init_encoder(enc, torch.Generator().manual_seed(0), device="cpu")
    n = sum(h * w for h, w in levels)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, n, enc.d_model), generator=gen)
    pos = 0.1 * torch.randn((n, enc.d_model), generator=gen)
    refs = 0.02 + 0.96 * torch.rand((n, 2), generator=gen)
    ranks_in = [tuple(_local(t, sp, c) for t, sp in zip(
        (params, adamw_init(params), x, pos, refs), cell.in_shardings))
        for c in _ctxs(mesh)]
    step = InProcessTrainStep(cell_ip.body, mesh, n_state=2)
    state = [r[:2] for r in ranks_in]
    for i in range(2):
        with torch.enable_grad():
            outs = C.run_in_process(lambda r, ctx: cell.body(
                ctx, *state[r], *ranks_in[r][2:]), mesh)
        state = [o[:2] for o in outs]
        got = step([(state_r if i == 0 else step.ranks[r]) + ranks_in[r][2:]
                    for r, state_r in enumerate([q[:2] for q in ranks_in])])
        for o, g in zip(outs, got):
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(o),
                                                          tree_leaves(g)))


def test_standing_tensors_stay_and_the_callers_state_is_untouched():
    lay, mesh_shape = "split", (1, 2)
    params, _, _ = _inputs(lay)
    _, got, step, first, _ = _runs(lay, mesh_shape)
    ptrs = [g[2] for g in got[0]]
    for mine in got[1:]:
        assert [g[2] for g in mine] == ptrs
    assert [[t.data_ptr() for t in tree_leaves(s)] for s in step.ranks] == ptrs
    # the caller's first state: its slices of the initial state still
    cell, _ = _cells(lay, step.mesh)
    again = [_local(_state(params), cell.in_shardings[0], c)
             for c in _ctxs(step.mesh)]
    for a, b in zip(tree_leaves(first), tree_leaves(again)):
        assert torch.equal(a, b)
    # a state not the standing one is copied in, into the same tensors
    step.adopt([(s,) for s in again])
    assert [[t.data_ptr() for t in tree_leaves(s)] for s in step.ranks] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(step.ranks),
                                                 tree_leaves(again)))


def test_a_state_of_another_structure_or_shape_raises():
    lay, mesh_shape = "split", (1, 2)
    _, _, step, first, rows = _runs(lay, mesh_shape)
    wider = [(TrainState(dict(s.params, extra=torch.zeros(2)), s.opt, s.step),)
             for s in first]
    with pytest.raises(ValueError, match="keeps its structure"):
        step.adopt(wider)
    grown = [(TrainState(s.params, s.opt, torch.zeros(2, dtype=torch.int32)),)
             for s in first]
    with pytest.raises(ValueError, match="keeps its structure"):
        step.adopt(grown)
    with pytest.raises(ValueError, match="states for"):
        step.adopt([(first[0],)])
    # a body that returns new tensors (the functional cell) is refused
    functional, _ = _cells(lay, step.mesh)
    with pytest.raises(ValueError, match="writes its state in place"):
        InProcessTrainStep(functional.body, step.mesh)(
            [(s, r) for s, r in zip(first, rows[0])])


def test_one_key_per_batch_shape():
    lay, mesh_shape = "split", (2, 2)
    prepared = []
    _, _, step, _, rows = _runs(lay, mesh_shape)
    assert len(step._batches) == 1              # STEPS calls, one shape
    step.graphs._on_prepare = prepared.append
    half = [{"tokens": r["tokens"][:, :S // 2 + 1]} for r in rows[0]]
    for _ in range(2):
        step([(s[0], h) for s, h in zip(step.ranks, half)])
    assert len(step._batches) == 2 and prepared == ["in_process_train_step"]
    step([(s[0], r) for s, r in zip(step.ranks, rows[0])])
    assert len(step._batches) == 2 and len(prepared) == 1


def test_comm_stats_record_the_first_call_of_each_key():
    lay, mesh_shape = "split", (2, 2)
    stats = C.CommStats()
    eager, _, step, first, rows = _runs(lay, mesh_shape, stats)
    mesh = step.mesh
    cell, _ = _cells(lay, mesh)
    once = C.CommStats()
    with torch.enable_grad():
        C.run_in_process(lambda r, ctx: cell.body(ctx, first[r], rows[0][r]),
                         mesh, once)
    assert stats.sent == once.sent and stats.backward == once.backward
    assert stats.by_axis == once.by_axis and stats.rank_bytes(0) > 0
    half = [{"tokens": r["tokens"][:, :S // 2 + 1]} for r in rows[0]]
    more = C.CommStats()
    with torch.enable_grad():
        C.run_in_process(lambda r, ctx: cell.body(ctx, first[r], half[r]),
                         mesh, more)
    for _ in range(2):
        step([(s[0], h) for s, h in zip(step.ranks, half)])
    for r in range(mesh.size):
        for op in set(once.sent[r]) | set(more.sent[r]):
            assert stats.sent[r][op] == once.sent[r].get(op, 0) + \
                more.sent[r].get(op, 0)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Every GLOO case's results per rank, each case on a world of as many
    gloo ranks as its mesh has."""
    out = {}
    for world in sorted({d * t for _, (d, t) in GLOO}):
        cases = {}
        for lay, mesh in GLOO:
            if mesh[0] * mesh[1] != world:
                continue
            params, _, batches = _inputs(lay)
            cfg = _cfg(lay)
            cases[f"{lay}/{mesh}"] = dict(
                cfg={f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)},
                mesh=mesh, opt=OPT_KW, state=_state(params),
                batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                         for b in batches])
        got = ranks.spawn(ranks.sharded_capture_ranks, world,
                          str(tmp_path_factory.mktemp(f"sharded_capture{world}")),
                          {"cases": cases}, timeout=240)
        out.update({name: [rank[name] for rank in got] for name in cases})
    return out


@pytest.mark.parametrize("case", [f"{lay}/{mesh}" for lay, mesh in GLOO])
def test_sharded_step_on_gloo_is_bitwise_the_replaced_eager_step(gloo, case):
    for res in gloo[case]:
        for i in range(STEPS):
            want_leaves, want_m = res["replaced"][i]
            for k in ("step", "oracle"):
                leaves, m = res[k][i]
                assert len(leaves) == len(want_leaves) > 0
                assert all(torch.equal(a, b)
                           for a, b in zip(leaves, want_leaves)), (k, i)
                assert sorted(m) == sorted(want_m)
                assert all(torch.equal(m[n], want_m[n]) for n in m), (k, i)
        assert all(res["same_objects"]) and all(res["placements"])
        assert all(p == res["ptrs"][0] for p in res["ptrs"])
        assert res["caller_untouched"]


@pytest.mark.parametrize("case", [f"{lay}/{mesh}" for lay, mesh in GLOO])
def test_sharded_step_keys_stats_and_refusals_on_gloo(gloo, case):
    for res in gloo[case]:
        assert res["keys"] == 2
        sent, by_axis, backward = res["stats"]["step"]
        assert (sent, by_axis, backward) == res["stats"]["replaced"]
        assert sum(sent.values() if not isinstance(next(iter(
            sent.values())), dict) else next(iter(sent.values())).values()) > 0
        two, _ = res["stats_two_keys"]
        half, _ = res["stats_half"]
        for r in two:
            for op in set(sent[r]) | set(half[r]):
                assert two[r][op] == sent[r].get(op, 0) + half[r].get(op, 0)
        assert "laid out on its mesh by its specs" in res["other_layout"]
        assert "batches of other shapes" in res["uneven_keys"]
        assert "batches of other shapes" in res["mixed_keys"]


HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "cpu",
              "numpy")


@contextlib.contextmanager
def _host_reads_raise(copies: bool):
    """Host reads refused; with ``copies`` also tensors made from host
    data (on the card a copy from pageable memory, which a capture
    refuses: a graph body builds them once, at its warm-up, as
    ``bridge.host_constant`` does)."""
    def refuse(name):
        def raise_(*_a, **_k):
            raise AssertionError(f"host read Tensor.{name} in a graph body")
        return raise_
    made = (torch.from_numpy, torch.tensor, torch.as_tensor)

    def from_host(fn):
        def make(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"a tensor made from host data "
                                     f"({fn.__name__}) in a graph body")
            return fn(data, *a, **k)
        return make
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}
    try:
        for n in HOST_READS:
            setattr(torch.Tensor, n, refuse(n))
        if copies:
            for fn in made:
                setattr(torch, fn.__name__, from_host(fn))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        for fn in made:
            setattr(torch, fn.__name__, fn)


def _opt_case(arch, mesh_shape, s, b):
    """A pure-DP arch's ``--opt`` train cell (its SMOKE config in float32)
    on its sequence split: the in-place cell, its rank states and rows."""
    cfg, on = _opt_cfg(arch, dataclasses.replace(
        get_smoke_config(arch), dtype=torch.float32), "train")
    assert on and cfg.pure_dp
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    cell = build_cell(arch, cfg, ShapeSpec("t", "train", s, b), mesh,
                      OptConfig(**OPT_KW), policy=True, in_place=True)
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                     generator=gen, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.enc_seq_len, cfg.d_model),
                                      generator=gen)
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    sspec, bspec = cell.in_shardings
    return cell, mesh, [(_local(state, sspec, c), _local(batch, bspec, c))
                        for c in _ctxs(mesh)]


def _lm_case(lay, mesh_shape):
    params, _, batches = _inputs(lay)
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    _, cell = _cells(lay, mesh)
    sspec, bspec = cell.in_shardings
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    return cell, mesh, [(_local(_state(params), sspec, c),
                         _local(batch, bspec, c)) for c in _ctxs(mesh)]


def _detr_case(monkeypatch):
    name = "deformable-detr-defa"
    acfg = detr_cells.DETR_CONFIGS[name]
    enc = dataclasses.replace(acfg.encoder, n_blocks=1)
    levels = ((8, 12), (4, 6), (2, 3), (1, 2))
    monkeypatch.setitem(detr_cells.DETR_CONFIGS, name, dataclasses.replace(
        acfg, level_shapes=levels, train_batch=2, encoder=enc))
    mesh = C.InProcessMesh((2, 2), ("data", "model"))
    cell = detr_cells.build_detr_cell(name, "train", mesh, in_place=True)
    params = init_encoder(enc, torch.Generator().manual_seed(0), device="cpu")
    n = sum(h * w for h, w in levels)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, n, enc.d_model), generator=gen).to(enc.dtype)
    pos = (0.1 * torch.randn((n, enc.d_model), generator=gen)).to(enc.dtype)
    refs = 0.02 + 0.96 * torch.rand((n, 2), generator=gen)
    return cell, mesh, [tuple(_local(t, sp, c) for t, sp in zip(
        (params, adamw_init(params), x, pos, refs), cell.in_shardings))
        for c in _ctxs(mesh)]


BODIES = {"tp_split": lambda mp: _lm_case("split", (1, 2)),
          "tp_kv_block": lambda mp: _lm_case("kv_block", (1, 4)),
          "tp_moe_ep": lambda mp: _lm_case("moe_ep", (2, 2)),
          "opt_minitron": lambda mp: _opt_case("minitron-4b", (2, 2), 16, 8),
          "opt_mamba2": lambda mp: _opt_case("mamba2-130m", (1, 4), 16, 4),
          "detr_defa": _detr_case,
          "opt_hymba": lambda mp: _opt_case("hymba-1.5b", (1, 2), 16, 8),
          "opt_whisper": lambda mp: _opt_case("whisper-tiny", (2, 2), 16, 4)}


@pytest.mark.parametrize("case", sorted(BODIES))
def test_multi_rank_train_bodies_read_nothing_back(monkeypatch, case):
    """Three steps of each train cell's in-process step with the host
    reads refused inside the body, and from its second run on (on the
    card the capture, after the warm-up) tensors made from host data
    (the DETR cell's DEFA config with its INT12 scales over the batch)."""
    cell, mesh, rank_args = BODIES[case](monkeypatch)
    real_call = CapturedGraphs._call
    runs = []

    def call(self, body):
        runs.append(1)
        with _host_reads_raise(copies=len(runs) > 1):
            return real_call(self, body)
    monkeypatch.setattr(CapturedGraphs, "_call", call)
    n_state = 2 if case.startswith("detr") else 1
    step = InProcessTrainStep(cell.body, mesh, n_state=n_state)
    for i in range(3):
        out = step([tuple(step.ranks[r]) + a[n_state:] if i else a
                    for r, a in enumerate(rank_args)])
    loss = out[0][n_state]
    loss = loss["loss"] if isinstance(loss, dict) else loss
    assert np.isfinite(loss.detach().numpy())
