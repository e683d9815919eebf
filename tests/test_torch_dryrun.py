"""The port's dry run (``repro_torch.launch.dryrun`` / ``hlo_stats``) on
the CPU: fake runs on a fake process group, held against real runs.

  * a fake run allocates nothing: minitron-4b ``decode_32k`` on a 2 × 2
    mesh hands each rank tens of GB of arguments and the process's peak
    resident memory does not move by 2 GiB; its K5 calls are counted;
  * a small prefill cell (minitron-4b SMOKE, 2 × 2 mesh): the fake run's
    FLOPs equal a quarter of a real CPU run of the four ranks'
    bodies in process (the ranks' work is equal), its argument bytes
    equal the bytes of rank 0's shards, the bytes its rank body asks of
    each collective, by mesh axis, equal ``CommStats`` of the in-process
    run, and the
    in-process ranks' logits (each rank's columns of the vocabulary) and
    kept cache shards equal a one-device prefill (1e-5);
  * a small long-context decode cell (hymba-1.5b SMOKE, batch 1, cache
    length sharded over data): collectives against ``CommStats`` and
    outputs against a one-device decode step, the same way;
  * the banded DETR cell at 2 bands on a small pyramid: the halo
    exchange's bytes (collective-permute) equal ``CommStats`` of the
    banded stack run in process; the DETR serve cell at ``auto`` calls
    K1 once per block;
  * ``roofline_terms`` and ``structural_bytes`` equal the reference's
    with its constants replaced by the port's;
  * every kernel operator's fake output has its plain version's shape
    and dtype, and its FLOP formula counts what ``FlopCounterMode``
    reports.
"""
import dataclasses
import resource

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.launch.hlo_stats as RH  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import tree_map as spec_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.library import card_stand_in  # noqa: E402
from repro_torch.launch import detr_cells, dryrun, hlo_stats  # noqa: E402
from repro_torch.launch.input_specs import build_cell, logits_spec  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

MESH22 = ((2, 2), ("data", "model"))


def _maxrss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def test_fake_run_allocates_nothing():
    before = _maxrss_bytes()
    res = dryrun.run_fake(
        lambda m: build_cell("minitron-4b", get_config("minitron-4b"),
                             SHAPES["decode_32k"], m), None, device="cpu",
        mesh_shape=MESH22)
    grown = _maxrss_bytes() - before
    assert res["memory"]["argument_bytes"] > 30e9
    assert grown < 2 * 2 ** 30, grown
    assert res["trace"]["kernels"] == {"flash_decode": 32}
    assert res["trace"]["planned_for"] == "cuda:NVIDIA H100 80GB HBM3"
    assert res["trace"]["world"] == 4
    assert res["cost"]["flops"] > 0 and res["fits"]["fits"] in (True, False)


# --------------------------------------------------------------------------
# small serving cells: fake run against the in-process ranks
# --------------------------------------------------------------------------

def _global_inputs(cell, cfg, gen):
    """Real global inputs of a serving cell: seeded params, a zero cache
    (empty ring slots), token ids, positions."""
    api = get_api(cfg)
    params = api.init(cfg, gen, device="cpu")
    b = cell.in_specs[2]["tokens"].shape[0] if cell.meta["kind"] == "prefill" \
        else cell.in_specs[2].shape[0]
    cache = api.init_cache(cfg, b, cell.meta["seq_len"], device="cpu")
    if cell.meta["kind"] == "prefill":
        toks = torch.randint(0, cfg.vocab_size, tuple(cell.in_specs[2][
            "tokens"].shape), generator=gen, dtype=torch.int32)
        return params, cache, {"tokens": toks}
    toks = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                         dtype=torch.int32)
    return params, cache, toks, torch.full((b,), 5, dtype=torch.int32)


def _local(tree, specs, ctx):
    return spec_map(lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size,
                                                   ctx.index)].clone(),
                    tree, specs, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _in_process(cell, inputs, mesh):
    """Every rank's body in turn: (outputs, rank inputs, CommStats, FLOPs)."""
    stats, mine = C.CommStats(), {}

    def make(rank, ctx):
        mine[rank] = tuple(_local(x, sp, ctx)
                           for x, sp in zip(inputs, cell.in_shardings))
        return cell.body(ctx, *mine[rank])
    with FlopCounterMode(display=False) as fc:
        outs = C.run_in_process(make, mesh, stats)
    return outs, mine, stats, fc.get_total_flops()


def _shard_sum(cell, mesh):
    ctx = C.RankContext(mesh.coords(0), C.mesh_shape(mesh))
    total = 0
    for sds, sp in zip(cell.in_specs, cell.in_shardings):
        for x in tree_leaves(_local(sds, sp, ctx)):
            total += x.numel() * x.element_size()
    return total


SERVE_CASES = {
    "prefill": ("minitron-4b", ShapeSpec("prefill_small", "prefill", 16, 4)),
    "long": ("hymba-1.5b", ShapeSpec("long_small", "decode", 64, 1)),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serving_cell_fake_run_against_in_process_ranks(case):
    arch, shape = SERVE_CASES[case]
    cfg = get_smoke_config(arch)
    res = dryrun.run_fake(lambda m: build_cell(arch, cfg, shape, m), None,
                             device="cpu", mesh_shape=MESH22)
    mesh = C.InProcessMesh(*MESH22)
    cell = build_cell(arch, cfg, shape, mesh)
    inputs = _global_inputs(cell, cfg, torch.Generator().manual_seed(3))
    full = tuple(spec_map(lambda t: t.clone(), x, is_leaf=lambda y: isinstance(
        y, torch.Tensor)) for x in inputs)
    outs, mine, stats, flops = _in_process(cell, inputs, mesh)

    assert res["memory"]["argument_bytes"] == _shard_sum(cell, mesh)
    assert res["collectives"]["requested"] == stats.by_axis[0]
    assert stats.rank_bytes(0) > 0
    # a float sum on the wire: an all-to-all of chunks, then an all-gather
    assert set(res["collectives"]["by_kind"]) == {"all-gather", "all-to-all"}
    if case == "prefill":                  # no kernel: FLOPs comparable
        assert res["cost"]["flops"] * mesh.size == flops
    else:
        assert res["trace"]["kernels"] == {"flash_decode": cfg.n_layers}

    # the ranks' outputs against one device's
    api = get_api(cfg)
    if case == "prefill":
        want, want_cache = api.prefill(full[0], cfg, full[1], full[2])
    else:
        want, want_cache = api.decode_step(full[0], cfg, full[1], full[2],
                                           full[3])
    lspec = logits_spec(cfg, mesh, want.shape[0])
    for rank, (logits, cache) in enumerate(outs):
        ctx = C.RankContext(mesh.coords(rank), C.mesh_shape(mesh))
        part = C.local_slices(lspec, want.shape, ctx.size, ctx.index)
        torch.testing.assert_close(logits, want[part], rtol=1e-5, atol=1e-5)
        got_cache = _local(want_cache, cell.in_shardings[1], ctx)
        for g, w in zip(tree_leaves(cache), tree_leaves(got_cache)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert cache is mine[rank][1]           # kept in place


# --------------------------------------------------------------------------
# DETR cells at a small pyramid
# --------------------------------------------------------------------------

SMALL_LEVELS = ((40, 16), (20, 8), (10, 4), (5, 2))


@pytest.fixture
def small_detr(monkeypatch):
    name = "deformable-detr-defa"
    acfg = detr_cells.DETR_CONFIGS[name]
    acfg = dataclasses.replace(
        acfg, level_shapes=SMALL_LEVELS, serve_batch=2, train_batch=2,
        encoder=dataclasses.replace(acfg.encoder, n_blocks=2))
    monkeypatch.setitem(detr_cells.DETR_CONFIGS, name, acfg)
    return name, acfg


def test_banded_cell_exchange_bytes_equal_comm_stats(small_detr):
    name, acfg = small_detr
    mesh_shape = ((1, 2), ("data", "model"))
    res = dryrun.run_fake(dryrun.detr_cell(name, "banded"), None,
                             device="cpu", mesh_shape=mesh_shape)
    mesh = C.InProcessMesh(*mesh_shape)
    stack = detr_cells.build_banded_detr_stack(name, mesh, batch=2)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core.encoder import init_encoder
    params = init_encoder(acfg.encoder, gen, device="cpu")
    d = acfg.encoder.d_model
    x = torch.randn(2, stack.n_pad, d, generator=gen).to(acfg.encoder.dtype)
    pos = torch.randn(stack.n_pad, d, generator=gen).to(acfg.encoder.dtype)
    refs = detr_cells.band_major_refs(stack.padded_shapes, 2, 2)
    stats = C.CommStats()
    with torch.no_grad():
        stack.fn(params, x, pos, refs, stats)
    exchanged = res["collectives"]["by_kind"]["collective-permute"]
    assert exchanged["handed_bytes"] == stats.sent[0]["exchange"] > 0
    assert exchanged["bytes"] == stats.sent[0]["exchange"]
    assert res["trace"]["kernels"] == {}


def test_detr_serve_cell_calls_k1_per_block(small_detr):
    name, _ = small_detr
    res = dryrun.run_fake(dryrun.detr_cell(name, "serve"), None,
                             device="cpu", mesh_shape=MESH22)
    assert res["trace"]["kernels"] == {}        # the config's torch_gather
    res = dryrun.run_fake(dryrun.detr_cell(name, "serve",
                                                 backend="auto"), None,
                             device="cpu", mesh_shape=MESH22)
    assert res["trace"]["kernels"] == {"msgs_fused": 2}
    assert res["meta"]["global_batch"] == 2
    res = dryrun.run_fake(dryrun.detr_cell(name, "train"), None,
                             device="cpu", mesh_shape=MESH22)
    assert res["trace"]["kernels"] == {}
    # the train step's sums are rank-order sums (all-to-all + all-gather);
    # the one all-reduce is the INT12 scales' max over the data axis (the
    # value table's, the probabilities' and the offsets' per block, exact
    # in any order), one scalar each
    coll = res["collectives"]
    assert set(coll["by_kind"]) == {"all-gather", "all-to-all", "all-reduce"}
    n_blocks = small_detr[1].encoder.n_blocks
    assert set(coll["requested"]["max"]) == {"data"}
    assert coll["by_kind"]["all-reduce"]["count"] == 3 * n_blocks


# --------------------------------------------------------------------------
# roofline formulas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_terms_equal_the_reference(kind, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(RH, name, getattr(hlo_stats, name))
    meta = {"kind": kind, "seq_len": 4096, "global_batch": 256,
            "n_chips": 256, "params": 7e9, "active_params": 6e9}
    cost = {"flops": 3.1e15, "bytes accessed": 0.0}
    coll = {"total_bytes": 5.5e10, "by_kind": {}}
    mem = {"argument_bytes": 4e10, "output_bytes": 3e9, "temp_bytes": 2e10}
    assert hlo_stats.structural_bytes(mem) == RH.structural_bytes(mem)
    assert hlo_stats.roofline_terms(cost, coll, meta, mem) == \
        RH.roofline_terms(cost, coll, meta, mem)
    # bytes that cross pods go over the slower links
    split = hlo_stats.roofline_terms(cost, dict(coll, pod_bytes=1e10), meta,
                                     mem)
    assert split["t_collective_s"] == pytest.approx(
        4.5e10 / hlo_stats.ICI_BW + 1e10 / hlo_stats.DCN_BW)


# --------------------------------------------------------------------------
# the kernel operators' fake implementations and FLOP formulas
# --------------------------------------------------------------------------

LEVELS = ((8, 10), (4, 5))
N_PIX = sum(h * w for h, w in LEVELS)


def _points(gen, shape):
    lvl = torch.randint(0, len(LEVELS), shape, generator=gen)
    wl = torch.tensor([w for _, w in LEVELS], dtype=torch.int32)[lvl]
    hl = torch.tensor([h for h, _ in LEVELS], dtype=torch.int32)[lvl]
    st = torch.tensor([0, 80], dtype=torch.int32)[lvl]
    x = torch.rand(shape, generator=gen) * (wl + 1).float() - 0.5
    y = torch.rand(shape, generator=gen) * (hl + 1).float() - 0.5
    p = torch.softmax(torch.randn(shape, generator=gen), -1)
    return x, y, st, wl, hl, p, lvl.to(torch.int32)


def _kernel_calls():
    """(name, call(fake: bool) on the given tensors, FLOP count) per
    operator; the calls take their operands from ``args``."""
    gen = torch.Generator().manual_seed(0)
    b, nq, h, k, dh = 2, 12, 4, 4, 8
    v = torch.randn(b, N_PIX, h, dh, generator=gen)
    x, y, st, wl, hl, p, lvl = _points(gen, (b, nq, h, k))
    xw, yw, _, _, _, pw, lw = _points(gen, (b, N_PIX, h, k))
    q = torch.randn(2, 6, 16, generator=gen)
    kv = torch.randn(2, 32, 2, 16, generator=gen)
    valid = torch.rand(2, 32, generator=gen) > 0.3
    a = torch.randn(16, 24, generator=gen)
    w = torch.randn(24, 40, generator=gen)
    point_flops = lambda pts: pts.numel() * dh * 13
    return [
        ("msgs_fused", (v, x, y, st, wl, hl, p),
         lambda *t: ops.msgs_fused(*t), point_flops(x)),
        ("msgs_windowed", (v, xw, yw, lw, pw),
         lambda *t: ops.msgs_windowed_msp(*t, level_shapes=LEVELS,
                                          ranges=(2.0, 1.0), tile_q=16),
         point_flops(xw)),
        ("msgs_decode", (v, x, y, st, wl, hl, p),
         lambda v_, *t: ops.msgs_decode(ops.stage_decode_table(v_), *t),
         point_flops(x)),
        ("flash_decode", (q, kv, kv.clone(), valid),
         lambda *t: ops.flash_decode(*t), 4 * 16 * 6 * 2 * 32),
        ("matmul", (a, w), lambda *t: ops.matmul(*t), 2 * 16 * 24 * 40),
    ]


@pytest.mark.parametrize("i", range(5))
def test_kernel_operator_fake_matches_plain(i):
    name, args, call, flops = _kernel_calls()[i]
    want = call(*args)
    with FakeTensorMode() as fm, card_stand_in():
        fargs = [fm.from_tensor(t) for t in args]
        with FlopCounterMode(display=False) as fc:
            got = call(*fargs)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts[f"repro_torch.{name}"] == flops


def test_k2_backward_operator_fake_matches_plain():
    gen = torch.Generator().manual_seed(1)
    b, nq, h, k, dh = 2, 12, 4, 4, 8
    v = torch.randn(b, N_PIX, h, dh, generator=gen)
    pts = _points(gen, (b, nq, h, k))[:6]

    def grads(v, x, y, st, wl, hl, p):
        leaves = [t.requires_grad_() for t in (v, x, y, p)]
        out = ops.msgs_decode(ops.stage_decode_table(leaves[0]), leaves[1],
                              leaves[2], st, wl, hl, leaves[3])
        return torch.autograd.grad(out.square().sum(), leaves)
    want = grads(v.clone(), *[t.clone() for t in pts])
    with FakeTensorMode() as fm, card_stand_in():
        fargs = [fm.from_tensor(t) for t in (v, *pts)]
        with FlopCounterMode(display=False) as fc:
            got = grads(*fargs)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts["repro_torch.msgs_decode_backward"] == \
        dh * 4 * pts[0].numel() * 4


# --------------------------------------------------------------------------
# a fake run against a real run of the same rank program
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_fake_run_against_a_real_cpu_run(kind):
    """A mesh of one rank: the fake trace and a real run on a gloo world
    of one count the same FLOPs, op by op, and the same argument bytes
    (cells that reach no kernel: on the CPU a real run takes the plain
    versions, the fake one the kernels' formulas)."""
    shape = ShapeSpec(f"{kind}_small", kind, 16, 2)
    make_cell = dryrun.lm_cell("minitron-4b", shape, n_layers=2, d_model=48,
                                n_heads=6, n_kv_heads=2, d_ff=96,
                                vocab_size=512, dtype=torch.float32)
    one = ((1, 1), ("data", "model"))
    fake = dryrun.run_fake(make_cell, None, device="cpu", mesh_shape=one)
    real = dryrun.run_real(make_cell, "cpu", reps=1, mesh_shape=one)
    assert fake["memory"]["argument_bytes"] == real["argument_bytes"]
    assert fake["collectives"]["total_bytes"] == 0     # axes of one rank
    assert fake["trace"]["kernels"] == {}
    assert fake["trace"]["flops_by_op"] == real["flops_by_op"]
    assert fake["cost"]["flops"] == real["flops"] > 0
