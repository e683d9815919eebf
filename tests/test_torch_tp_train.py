"""Training on model-axis shards: the port's train cell as a rank body
(``launch.input_specs._train_body``, ``train.step.train_rank_body``)
against the port's one-device ``build_train_step`` and the reference's
jitted train cell.

Layouts (2 layers, d_model <= 64, float32), each on ``InProcessMesh``
(data, model) = (1, 2), (2, 2), (1, 4) and (2, 4):

  * ``split``: 8 query / 4 KV heads, MLP and vocabulary all split;
  * ``kv_block`` (8 / 2) and ``kv_raise`` (12 / 3): at tp 4 the KV heads
    replicate and each rank reads a block of them, so ``wk`` / ``wv``
    enter the rank's heads through the model axis's copy, whose backward
    sums their gradients over the axis;
  * ``heads_whole``: 5 / 1 heads whole on every rank, MLP and vocabulary
    split;
  * ``moe_ffn`` (3 experts, each on a slice of its FFN dim) and
    ``moe_ep`` (8 experts, expert parallel), the balance loss of the
    whole batch;
  * ``fsdp`` (``use_fsdp``: the embed dim split over the data axis, its
    gathers' backward a reduce-scatter) and ``accum`` (``grad_accum`` 2);
  * ``whisper``: the encoder-decoder; ``hybrid``: hymba's smoke config,
    its SSD leaves gathered over the model axis.

Checks:

  * the ranks' gradients (``train.step.grads_rank_body``), assembled,
    equal the one-device step's: atol 1e-5 x the leaf's largest |g|;
  * after one step the AdamW moments equal those of the reference's
    cell (``repro.launch.input_specs.build_cell``, jitted on 8 virtual
    CPU devices in a subprocess, the same parameters crossing through
    ``bridge.params_from_numpy``): atol 1e-5 x the leaf's largest |m| or
    |v| (the gradients' tolerance: the moments are the clipped gradient
    and its square); ``loss`` and ``grad_norm`` rtol 1e-5. The new
    parameters are held to AdamW of the old ones with those moments (atol 1e-6 x the
    leaf's largest new |p|): the first step divides each gradient by its own
    magnitude plus 1e-8, which turns roundoff of a near-zero gradient
    into a visible step, so the parameters are not compared across
    programs directly;
  * a gloo world of 4 ranks runs the cells' ``fn`` bitwise equal to the
    in-process ranks;
  * ``CommStats``: the forward's model-axis sums (the embedding's rows,
    one (B, S, D) float32 sum after each split attention and MLP, the
    loss's exp-sum and gold logit) and the backward's (one (B, S, D)
    float32 sum per copy into a split region, the head's included);
  * the fake run of a cell: FLOPs and argument bytes per rank equal the
    in-process run's; the SSD leaves are the only ones gathered over the
    model axis before the forward (after AdamW, the ZeRO slices gather
    back into the parameters' layout).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.models import registry as RR  # noqa: E402
from repro.models.common import ModelConfig as RModelConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import tree_map as spec_map  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.input_specs import build_cell  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: E402
                                     tree_leaves)
from repro_torch.train.step import (TrainState, _loss_and_grads,  # noqa: E402
                                    grads_rank_body, leaf_paths, spec_leaves)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(family="dense", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
            d_ff=128, vocab_size=256, remat=False)
_HYMBA = {f.name: getattr(get_smoke_config("hymba-1.5b"), f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "dtype"}
LAYOUTS = {
    "split": BASE,
    "kv_block": dict(BASE, n_kv_heads=2),
    "kv_raise": dict(BASE, d_model=48, n_heads=12, n_kv_heads=3),
    "heads_whole": dict(BASE, d_model=40, n_heads=5, n_kv_heads=1,
                        mlp_gated=False),
    "moe_ffn": dict(BASE, family="moe", d_ff=64, n_experts=3,
                    n_experts_active=2, expert_capacity_factor=2.0),
    "moe_ep": dict(BASE, family="moe", d_ff=32, n_experts=8,
                   n_experts_active=2, expert_capacity_factor=2.0),
    "fsdp": dict(BASE, use_fsdp=True),
    "accum": dict(BASE, grad_accum=2),
    "whisper": dict(family="encdec", n_layers=2, n_enc_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
                    enc_seq_len=16, mlp_gated=False, remat=False),
    "hybrid": dict(_HYMBA, global_layers=list(_HYMBA["global_layers"])),
}
MESHES = ((1, 2), (2, 2), (1, 4), (2, 4))
S, B = 8, 4                            # sequence (tokens S + 1), batch
OPT_KW = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.0)
GLOO = (("kv_raise", (1, 4)), ("moe_ep", (2, 2)), ("fsdp", (2, 2)),
        ("whisper", (2, 2)))
CASES = [(lay, m) for lay in LAYOUTS for m in MESHES]
REF_PROCS = 3                          # reference subprocesses, side by side

# the reference's train cells on 8 virtual devices, one step per (layout,
# mesh); reads params and batches from an npz, writes the new state's
# leaves (in the port's sorted-key order) and the metrics
REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.shapes import ShapeSpec
from repro.launch.input_specs import build_cell
from repro.models.common import ModelConfig
from repro.optim.adamw import OptConfig, adamw_init
from repro.train.step import TrainState

inp = dict(np.load(sys.argv[1]))
meta = json.load(open(sys.argv[2]))
devs = np.asarray(jax.devices())
assert len(devs) == 8
out = {}

def unflat(prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            node, parts = tree, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    return tree

def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)

fast = {"xla_backend_optimization_level": 0}
for lay, (d, t) in meta["cases"]:
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in meta["layouts"][lay].items()}
    cfg = ModelConfig(dtype=jnp.float32, **kw)
    mesh = Mesh(devs[:d * t].reshape(d, t), ("data", "model"))
    params = unflat(f"{lay}/params/")
    batch = unflat(f"{lay}/batch/")
    cell = build_cell("tp", cfg, ShapeSpec("t", "train", meta["s"], meta["b"]),
                      mesh, OptConfig(**meta["opt"]))
    state = TrainState(params, adamw_init(params), jnp.zeros((), jnp.int32))
    with mesh:
        f = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings, compiler_options=fast)
        new, metrics = f(state, batch)
    tag = f"{lay}/{d}x{t}"
    for part, tree in (("p", new.params), ("m", new.opt["m"]),
                       ("v", new.opt["v"])):
        for key, v in flat(tree, f"{tag}/{part}"):
            out[key] = v
    out[f"{tag}/loss"] = np.asarray(metrics["loss"])
    out[f"{tag}/grad_norm"] = np.asarray(metrics["grad_norm"])
np.savez(sys.argv[3], **out)
"""

is_t = lambda x: isinstance(x, torch.Tensor)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _cfg(lay):
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in LAYOUTS[lay].items()}
    return ModelConfig(dtype=torch.float32, **kw)


def _inputs(lay):
    """Params (reference init, crossed to the port) and a batch, from
    seeds."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in LAYOUTS[lay].items()}
    rcfg = RModelConfig(dtype=jnp.float32, **kw)
    rparams = jax.tree.map(np.asarray, RR.get_api(rcfg).init(
        jax.random.PRNGKey(sorted(LAYOUTS).index(lay)), rcfg))
    rng = np.random.RandomState(len(lay) + 7)
    cfg = _cfg(lay)
    batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                   (B, S + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(B, cfg.enc_seq_len,
                                    cfg.d_model).astype(np.float32)
    return rparams, batch


def _state(params):
    return TrainState(params, adamw_init(params),
                      torch.zeros((), dtype=torch.int32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference subprocesses and a gloo world of 4 ranks side by
    side; the one-device gradients meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_train")
    npz, data = {}, {}
    for lay in LAYOUTS:
        rparams, batch = _inputs(lay)
        data[lay] = (params_from_numpy(rparams, device="cpu"),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
        npz.update({f"{lay}/params/{k}": v for k, v in _flat(rparams).items()})
        npz.update({f"{lay}/batch/{k}": v for k, v in batch.items()})
    np.savez(tmp / "in.npz", **npz)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    procs = []
    for i in range(REF_PROCS):
        (tmp / f"meta{i}.json").write_text(json.dumps(
            {"layouts": LAYOUTS, "cases": CASES[i::REF_PROCS], "s": S, "b": B,
             "opt": OPT_KW}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
             str(tmp / "in.npz"), str(tmp / f"meta{i}.json"),
             str(tmp / f"ref{i}.npz")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        cases = {}
        for lay, mesh in GLOO:
            params, batch = data[lay]
            cfg = _cfg(lay)
            cases[f"{lay}/{mesh}"] = dict(
                cfg={f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)},
                mesh=mesh, s_b=(S, B), opt=OPT_KW,
                inputs=(_state(params), batch))
        gloo = ranks.spawn(ranks.tp_train_ranks, 4, str(tmp / "ranks"),
                           {"cases": cases}, timeout=240)
        single = {}
        for lay in LAYOUTS:
            cfg = _cfg(lay)
            loss, _, grads = _loss_and_grads(cfg, get_api(cfg))(*data[lay])
            single[lay] = (loss, grads)
        for proc in procs:
            so, se = proc.communicate(timeout=400)
            assert proc.returncode == 0, f"reference failed:\n{so}\n{se}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    ref = {}
    for i in range(REF_PROCS):
        ref.update(np.load(tmp / f"ref{i}.npz"))
    return dict(data=data, gloo=gloo, single=single, ref=ref)


def _local(tree, specs, ctx):
    return spec_map(lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size,
                                                   ctx.index)].clone(),
                    tree, specs, is_leaf=is_t)


def _cell(lay, mesh):
    return build_cell("tp", _cfg(lay), ShapeSpec("t", "train", S, B), mesh,
                      OptConfig(**OPT_KW))


def _run(cell, mesh, inputs, stats=None):
    """Every rank's train body in turn on its slices: (outputs, rank
    inputs)."""
    mine = {}

    def make(rank, ctx):
        mine[rank] = tuple(_local(x, sp, ctx)
                           for x, sp in zip(inputs, cell.in_shardings))
        return cell.body(ctx, *mine[rank])
    with torch.enable_grad():
        return C.run_in_process(make, mesh, stats), mine


def _grads(lay, mesh, params, batch):
    """The ranks' gradients, assembled into whole leaves."""
    cfg = _cfg(lay)
    cell = _cell(lay, mesh)
    p_specs, b_specs = cell.in_shardings[0].params, cell.in_shardings[1]
    body = grads_rank_body(cfg, p_specs)

    def make(rank, ctx):
        return body(ctx, _local(params, p_specs, ctx), _local(batch, b_specs,
                                                              ctx))
    with torch.enable_grad():
        outs = C.run_in_process(make, mesh)
    return [C.assemble({r: tree_leaves(o[2])[i] for r, o in enumerate(outs)},
                       sp, full.shape, mesh)
            for i, (full, sp) in enumerate(zip(tree_leaves(params),
                                               spec_leaves(p_specs)))]


def _assembled(outs, cell, state, mesh):
    specs = spec_leaves(cell.in_shardings[0])
    return [C.assemble({r: tree_leaves(o[0])[i] for r, o in enumerate(outs)},
                       sp, full.shape, mesh)
            for i, (full, sp) in enumerate(zip(tree_leaves(state), specs))]


def _zero_gather_bytes(cell, rank_inputs) -> int:
    """Bytes a rank gathers back into the parameters' layout after AdamW:
    its moment slice of each leaf whose ``zero_spec`` adds an axis."""
    from repro_torch.train.step import _extra_spec
    specs = cell.in_shardings[0]
    state = rank_inputs[0]
    return sum(m.numel() * m.element_size() for m, ps, ms in zip(
        tree_leaves(state.opt["m"]), spec_leaves(specs.params),
        spec_leaves(specs.opt["m"])) if any(_extra_spec(ps, ms)))


def _close(got, want, scale, rel):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=rel * max(float(scale), 1e-30))


@pytest.mark.parametrize("lay,mesh_shape", CASES,
                         ids=[f"{lay}-{d}x{t}" for lay, (d, t) in CASES])
def test_tp_train_matches_one_device_and_reference(world, lay, mesh_shape):
    params, batch = world["data"][lay]
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    _, single = world["single"][lay]
    for got, want in zip(_grads(lay, mesh, params, batch), tree_leaves(single)):
        _close(got, want, want.abs().max(), 1e-5)
    cell = _cell(lay, mesh)
    state = _state(params)
    outs, _ = _run(cell, mesh, (state, batch))
    new = _assembled(outs, cell, state, mesh)
    n = len(tree_leaves(params))
    # leaves in TrainState order: params, then m, step, v (sorted keys)
    p_new, m_new, v_new = new[:n], new[n:2 * n], new[2 * n + 1:]
    ref = world["ref"]
    tag = f"{lay}/{mesh_shape[0]}x{mesh_shape[1]}"
    paths = leaf_paths(params)
    for part, got_leaves in (("m", m_new), ("v", v_new)):
        for path, got in zip(paths, got_leaves):
            want = ref[f"{tag}/{part}/{path}"]
            _close(got, want, np.abs(want).max(), 1e-5)
    metrics = outs[0][1]
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(ref[f"{tag}/{name}"]), rtol=1e-5)
    # AdamW's first step with the moments the ranks hold
    opt = OptConfig(**OPT_KW)
    lr = float(metrics["lr"])
    b1c, b2c = 1 - opt.beta1, 1 - opt.beta2
    for p, m, v, got in zip(tree_leaves(params), m_new, v_new, p_new):
        want = p.double() - lr * ((m.double() / b1c) / (
            (v.double() / b2c).sqrt() + opt.eps) + opt.weight_decay * p)
        _close(got, want, want.abs().max(), 1e-6)
    assert all(int(o[0].step) == 1 for o in outs)


@pytest.mark.parametrize("lay,mesh_shape", GLOO,
                         ids=[f"{lay}-{d}x{t}" for lay, (d, t) in GLOO])
def test_gloo_world_equals_in_process_bitwise(world, lay, mesh_shape):
    params, batch = world["data"][lay]
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    outs, _ = _run(_cell(lay, mesh), mesh, (_state(params), batch))
    for rank, got in enumerate(world["gloo"]):
        g = got[f"{lay}/{mesh_shape}"]
        for a, b in zip(g["state"], tree_leaves(outs[rank][0])):
            assert torch.equal(a, b), rank
        for k, v in outs[rank][1].items():
            assert torch.equal(g["metrics"][k], v), (rank, k)


@pytest.mark.parametrize("lay", ["split", "kv_block", "heads_whole"])
def test_comm_bytes_equal_the_formula(world, lay):
    """(1, 4): forward, the embedding's (B, S, D) sum, a (B, S, D) sum
    after each split attention and MLP and the loss's two (B, S) sums
    (its max takes none: no gradient); backward, a (B, S, D) sum per copy
    into a split region (the attention's and the MLP's input, the
    head's), the sum of each norm scale computed inside such a region
    and, where 4 ranks read 2 replicated KV heads, the sums of ``wk`` and
    ``wv``; then the squared norm's scalar, and the gathers of
    the updated ZeRO slices back into the parameters' layout."""
    cfg = _cfg(lay)
    params, batch = world["data"][lay]
    mesh = C.InProcessMesh((1, 4), ("data", "model"))
    stats = C.CommStats()
    cell = _cell(lay, mesh)
    _, mine = _run(cell, mesh, (_state(params), batch), stats)
    row = B * S * cfg.d_model * 4
    heads = cfg.n_heads % 4 == 0
    kv_rep = heads and cfg.n_kv_heads % 4 != 0
    fwd = row + cfg.n_layers * (1 + heads) * row + 2 * B * S * 4
    wkv = 2 * cfg.d_model * cfg.n_kv_heads * cfg.dh * 4 if kv_rep else 0
    norms = (1 + heads) * cfg.d_model * 4
    bwd = cfg.n_layers * ((1 + heads) * row + wkv + norms) + row
    for rank in range(4):
        assert stats.backward[rank] == {"sum": bwd}
        assert stats.sent[rank] == {"sum": fwd + bwd + 4, "max": B * S * 4,
                                    "all_gather": _zero_gather_bytes(
                                        cell, mine[rank])}
        assert set(stats.by_axis[rank]["sum"]) == {"model"}


SMALL = {"split": ("split", None), "hymba": (None, "hymba-1.5b")}


@pytest.mark.parametrize("which", sorted(SMALL))
def test_fake_run_against_in_process(which):
    lay, arch = SMALL[which]
    cfg = _cfg(lay) if lay else get_smoke_config(arch)
    make = lambda m: build_cell("tp", cfg, ShapeSpec("t", "train", S, B), m)
    mesh_shape = ((1, 4), ("data", "model"))
    fake = dryrun.run_fake(make, None, device="cpu", mesh_shape=mesh_shape)
    mesh = C.InProcessMesh(*mesh_shape)
    cell = make(mesh)
    api = get_api(cfg)
    gen = torch.Generator().manual_seed(0)
    state = _state(api.init(cfg, gen, device="cpu"))
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        _, mine = _run(cell, mesh, (state, {"tokens": toks}))
    assert fake["cost"]["flops"] * 4 == fc.get_total_flops()
    assert fake["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for x in mine[0] for t in tree_leaves(x))
    whole = fake["trace"]["computed_whole"]["gathered"]
    asked = fake["collectives"]["requested"]
    zero = _zero_gather_bytes(cell, mine[0])
    if which == "split":
        assert whole == {} and asked["all_gather"] == {"model": zero}
        assert math.isclose(fake["cost"]["flops"] * 4, dryrun.run_fake(
            make, None, device="cpu", mesh_shape=((1, 1), ("data", "model"))
        )["cost"]["flops"], rel_tol=0.05)
    else:
        assert whole and all("/ssd/" in f"/{p}" for p in whole)
        ssd = [t for p, t in zip(leaf_paths(mine[0][0].params),
                                 tree_leaves(mine[0][0].params))
               if p in whole]
        assert asked["all_gather"] == {"model": zero + sum(
            t.numel() * t.element_size() for t in ssd)}


def test_whole_model_loss_fn_keeps_non_row_batch_leaves():
    """A model with no loss body (the detector's API) computes ``loss_fn``
    on leaves gathered whole; a batch leaf that is not rows (here a bias
    of the model width, as the DETR cell's positional table) reaches it
    whole, and the data groups' mean gradient equals one device's."""
    from repro_torch.distributed.sharding import P
    from repro_torch.models.registry import ModelAPI
    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn((8, 4), generator=gen)}
    batch = {"x": torch.randn((4, 8), generator=gen),
             "bias": torch.randn((4,), generator=gen)}

    def loss_fn(p, _cfg, b):
        return torch.square(b["x"] @ p["w"] + b["bias"]).mean(), {}
    api = ModelAPI(*(None,) * len(ModelAPI._fields))._replace(loss_fn=loss_fn)
    mesh = C.InProcessMesh((2, 2), ("data", "model"))
    body = grads_rank_body(ModelConfig(), {"w": P(None, "model")}, api)
    specs = {"x": P("data", None), "bias": P(None)}
    with torch.enable_grad():
        outs = C.run_in_process(lambda r, ctx: body(
            ctx, _local(params, {"w": P(None, "model")}, ctx),
            _local(batch, specs, ctx)), mesh)
    got = C.assemble({r: o[2]["w"] for r, o in enumerate(outs)},
                     P(None, "model"), (8, 4), mesh)
    w = params["w"].clone().requires_grad_()
    loss_fn({"w": w}, None, batch)[0].backward()
    torch.testing.assert_close(got, w.grad, rtol=1e-6, atol=1e-7)
