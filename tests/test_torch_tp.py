"""Serving on model-axis shards: the port's tensor-parallel rank bodies
(``launch.input_specs._serve_body`` under ``act_sharding.tensor_parallel``)
against the port's one-device path and the reference's jitted cells.

Layouts (2 layers, d_model <= 64, float32), each on ``InProcessMesh``
(data, model) = (1, 2), (2, 2), (1, 4) and (2, 4):

  * ``split``: 8 query / 4 KV heads, MLP and vocabulary all split;
  * ``kv_block``: 8 / 2 heads: at tp 4 the KV heads replicate and each
    rank hands K5 the one KV head its two query heads read;
  * ``kv_raise``: 12 / 3 heads: KV heads replicate and a rank's query
    heads straddle two KV groups; K5 takes the rank's own head map and
    reads its KV heads in place (this layout raised before K5 took a
    head map);
  * ``padded``: 6 query heads padded to 8 over 3 KV heads: the padded
    heads clamp to the last KV head and are masked (at tp 2 one rank
    holds two real and two padded heads, at tp 4 the heads are whole);
  * ``heads_whole``: 5 / 1 heads (whole on every rank), MLP and
    vocabulary split (minitron-4b's layout on 16);
  * ``moe_ffn``: 3 experts (no tp divides them): every expert on each
    rank's slice of its FFN dim; ``moe_ep``: 8 experts, expert parallel;
  * ``whisper``: the encoder-decoder (encoder, self- and
    cross-attention, MLPs).

Each cell runs prefill over B = 4 prompts of W = 8 tokens, then one
decode step at position W. Checks:

  * the ranks' logits (each rank's columns of the vocabulary) and cache
    shards against the port's one-device ``api.prefill`` /
    ``api.decode_step`` and against the reference's cell
    (``repro.launch.input_specs.build_cell``) jitted on 8 virtual CPU
    devices in a subprocess, the same parameters crossing through
    ``bridge.params_from_numpy``: atol 1e-5 x the largest |logit| (cache
    1e-5 x its largest |value|);
  * a gloo world of 4 ranks runs the cells' ``fn`` bitwise equal to the
    in-process ranks;
  * ``CommStats``: a rank hands one (B, S, D) float32 sum per layer after
    the attention (where heads split) and one after the MLP, and one
    (B, S, D) sum of the embedding's rows;
  * the fake run of a cell: FLOPs and argument bytes per rank equal the
    in-process run's; with everything split, FLOPs per rank are 1/tp of
    tp = 1's; no all-gather is asked over the model axis, except of the
    SSD mixer's leaves, whose bytes it equals.
"""
import dataclasses
import json
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
from repro_torch.launch.input_specs import build_cell, logits_spec  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(family="dense", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
            d_ff=128, vocab_size=256, remat=False)
LAYOUTS = {
    "split": BASE,
    "kv_block": dict(BASE, n_kv_heads=2),
    "kv_raise": dict(BASE, d_model=48, n_heads=12, n_kv_heads=3),
    "padded": dict(BASE, d_model=48, n_heads=6, n_kv_heads=3,
                   pad_heads_to=8),
    "heads_whole": dict(BASE, d_model=40, n_heads=5, n_kv_heads=1,
                        mlp_gated=False),
    "moe_ffn": dict(BASE, family="moe", d_ff=64, n_experts=3,
                    n_experts_active=2, expert_capacity_factor=2.0),
    "moe_ep": dict(BASE, family="moe", d_ff=32, n_experts=8,
                   n_experts_active=2, expert_capacity_factor=2.0),
    "whisper": dict(family="encdec", n_layers=2, n_enc_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
                    enc_seq_len=16, mlp_gated=False, remat=False),
}
MESHES = ((1, 2), (2, 2), (1, 4), (2, 4))
W, B = 8, 4                           # prompt / cache length, batch
GLOO = (("kv_block", (1, 4)), ("moe_ep", (2, 2)), ("whisper", (2, 2)))
CASES = [(lay, m) for lay in LAYOUTS for m in MESHES]

# the reference's cells on 8 virtual devices: prefill then one decode
# step per (layout, mesh); reads params and inputs from an npz
REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.shapes import ShapeSpec
from repro.launch.input_specs import build_cell
from repro.models.common import ModelConfig
from repro.models.registry import get_api

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

for lay, (d, t) in meta["cases"]:
    cfg = ModelConfig(dtype=jnp.float32, **meta["layouts"][lay])
    api = get_api(cfg)
    mesh = Mesh(devs[:d * t].reshape(d, t), ("data", "model"))
    params = unflat(f"{lay}/params/")
    batch = unflat(f"{lay}/batch/")
    pre = build_cell("tp", cfg, ShapeSpec("p", "prefill", meta["w"], meta["b"]),
                     mesh)
    dec = build_cell("tp", cfg, ShapeSpec("d", "decode", meta["w"], meta["b"]),
                     mesh)
    with mesh:
        fp = jax.jit(pre.fn, in_shardings=pre.in_shardings,
                     out_shardings=pre.out_shardings)
        fd = jax.jit(dec.fn, in_shardings=dec.in_shardings,
                     out_shardings=dec.out_shardings)
        cache = api.init_cache(cfg, meta["b"], meta["w"])
        logits, cache = fp(params, cache, batch)
        tag = f"{lay}/{d}x{t}"
        out[f"{tag}/prefill"] = np.asarray(logits)
        for k, v in cache.items():
            out[f"{tag}/prefill_cache/{k}"] = np.asarray(v)
        logits, cache = fd(params, cache, jnp.asarray(inp[f"{lay}/tok"]),
                           jnp.asarray(inp[f"{lay}/pos"]))
        out[f"{tag}/decode"] = np.asarray(logits)
        for k, v in cache.items():
            out[f"{tag}/decode_cache/{k}"] = np.asarray(v)
np.savez(sys.argv[3], **out)
"""

is_t = lambda x: isinstance(x, torch.Tensor)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _cfg(lay):
    return ModelConfig(dtype=torch.float32, **LAYOUTS[lay])


def _layout_inputs(lay):
    """Params (reference init, crossed to the port), prefill batch, decode
    tokens and positions, all from seeds."""
    rcfg = RModelConfig(dtype=jnp.float32, **LAYOUTS[lay])
    rparams = jax.tree.map(np.asarray, RR.get_api(rcfg).init(
        jax.random.PRNGKey(sorted(LAYOUTS).index(lay)), rcfg))
    rng = np.random.RandomState(len(lay))
    cfg = _cfg(lay)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, W)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(B, cfg.enc_seq_len,
                                    cfg.d_model).astype(np.float32)
    tok = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
    pos = np.full((B,), W, np.int32)
    return rparams, batch, tok, pos


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference subprocess and a gloo world of 4 ranks side by side;
    the port's in-process and one-device runs meanwhile."""
    tmp = tmp_path_factory.mktemp("tp")
    npz, data = {}, {}
    for lay in LAYOUTS:
        rparams, batch, tok, pos = _layout_inputs(lay)
        data[lay] = (params_from_numpy(rparams, device="cpu"),
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.from_numpy(tok), torch.from_numpy(pos))
        npz.update({f"{lay}/params/{k}": v for k, v in _flat(rparams).items()})
        npz.update({f"{lay}/batch/{k}": v for k, v in batch.items()})
        npz[f"{lay}/tok"], npz[f"{lay}/pos"] = tok, pos
    np.savez(tmp / "in.npz", **npz)
    (tmp / "meta.json").write_text(json.dumps(
        {"layouts": LAYOUTS, "cases": CASES, "w": W, "b": B}))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp / "in.npz"),
         str(tmp / "meta.json"), str(tmp / "ref.npz")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        cases = {}
        for lay, mesh in GLOO:
            params, batch, tok, pos = data[lay]
            cfg = _cfg(lay)
            cache = get_api(cfg).init_cache(cfg, B, W, device="cpu")
            cases[f"{lay}/{mesh}"] = dict(
                cfg={f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)},
                mesh=mesh, w_b=(W, B), prefill=(params, cache, batch),
                decode=(tok, pos))
        gloo = ranks.spawn(ranks.tp_serve_ranks, 4, str(tmp / "ranks"),
                           {"cases": cases}, timeout=240)
        single = {lay: _single(lay, *data[lay]) for lay in LAYOUTS}
        so, se = ref_proc.communicate(timeout=400)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    assert ref_proc.returncode == 0, f"reference failed:\n{so}\n{se}"
    return dict(data=data, gloo=gloo, single=single,
                ref=dict(np.load(tmp / "ref.npz")))


def _clone(tree):
    return spec_map(lambda t: t.clone(), tree, is_leaf=is_t)


def _single(lay, params, batch, tok, pos):
    """The port's one-device prefill and decode step."""
    cfg = _cfg(lay)
    api = get_api(cfg)
    cache = api.init_cache(cfg, B, W, device="cpu")
    pre, cache = api.prefill(params, cfg, cache, batch)
    pre_cache = _clone(cache)
    dec, cache = api.decode_step(params, cfg, cache, tok, pos)
    return pre, pre_cache, dec, cache


def _local(tree, specs, ctx):
    return spec_map(lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size,
                                                   ctx.index)].clone(),
                    tree, specs, is_leaf=is_t)


def _ranks(cell, mesh, inputs, stats=None):
    """Every rank's body in turn on its slices of ``inputs``: (outputs,
    rank inputs)."""
    mine = {}

    def make(rank, ctx):
        mine[rank] = tuple(_local(x, sp, ctx)
                           for x, sp in zip(inputs, cell.in_shardings))
        return cell.body(ctx, *mine[rank])
    return C.run_in_process(make, mesh, stats), mine


def _in_process(lay, mesh_shape, params, batch, tok, pos):
    """Prefill then decode on the in-process ranks: per phase the
    assembled logits, the assembled cache and the rank outputs."""
    cfg = _cfg(lay)
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    pre = build_cell("tp", cfg, ShapeSpec("p", "prefill", W, B), mesh)
    dec = build_cell("tp", cfg, ShapeSpec("d", "decode", W, B), mesh)
    cache = get_api(cfg).init_cache(cfg, B, W, device="cpu")
    lspec = logits_spec(cfg, mesh, B)
    outs, _ = _ranks(pre, mesh, (params, cache, batch))
    logits_shape = (B, cfg.vocab_size)

    def gather(outs, cell):
        logits = C.assemble({r: o[0] for r, o in enumerate(outs)}, lspec,
                            logits_shape, mesh)
        caches = [C.assemble({r: tree_leaves(o[1])[i]
                              for r, o in enumerate(outs)}, sp,
                             full.shape, mesh)
                  for i, (full, sp) in enumerate(zip(
                      tree_leaves(cache), _spec_leaves(cell.in_shardings[1])))]
        return logits, caches
    res = {"prefill": gather(outs, pre), "prefill_outs": outs}
    new_cache = spec_map(lambda t: t, cache, is_leaf=is_t)
    for leaf, full in zip(tree_leaves(new_cache), res["prefill"][1]):
        leaf.copy_(full)
    outs, _ = _ranks(dec, mesh, (params, new_cache, tok, pos))
    res["decode"] = gather(outs, dec)
    res["decode_outs"] = outs
    return res, (pre, dec, mesh, new_cache)


def _spec_leaves(specs):
    from repro_torch.train.step import spec_leaves
    return spec_leaves(specs)


def _close(got, want, scale=None):
    scale = float(want.abs().max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=1e-5 * max(scale, 1e-30))


@pytest.mark.parametrize("lay,mesh_shape", CASES,
                         ids=[f"{lay}-{d}x{t}" for lay, (d, t) in CASES])
def test_tp_cell_matches_one_device_and_reference(world, lay, mesh_shape):
    params, batch, tok, pos = world["data"][lay]
    res, _ = _in_process(lay, mesh_shape, params, batch,
                                             tok, pos)
    single = world["single"][lay]
    ref = world["ref"]
    tag = f"{lay}/{mesh_shape[0]}x{mesh_shape[1]}"
    cache_keys = sorted(k for k in get_api(_cfg(lay)).init_cache(
        _cfg(lay), 1, 1, device="cpu"))
    for i, phase in enumerate(("prefill", "decode")):
        logits, caches = res[phase]
        want = single[2 * i]
        _close(logits, want)
        _close(logits, ref[f"{tag}/{phase}"], float(want.abs().max()))
        for key, got, one in zip(cache_keys, caches,
                                 tree_leaves(single[2 * i + 1])):
            _close(got, one)
            _close(got, ref[f"{tag}/{phase}_cache/{key}"],
                   float(one.abs().max()))


@pytest.mark.parametrize("lay,mesh_shape", GLOO,
                         ids=[f"{lay}-{d}x{t}" for lay, (d, t) in GLOO])
def test_gloo_world_equals_in_process_bitwise(world, lay, mesh_shape):
    params, batch, tok, pos = world["data"][lay]
    res, _ = _in_process(lay, mesh_shape, params, batch, tok, pos)
    for rank, got in enumerate(world["gloo"]):
        g = got[f"{lay}/{mesh_shape}"]
        for phase in ("prefill", "decode"):
            logits, cache = res[f"{phase}_outs"][rank]
            assert torch.equal(g[phase], logits), (rank, phase)
            for a, b in zip(g[f"{phase}_cache"], tree_leaves(cache)):
                assert torch.equal(a, b), (rank, phase)


@pytest.mark.parametrize("lay", ["split", "heads_whole", "moe_ep"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_comm_bytes_per_layer_equal_the_formula(world, lay, kind):
    """(1, 4): the embedding's (B, S, D) sum in the model dtype, then per
    layer one (B, S, D) float32 sum after the attention where its heads
    split and one after the MLP / MoE; nothing else."""
    cfg = _cfg(lay)
    params, batch, tok, pos = world["data"][lay]
    mesh = C.InProcessMesh((1, 4), ("data", "model"))
    cell = build_cell("tp", cfg, ShapeSpec("c", kind, W, B), mesh)
    cache = get_api(cfg).init_cache(cfg, B, W, device="cpu")
    inputs = (params, cache, batch) if kind == "prefill" else \
        (params, cache, tok, pos)
    stats = C.CommStats()
    _ranks(cell, mesh, inputs, stats)
    s = W if kind == "prefill" else 1
    row = B * s * cfg.d_model
    sums_per_layer = 1 + (cfg.n_heads % 4 == 0)
    want = row * 4 + cfg.n_layers * sums_per_layer * row * 4
    for rank in range(4):
        assert stats.sent[rank] == {"sum": want}
        assert stats.by_axis[rank] == {"sum": {"model": want}}


SMALL = {"split": ("split", None), "hymba": (None, "hymba-1.5b")}


def _k5_uncounted(monkeypatch):
    """K5's plain version run outside the FLOP counter, its operator's
    formula (``kernels.library``) added instead, as the fake run counts
    it: returns the list of added FLOPs."""
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.kernels import ops
    real, added = ops.flash_decode, []

    def k5(q, k, v, valid, **kw):
        with _disable_current_modes():
            out = real(q, k, v, valid, **kw)
        added.append(4 * q.shape[2] * q.shape[1] * q.shape[0] * k.shape[1])
        return out
    monkeypatch.setattr(ops, "flash_decode", k5)
    return added


@pytest.mark.parametrize("which", sorted(SMALL))
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_fake_run_against_in_process_and_tp1(which, kind, monkeypatch):
    lay, arch = SMALL[which]
    cfg = _cfg(lay) if lay else get_smoke_config(arch)
    shape = ShapeSpec("c", kind, W, B)
    make = lambda m: build_cell("tp", cfg, shape, m)
    mesh_shape = ((1, 4), ("data", "model"))
    fake = dryrun.run_fake(make, None, device="cpu", mesh_shape=mesh_shape)
    one = dryrun.run_fake(make, None, device="cpu",
                          mesh_shape=((1, 1), ("data", "model")))
    mesh = C.InProcessMesh(*mesh_shape)
    cell = make(mesh)
    api = get_api(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init(cfg, gen, device="cpu")
    cache = api.init_cache(cfg, B, W, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, W), generator=gen,
                         dtype=torch.int32)
    inputs = (params, cache, {"tokens": toks}) if kind == "prefill" else \
        (params, cache, toks[:, 0], torch.full((B,), 3, dtype=torch.int32))
    added = _k5_uncounted(monkeypatch)
    with FlopCounterMode(display=False) as fc:
        _, mine = _ranks(cell, mesh, inputs)
    assert fake["cost"]["flops"] * 4 == fc.get_total_flops() + sum(added)
    assert len(added) == (4 * cfg.n_layers if kind == "decode" else 0)
    assert fake["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for x in mine[0] for t in tree_leaves(x))
    asked = fake["collectives"]["requested"]
    if which == "split":                 # every matmul split four ways
        assert fake["cost"]["flops"] * 4 == one["cost"]["flops"]
        assert "all_gather" not in asked
        assert fake["trace"]["computed_whole"] == {"gathered": {},
                                                   "replicated": []}
    else:                                # only the SSD mixer's leaves
        whole = fake["trace"]["computed_whole"]["gathered"]
        assert whole and all("/ssd/" in f"/{p}" for p in whole)
        ssd = {k: v for k, v in tree_leaves_with_paths(mine[0][0])
               if k in whole}
        assert asked["all_gather"] == {"model": sum(
            t.numel() * t.element_size() for t in ssd.values())}


def tree_leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_with_paths(
            tree[k], f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]
