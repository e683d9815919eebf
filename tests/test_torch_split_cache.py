"""Decode on a KV cache split over its length (the reference's
``shard_len`` at ``long_500k``): K5's partial mode, the rank-order merge
(``kernels.flash_decode.merge_rank_partials``) and the decode rank body
(``launch.input_specs._serve_body`` under ``act_sharding.cache_split``),
which keeps the cache split where the reference's partitioner does.

Checks:

  * K5's plain partial mode over 2 and 4 slot shards, merged, equals
    ``flash_decode_plain`` on the whole cache within 1e-6 (float32), on
    ring masks, with one shard holding every valid slot, with one empty
    shard, and with a head map;
  * hymba's SMOKE config (a global and a window-8 layer, B 1, a 64-slot
    cache filled from a seed as if decoded through position 63, SSD
    states random) decoding 3 tokens on ``InProcessMesh`` (data, model)
    = (2, 1), (4, 1), (2, 2), from position 64 (the new slots on rank 0,
    the window's older slots on the last rank, empty ranks between) and
    from 104 (a middle rank): the logits against the port's one-device
    ``api.decode_step`` and the reference's decode cell
    (``repro.launch.input_specs.build_cell`` with ``ShapeSpec(...,
    "decode", 64, 1)``) jitted on 8 virtual CPU devices in a subprocess,
    the same parameters crossing through ``bridge.params_from_numpy``:
    atol 1e-5 x the largest |logit|;
  * the ranks' cache shards after decode: every slot but the new
    tokens' bitwise as before, on every rank; ``kpos`` and layer 0's new
    K / V rows (computed from the embedding alone) bitwise the one
    device's; the deeper layers' rows and the SSD states within 1e-5 of
    their largest |value| (their inputs carry the merge's rounding);
  * ``CommStats``: no gather of the cache; over the data axis one
    (B, Hq, Dh + 1) float32 all-gather per attention layer;
  * the fake run of the full-size ``hymba-1.5b/long_500k`` cell on the
    single- and multi-pod meshes asks under 1 MB of all-gather over the
    data axis (1,346,371,584 B while the rank gathered the cache);
  * a prefill rank body refuses a cache split over its length.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import tree_map as spec_map  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.input_specs import (build_cell, logits_spec,  # noqa: E402
                                            serving_program)
from repro_torch.models.registry import get_api  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCH = "hymba-1.5b"
W, STEPS = 64, 3
MESHES = ((2, 1), (4, 1), (2, 2))
STARTS = (64, 104)
CASES = [(m, s) for m in MESHES for s in STARTS]
IDS = [f"{d}x{t}-pos{s}" for (d, t), s in CASES]

# the reference's decode cell on 8 virtual devices: STEPS tokens from
# each start on each mesh, from the npz's params and cache
REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.configs.shapes import ShapeSpec
from repro.launch.input_specs import build_cell
from repro.models.registry import get_api

inp = dict(np.load(sys.argv[1]))
meta = json.load(open(sys.argv[2]))
devs = np.asarray(jax.devices())
assert len(devs) == 8
cfg = get_smoke_config(meta["arch"])
params = get_api(cfg).init(jax.random.PRNGKey(0), cfg)
out = {}
for (d, t), start in meta["cases"]:
    mesh = Mesh(devs[:d * t].reshape(d, t), ("data", "model"))
    cell = build_cell("h", cfg, ShapeSpec("d", "decode", meta["w"], 1), mesh)
    cache = {k[6:]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith("cache/")}
    with mesh:
        f = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings)
        for i in range(meta["steps"]):
            tok = jnp.asarray(inp["tokens"][i:i + 1])
            pos = jnp.full((1,), start + i, jnp.int32)
            logits, cache = f(params, cache, tok, pos)
            out[f"{d}x{t}/{start}/{i}"] = np.asarray(logits)
np.savez(sys.argv[3], **out)
"""

is_t = lambda x: isinstance(x, torch.Tensor)


# --------------------------------------------------------------------------
# K5's partial mode and the rank-order merge
# --------------------------------------------------------------------------

def _k5_operands(mask, seed=0, b=3, hq=6, hkv=2, dh=32, w=96):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, dh), generator=g)
    k, v = (torch.randn((b, w, hkv, dh), generator=g) for _ in range(2))
    valid = torch.rand((b, w), generator=g) < 0.6
    if mask == "first_shard_only":
        valid[:, w // 4:] = False
    elif mask == "last_shard_empty":
        valid[:, -w // 4:] = False
    return q, k, v, valid


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mask,kv_heads",
                         [("ring", None), ("first_shard_only", None),
                          ("last_shard_empty", None),
                          ("ring", (1, 1, 1, 0, 0, 1))])
def test_partial_mode_merged_equals_whole_cache(n, mask, kv_heads):
    q, k, v, valid = _k5_operands(mask)
    want = fd.flash_decode_plain(q, k, v, valid, chunk=16, kv_heads=kv_heads)
    w = k.shape[1] // n
    outs, lses = [], []
    for r in range(n):
        sl = slice(r * w, (r + 1) * w)
        out, lse = fd.flash_decode(q, k[:, sl].contiguous(),
                                   v[:, sl].contiguous(),
                                   valid[:, sl].contiguous(), chunk=16,
                                   kv_heads=kv_heads, partial=True)
        assert out.dtype == lse.dtype == torch.float32
        assert lse.shape == q.shape[:2]
        empty = ~valid[:, sl].any(1)
        assert torch.isneginf(lse[empty]).all() and (out[empty] == 0).all()
        outs.append(out)
        lses.append(lse)
    got = fd.merge_rank_partials(outs, lses, q.dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_partial_mode_of_one_shard_rounds_as_the_normal_mode():
    """One rank: its partial output, merged, is the normal mode's bitwise
    (a weight of exp(0), one rounding)."""
    q, k, v, valid = _k5_operands("ring", seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (q, k, v)] + [valid]
        out, lse = fd.flash_decode(*args, partial=True)
        assert torch.equal(fd.merge_rank_partials([out], [lse], dtype),
                           fd.flash_decode(*args))


# --------------------------------------------------------------------------
# hymba decode on a split cache
# --------------------------------------------------------------------------

def _inputs():
    """The reference's SMOKE params (key 0), crossed to the port; a cache
    filled from a seed as if decoded through position W - 1; tokens."""
    rcfg = r_smoke(ARCH)
    rparams = jax.tree.map(np.asarray, RR.get_api(rcfg).init(
        jax.random.PRNGKey(0), rcfg))
    cfg = get_smoke_config(ARCH)
    shapes = get_api(cfg).init_cache(cfg, 1, W, device="cpu")
    rng = np.random.RandomState(3)
    cache = {}
    for k, t in shapes.items():
        if k == "kpos":
            cache[k] = np.broadcast_to(np.arange(W, dtype=np.int32),
                                       t.shape).copy()
        else:
            cache[k] = rng.randn(*t.shape).astype(np.float32)
    tokens = rng.randint(0, cfg.vocab_size, (STEPS,)).astype(np.int32)
    return rparams, cache, tokens


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference subprocess; the port's one-device decode meanwhile."""
    tmp = tmp_path_factory.mktemp("split_cache")
    rparams, cache, tokens = _inputs()
    np.savez(tmp / "in.npz", tokens=tokens,
             **{f"cache/{k}": v for k, v in cache.items()})
    (tmp / "meta.json").write_text(json.dumps(
        {"arch": ARCH, "cases": CASES, "w": W, "steps": STEPS}))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp / "in.npz"),
         str(tmp / "meta.json"), str(tmp / "ref.npz")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        params = params_from_numpy(rparams, device="cpu")
        cache = {k: torch.from_numpy(v) for k, v in cache.items()}
        tokens = torch.from_numpy(tokens)
        single = {s: _single(params, cache, tokens, s) for s in STARTS}
        so, se = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{so}\n{se}"
    return dict(params=params, cache=cache, tokens=tokens, single=single,
                ref=dict(np.load(tmp / "ref.npz")))


def _clone(tree):
    return spec_map(lambda t: t.clone(), tree, is_leaf=is_t)


def _single(params, cache, tokens, start):
    """One device: STEPS decode steps; the logits and the final cache."""
    cfg = get_smoke_config(ARCH)
    api = get_api(cfg)
    cache = _clone(cache)
    logits = []
    for i in range(STEPS):
        out, cache = api.decode_step(params, cfg, cache, tokens[i:i + 1],
                                     torch.tensor([start + i], dtype=torch.int32))
        logits.append(out)
    return logits, cache


def _split(params, cache, tokens, start, mesh_shape, stats=None):
    """The decode cell's rank bodies in turn on their slices: per step
    the assembled logits; each rank's final cache shard; the cell."""
    cfg = get_smoke_config(ARCH)
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    cell = build_cell("h", cfg, ShapeSpec("d", "decode", W, 1), mesh)
    ctxs = [C.RankContext(mesh.coords(r), C.mesh_shape(mesh))
            for r in range(mesh.size)]
    mine = [[spec_map(lambda t, sp: t[C.local_slices(
        sp, t.shape, c.size, c.index)].clone(), x, s, is_leaf=is_t)
        for x, s in zip((params, cache), cell.in_shardings[:2])] for c in ctxs]
    lspec = logits_spec(cfg, mesh, 1)
    logits = []
    for i in range(STEPS):
        pos = torch.tensor([start + i], dtype=torch.int32)
        outs = C.run_in_process(lambda r, ctx: cell.body(
            ctx, mine[r][0], mine[r][1], tokens[i:i + 1], pos), mesh,
            stats if i == 0 else None)
        for o, m in zip(outs, mine):
            assert o[1] is m[1]                    # written in place
        logits.append(C.assemble(dict((r, o[0]) for r, o in enumerate(outs)),
                                 lspec, (1, cfg.vocab_size), mesh))
    return logits, [m[1] for m in mine], cell, ctxs


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=1e-5 * max(float(scale), 1e-30))


@pytest.mark.parametrize("mesh_shape,start", CASES, ids=IDS)
def test_split_cache_decode_matches_one_device_and_reference(
        world, mesh_shape, start):
    logits, _, _, _ = _split(world["params"], world["cache"], world["tokens"],
                             start, mesh_shape)
    single, _ = world["single"][start]
    for i, (got, want) in enumerate(zip(logits, single)):
        scale = want.abs().max()
        _close(got, want, scale)
        _close(got, world["ref"][f"{mesh_shape[0]}x{mesh_shape[1]}/{start}/{i}"],
               scale)


@pytest.mark.parametrize("mesh_shape,start", CASES, ids=IDS)
def test_only_the_owner_writes_its_slot(world, mesh_shape, start):
    _, shards, cell, ctxs = _split(world["params"], world["cache"],
                                   world["tokens"], start, mesh_shape)
    _, one = world["single"][start]
    new_slots = {(start + i) % W for i in range(STEPS)}
    for shard, ctx in zip(shards, ctxs):
        for key in sorted(one):
            sp = cell.in_shardings[1][key]
            sl = C.local_slices(sp, one[key].shape, ctx.size, ctx.index)
            before, after, want = world["cache"][key][sl], shard[key], one[key][sl]
            if key in ("ssm", "conv"):
                _close(after, want, want.abs().max())
                continue
            lo = sl[2].start or 0
            mine = [s - lo for s in sorted(new_slots) if 0 <= s - lo < after.shape[2]]
            rest = [s for s in range(after.shape[2]) if s not in mine]
            assert torch.equal(after[:, :, rest], before[:, :, rest])
            if key == "kpos":
                assert torch.equal(after, want)
            else:
                assert torch.equal(after[0, :, mine], want[0, :, mine])
                _close(after, want, want.abs().max())


def test_comm_bytes_of_the_merge(world):
    """(4, 1): the data axis carries one (B, Hq, Dh + 1) float32 gather per
    attention layer (the ranks' output and lse rows), and nothing gathers
    the cache."""
    cfg = get_smoke_config(ARCH)
    stats = C.CommStats()
    _split(world["params"], world["cache"], world["tokens"], 64, (4, 1), stats)
    want = cfg.n_layers * 1 * cfg.h_phys * (cfg.dh + 1) * 4
    for rank in range(4):
        assert stats.sent[rank] == {"all_gather": want}
        assert stats.by_axis[rank] == {"all_gather": {"data": want}}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_full_size_long_500k_asks_no_cache_gather(mesh):
    res = dryrun.run_fake(dryrun.lm_cell(ARCH, "long_500k"), mesh,
                          device="cpu")
    asked = res["collectives"]["requested"]["all_gather"]
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert asked["data"] == cfg.n_layers * cfg.h_phys * (cfg.dh + 1) * 4
    assert asked["data"] < 2 ** 20
    assert res["trace"]["kernels"] == {"flash_decode": cfg.n_layers}


def test_prefill_refuses_a_split_cache():
    cfg = get_smoke_config(ARCH)
    api = get_api(cfg)
    mesh = C.InProcessMesh((2, 1), ("data", "model"))
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = api.init_cache(cfg, 1, W, device="cpu")
    serving_program(cfg, mesh, "decode", params, cache, shard_len=True)
    with pytest.raises(ValueError, match="prefill"):
        serving_program(cfg, mesh, "prefill", params, cache, shard_len=True)
