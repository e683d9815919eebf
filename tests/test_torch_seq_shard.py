"""The pure-DP ``--opt`` cells on a sequence split: the port's train and
prefill cells (``launch.input_specs.build_cell(..., policy=True)`` with
``launch.dryrun._opt_cfg``: ``pure_dp``, ``save_comm`` remat, the
reference's grad accumulation) for the four archs the reference's
``OPT_PURE_DP`` names, each rank computing its block of its data group's
token rows (``act_sharding.seq_split``), against the port's one-device
step and prefill and the reference's jitted ``--opt`` cells.

Small configs under the archs' names (2 layers, float32, remat on,
sequence 64, batch 8), with head counts that do not divide the model
axis of 4, as the real ones do not divide 16 (``minitron-4b`` and
``hymba-1.5b`` also at ``attn_chunk`` 8, so that their attention runs
blockwise, each rank's query chunks offset into the gathered keys):

  * ``minitron-4b``: dense, 6 query / 2 KV heads (at (2, 2) the prefill
    cache's KV heads split over the model axis, so each rank writes its
    block of the gathered K / V);
  * ``mamba2-130m``: the SSD mixer, 6 SSD heads, chunk 8 (a rank holds
    two chunks at (1, 4));
  * ``hymba-1.5b``: 5 / 5 heads, window 16 with one global layer, and
    the SSD half (5 heads);
  * ``whisper-tiny``: the encoder-decoder with 18 frames: they split over
    the model axis of 2 and stay whole on every rank at 4, as the
    reference's ``_constrain`` drops a split that does not divide.

Checks, on ``InProcessMesh`` (data, model) = (1, 4) and (2, 2), float32:

  * train, one run of the cell's body under its own policy: the loss
    (rtol 1e-5) and the gradients the step used (its first moments over
    (1 - beta1) x the clip scale of its ``grad_norm``, assembled; atol
    1e-5 x the leaf's largest |g|) against one device's
    ``_loss_and_grads``; the AdamW moments against
    the reference's cell (``repro.launch.input_specs.build_cell`` with
    its own ``_opt_cfg`` under ``REPRO_CONSTRAIN_ACTS=1``, jitted on 8
    virtual CPU devices in a subprocess; 1e-5 x the leaf's largest |m|
    or |v|), ``loss`` and ``grad_norm`` rtol 1e-5, and the new parameters
    against AdamW of the old ones with those moments (1e-6);
  * prefill: the last position's logits and every cache leaf against
    one device's ``prefill`` and the reference's cell: atol 1e-5 x the
    largest |value|;
  * ``CommStats`` of a prefill at (1, 4): past the parameters' gathers,
    a dense layer asks for the K / V gather alone and an SSD layer for
    its tail rows and its (state, log-decay) alone, each equal to its
    formula, plus the last position's row;
  * the fake run: four ranks' FLOPs of the split cells equal one rank's
    whole-sequence run plus what the split adds (the last position's head
    on every rank, the SSD's incoming-state term), each by its formula;
  * a gloo world of 4 (``tests/torch_dist_ranks.py``) runs the cells'
    ``fn`` bitwise equal to the in-process ranks.
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

from repro.models import registry as RR  # noqa: E402
from repro.models.common import ModelConfig as RModelConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import tree_map as spec_map  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import input_specs as IS  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: E402
                                     tree_leaves)
from repro_torch.train.step import (TrainState, _loss_and_grads,  # noqa: E402
                                    leaf_paths, spec_leaves)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = {
    "minitron-4b": dict(family="dense", n_layers=2, d_model=48, n_heads=6,
                        n_kv_heads=2, d_ff=96, vocab_size=512,
                        mlp_gated=False),
    "mamba2-130m": dict(family="ssm", n_layers=2, d_model=48, n_heads=4,
                        n_kv_heads=4, d_ff=0, vocab_size=512, ssm_state=16,
                        ssm_expand=2, ssm_conv=4, ssm_head_dim=16,
                        ssm_chunk=8),
    "hymba-1.5b": dict(family="hybrid", n_layers=2, d_model=40, n_heads=5,
                       n_kv_heads=5, d_ff=96, vocab_size=512, ssm_state=8,
                       ssm_expand=2, ssm_conv=4, ssm_head_dim=16, ssm_chunk=8,
                       attn_window=16, global_layers=[0]),
    "whisper-tiny": dict(family="encdec", n_layers=2, n_enc_layers=2,
                         d_model=48, n_heads=6, n_kv_heads=6, d_ff=96,
                         vocab_size=512, enc_seq_len=18, mlp_gated=False),
}
CHUNK = 8            # S 64 > 2 x 8: attention blockwise
# case name -> (arch, config keywords)
VARIANTS = dict({a: (a, kw) for a, kw in ARCHS.items()}, **{
    f"{a}-chunk{CHUNK}": (a, dict(ARCHS[a], attn_chunk=CHUNK))
    for a in ("minitron-4b", "hymba-1.5b")})
MESHES = ((1, 4), (2, 2))
S, B = 64, 8
OPT_KW = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.0)
CASES = [(v, m) for v in VARIANTS for m in MESHES]
IDS = [f"{v}-{d}x{t}" for v, (d, t) in CASES]
GLOO = ("hymba-1.5b", "whisper-tiny")           # on (2, 2), both kinds
REF_PROCS = 2

# the reference's --opt train and prefill cells on 8 virtual devices, per
# (arch, mesh); params, batches and caches from an npz
REF_SCRIPT = """
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
devs = np.asarray(jax.devices())      # before dryrun's import sets 512
assert len(devs) == 8
from jax.sharding import Mesh
from repro.configs.shapes import ShapeSpec
from repro.launch.dryrun import _opt_cfg
from repro.launch.input_specs import build_cell
from repro.models import registry as RR
from repro.models.common import ModelConfig
from repro.optim.adamw import OptConfig, adamw_init
from repro.train.step import TrainState

assert os.environ["REPRO_CONSTRAIN_ACTS"] == "1"
inp = dict(np.load(sys.argv[1]))
meta = json.load(open(sys.argv[2]))
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
for name, (d, t) in meta["cases"]:
    arch, kw = meta["variants"][name]
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    base = ModelConfig(name=arch, dtype=jnp.float32, remat=True, **kw)
    mesh = Mesh(devs[:d * t].reshape(d, t), ("data", "model"))
    params = unflat(f"{arch}/params/")
    tag = f"{name}/{d}x{t}"
    cfg, on = _opt_cfg(arch, base, "train")
    assert on and cfg.pure_dp
    cell = build_cell(arch, cfg, ShapeSpec("t", "train", meta["s"], meta["b"]),
                      mesh, OptConfig(**meta["opt"]))
    state = TrainState(params, adamw_init(params), jnp.zeros((), jnp.int32))
    with mesh:
        f = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings, compiler_options=fast)
        new, metrics = f(state, unflat(f"{arch}/train/"))
    for part, tree in (("m", new.opt["m"]), ("v", new.opt["v"])):
        for key, v in flat(tree, f"{tag}/train/{part}"):
            out[key] = v
    out[f"{tag}/train/loss"] = np.asarray(metrics["loss"])
    out[f"{tag}/train/grad_norm"] = np.asarray(metrics["grad_norm"])
    cfg, on = _opt_cfg(arch, base, "prefill")
    cell = build_cell(arch, cfg, ShapeSpec("p", "prefill", meta["s"],
                                           meta["b"]), mesh)
    cache = RR.get_api(cfg).init_cache(cfg, meta["b"], meta["s"])
    with mesh:
        f = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings, compiler_options=fast)
        logits, cache = f(params, cache, unflat(f"{arch}/prefill/"))
    out[f"{tag}/prefill/logits"] = np.asarray(logits)
    for key, v in flat(cache, f"{tag}/prefill/cache"):
        out[key] = v
np.savez(sys.argv[3], **out)
"""

is_t = lambda x: isinstance(x, torch.Tensor)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _kw(name):
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in VARIANTS[name][1].items()}


def _cfg(name, kind):
    """The port's ``--opt`` config of the small case ``name`` for
    ``kind``."""
    arch = VARIANTS[name][0]
    base = ModelConfig(name=arch, dtype=torch.float32, remat=True, **_kw(name))
    cfg, on = dryrun._opt_cfg(arch, base, kind)
    assert on and cfg.pure_dp
    return cfg


def _inputs(arch):
    """Params (the reference's init, crossed to the port), a train batch
    and a prefill batch, from seeds."""
    rcfg = RModelConfig(name=arch, dtype=jnp.float32, **_kw(arch))
    rparams = jax.tree.map(np.asarray, RR.get_api(rcfg).init(
        jax.random.PRNGKey(sorted(ARCHS).index(arch)), rcfg))
    rng = np.random.RandomState(len(arch) + 3)
    train = {"tokens": rng.randint(0, rcfg.vocab_size,
                                   (B, S + 1)).astype(np.int32)}
    prefill = {"tokens": rng.randint(0, rcfg.vocab_size,
                                     (B, S)).astype(np.int32)}
    if rcfg.family == "encdec":
        for batch in (train, prefill):
            batch["frames"] = rng.randn(B, rcfg.enc_seq_len,
                                        rcfg.d_model).astype(np.float32)
    return rparams, train, prefill


def _state(params):
    return TrainState(params, adamw_init(params),
                      torch.zeros((), dtype=torch.int32))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cell(name, kind, mesh):
    cfg = _cfg(name, kind)
    shape = ShapeSpec("t", "train", S, B) if kind == "train" else \
        ShapeSpec("p", "prefill", S, B)
    return IS.build_cell(VARIANTS[name][0], cfg, shape, mesh,
                         OptConfig(**OPT_KW), policy=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference subprocesses and a gloo world of 4 ranks side by
    side; the one-device results meanwhile."""
    tmp = tmp_path_factory.mktemp("seq_shard")
    npz, data = {}, {}
    for arch in ARCHS:
        rparams, train, prefill = _inputs(arch)
        data[arch] = (params_from_numpy(rparams, device="cpu"), _torch(train),
                      _torch(prefill))
        npz.update({f"{arch}/params/{k}": v
                    for k, v in _flat(rparams).items()})
        npz.update({f"{arch}/train/{k}": v for k, v in train.items()})
        npz.update({f"{arch}/prefill/{k}": v for k, v in prefill.items()})
    np.savez(tmp / "in.npz", **npz)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               REPRO_CONSTRAIN_ACTS="1")
    procs = []
    for i in range(REF_PROCS):
        (tmp / f"meta{i}.json").write_text(json.dumps(
            {"variants": VARIANTS, "cases": CASES[i::REF_PROCS], "s": S,
             "b": B, "opt": OPT_KW}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
             str(tmp / "in.npz"), str(tmp / f"meta{i}.json"),
             str(tmp / f"ref{i}.npz")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        cases = {}
        for arch in GLOO:
            params, train, prefill = data[arch]
            cases[arch] = dict(arch=arch, cfg_kw=_kw(arch), s_b=(S, B),
                               opt=OPT_KW, train=(_state(params), train),
                               prefill=(params, _cache(arch), prefill))
        gloo = ranks.spawn(ranks.seq_shard_ranks, 4, str(tmp / "ranks"),
                           {"cases": cases, "mesh": (2, 2)}, timeout=300)
        single = {}
        for name, (arch, _) in VARIANTS.items():
            params, train, prefill = data[arch]
            cfg = _cfg(name, "train")
            single[name] = _loss_and_grads(cfg, get_api(cfg))(params, train)
        for proc in procs:
            so, se = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"reference failed:\n{so}\n{se}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    ref = {}
    for i in range(REF_PROCS):
        ref.update(np.load(tmp / f"ref{i}.npz"))
    return dict(data=data, gloo=gloo, single=single, ref=ref)


def _cache(name):
    cfg = _cfg(name, "prefill")
    return get_api(cfg).init_cache(cfg, B, S, device="cpu")


def _local(tree, specs, ctx):
    return spec_map(lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size,
                                                   ctx.index)].clone(),
                    tree, specs, is_leaf=is_t)


def _policy(mesh):
    return acts.activation_policy(mesh, "data", seq_shard=True)


def _run(cell, mesh, inputs, stats=None, grad=False):
    """Every rank's body in turn on its slices (the cell's body enters
    the cell's policy itself): (outputs, rank inputs)."""
    mine = {}

    def make(rank, ctx):
        mine[rank] = tuple(_local(x, sp, ctx)
                           for x, sp in zip(inputs, cell.in_shardings))
        return cell.body(ctx, *mine[rank])
    with torch.set_grad_enabled(grad):
        return C.run_in_process(make, mesh, stats), mine


def _close(got, want, scale, rel=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=rel * max(float(scale), 1e-30))


@pytest.mark.parametrize("name,mesh_shape", CASES, ids=IDS)
def test_train_cell_matches_one_device_and_reference(world, name, mesh_shape):
    params, batch, _ = world["data"][VARIANTS[name][0]]
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    loss1, _, grads1 = world["single"][name]
    cell = _cell(name, "train", mesh)
    outs, _ = _run(cell, mesh, (_state(params), batch), grad=True)
    specs = spec_leaves(cell.in_shardings[0])
    new = [C.assemble({r: tree_leaves(o[0])[i] for r, o in enumerate(outs)},
                      sp, full.shape, mesh)
           for i, (full, sp) in enumerate(zip(tree_leaves(_state(params)),
                                              specs))]
    n = len(tree_leaves(params))
    p_new, m_new, v_new = new[:n], new[n:2 * n], new[2 * n + 1:]
    opt = OptConfig(**OPT_KW)
    # one step from zero moments: m = (1 - beta1) x the clipped gradient
    scale = min(1.0, opt.clip_norm / float(outs[0][1]["grad_norm"]))
    for m, want in zip(m_new, tree_leaves(grads1)):
        _close(m / ((1 - opt.beta1) * scale), want, want.abs().max())
    ref = world["ref"]
    tag = f"{name}/{mesh_shape[0]}x{mesh_shape[1]}/train"
    for part, got_leaves in (("m", m_new), ("v", v_new)):
        for path, got in zip(leaf_paths(params), got_leaves):
            want = ref[f"{tag}/{part}/{path}"]
            _close(got, want, np.abs(want).max())
    for o in outs:
        np.testing.assert_allclose(float(o[1]["loss"]), float(loss1),
                                   rtol=1e-5)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(o[1][name]),
                                       float(ref[f"{tag}/{name}"]), rtol=1e-5)
    lr = float(outs[0][1]["lr"])
    b1c, b2c = 1 - opt.beta1, 1 - opt.beta2
    for p, m, v, got in zip(tree_leaves(params), m_new, v_new, p_new):
        want = p.double() - lr * ((m.double() / b1c) / (
            (v.double() / b2c).sqrt() + opt.eps) + opt.weight_decay * p)
        _close(got, want, want.abs().max(), 1e-6)


def _prefill(name, mesh, params, batch, stats=None):
    """The prefill cell's ranks: (logits (B, V), assembled cache leaves,
    the cell, rank inputs)."""
    cell = _cell(name, "prefill", mesh)
    cache = _cache(name)
    outs, mine = _run(cell, mesh, (params, cache, batch), stats)
    rows = cell.in_shardings[2]["tokens"][0]
    logits = C.assemble({r: o[0] for r, o in enumerate(outs)}, (rows, None),
                        (B, outs[0][0].shape[1]), mesh)
    leaves = [C.assemble({r: tree_leaves(o[1])[i] for r, o in enumerate(outs)},
                         sp, full.shape, mesh)
              for i, (full, sp) in enumerate(zip(
                  tree_leaves(cache), spec_leaves(cell.in_shardings[1])))]
    return logits, leaves, cell, mine


@pytest.mark.parametrize("name,mesh_shape", CASES, ids=IDS)
def test_prefill_cell_matches_one_device_and_reference(world, name,
                                                       mesh_shape):
    params, _, batch = world["data"][VARIANTS[name][0]]
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    cfg = _cfg(name, "prefill")
    cache1 = _cache(name)
    with torch.no_grad():
        want, _ = get_api(cfg).prefill(params, cfg, cache1, batch)
    logits, leaves, _, _ = _prefill(name, mesh, params, batch)
    ref = world["ref"]
    tag = f"{name}/{mesh_shape[0]}x{mesh_shape[1]}/prefill"
    scale = want.abs().max()
    _close(logits, want, scale)
    _close(logits, ref[f"{tag}/logits"], scale)
    for path, got, w in zip(leaf_paths(cache1), leaves, tree_leaves(cache1)):
        scale = w.double().abs().max()
        _close(got.double(), w.double(), scale)
        _close(got.double(), ref[f"{tag}/cache/{path}"], scale)


def test_whisper_frames_split_only_where_they_divide():
    """18 frames: split over a model axis of 2 (9 a rank), whole on every
    rank of 4, as ``_constrain`` keeps a dim that does not divide."""
    rank = lambda t: C.RankContext({"data": 0, "model": 1},
                                   {"data": 1, "model": t})
    for t, rows in ((2, 9), (4, None)):
        mesh = C.InProcessMesh((1, t), ("data", "model"))
        with _policy(mesh), acts.seq_split(rank(t), S) as split:
            assert split.rows == S // t
            got = acts.stream_split(ARCHS["whisper-tiny"]["enc_seq_len"])
            assert (got and got.rows) == rows
            if got:
                assert got.start == rows
    with acts.seq_split(rank(4), S) as split:         # no policy: whole
        assert split is None and acts.stream_split(16) is None


def _param_gather_bytes(cell, rank_inputs, model: int) -> int:
    """Bytes a rank asks to gather its parameters over the model axis:
    its slice of each leaf whose spec splits it there."""
    specs = spec_leaves(cell.in_shardings[0])
    return sum(t.numel() * t.element_size()
               for t, sp in zip(tree_leaves(rank_inputs[0]), specs)
               if any("model" in C.spec_axes(e) for e in sp)) if model > 1 \
        else 0


@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-130m"])
def test_comm_bytes_equal_the_formula(world, arch):
    """(1, 4), prefill: the parameters' gathers, then per dense layer the
    (B, S/4, Hkv, Dh) K and V of the rank's rows, per SSD layer its
    (B, ssm_conv - 1, C) tail rows and one (B, H, N * P + 1) float32
    state and log-decay, and the last position's (B, 1, D) row; nothing
    of the sequence else, and nothing but gathers."""
    params, _, batch = world["data"][arch]
    cfg = _cfg(arch, "prefill")
    mesh = C.InProcessMesh((1, 4), ("data", "model"))
    stats = C.CommStats()
    _, _, cell, mine = _prefill(arch, mesh, params, batch, stats)
    rows = S // 4
    if cfg.family == "dense":
        per_layer = 2 * B * rows * cfg.n_kv_heads * cfg.dh * 4
    else:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        per_layer = B * (cfg.ssm_conv - 1) * conv_dim * 4 + B * cfg.ssm_heads \
            * (cfg.ssm_state * cfg.ssm_head_dim + 1) * 4
    for rank in range(4):
        assert set(stats.sent[rank]) == {"all_gather"}
        assert stats.by_axis[rank]["all_gather"] == {
            "model": _param_gather_bytes(cell, mine[rank], 4)
            + cfg.n_layers * per_layer + B * cfg.d_model * 4}


@pytest.mark.parametrize("arch", ["minitron-4b", "mamba2-130m"])
def test_fake_flops_per_rank_fall_with_the_split(arch):
    """The fake trace of the ``--opt`` cells at (1, 4) against the same
    cells at (1, 1), where one rank computes the whole sequence: four
    ranks' FLOPs are one rank's whole-sequence FLOPs plus only what the
    split adds: the last position's head on each of the other three
    ranks (prefill), and the incoming state's term of every SSD layer,
    2 B S H N P FLOPs over the four ranks (prefill: once; train: its
    forward, its remat recompute and its backward, at most four times)."""
    for kind in ("train", "prefill"):
        cfg = _cfg(arch, kind)
        shape = ShapeSpec("t", kind, S, B)
        make = lambda m: IS.build_cell(arch, cfg, shape, m, policy=True)
        flops = {t: dryrun.run_fake(make, None, device="cpu", mesh_shape=(
            (1, t), ("data", "model")))["cost"]["flops"] for t in (1, 4)}
        extra = 4 * flops[4] - flops[1]
        head = 3 * 2 * B * cfg.d_model * cfg.vocab_size \
            if kind == "prefill" else 0
        state = 2 * B * S * cfg.ssm_heads * cfg.ssm_state \
            * cfg.ssm_head_dim * cfg.n_layers if cfg.ssm_state else 0
        if kind == "prefill" or not state:
            assert extra == head + state, (kind, flops)
        else:
            assert 3 * state <= extra <= 4 * state, (kind, flops)


@pytest.mark.parametrize("arch", GLOO)
def test_gloo_world_equals_in_process_bitwise(world, arch):
    params, train, prefill = world["data"][arch]
    mesh = C.InProcessMesh((2, 2), ("data", "model"))
    outs, _ = _run(_cell(arch, "train", mesh), mesh, (_state(params), train),
                   grad=True)
    pouts, _ = _run(_cell(arch, "prefill", mesh), mesh,
                    (params, _cache(arch), prefill))
    for rank, got in enumerate(world["gloo"]):
        g = got[arch]
        for a, b in zip(g["train"]["state"], tree_leaves(outs[rank][0])):
            assert torch.equal(a, b), rank
        for k, v in outs[rank][1].items():
            assert torch.equal(g["train"]["metrics"][k], v), (rank, k)
        assert torch.equal(g["prefill"]["logits"], pouts[rank][0]), rank
        for a, b in zip(g["prefill"]["cache"], tree_leaves(pouts[rank][1])):
            assert torch.equal(a, b), rank
