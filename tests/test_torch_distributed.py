"""The port's distributed pieces against the JAX reference: sharding rules
and layouts, the sharded train step, elastic reshard, expert parallelism,
the compressed all-reduce and the launcher's production mesh
(counterparts of tests/test_distributed.py).

The port's ranks are 8 gloo processes on the CPU (tests/torch_dist_ranks.py,
one world for the whole file). The reference's sharded functions run as
its own tests run them: in a subprocess with 8 virtual CPU devices;
single-device oracles run in this process. Inputs come from numpy seeds
and reference params cross through ``bridge.params_from_numpy``.

Sizes: the reference's substrate model (dense, 2 layers, d_model 64, 4 / 2
heads, d_ff 128, vocab 256, float32), batch 8 x 32, on a (data 4, model 2)
mesh; olmoe-1b-7b's SMOKE config (8 experts, top 2) in float32 on
(data 2, model 4); an (8, 64) gradient on (pod 2, data 4).

Tolerances:
  * specs trees, layouts, reshard, int8 codes, in-process vs gloo: exact;
  * the sharded step against single-device steps (the port's and the
    reference's) and the reference's sharded step: the reference's own
    limits, loss rtol 1e-5 / atol 1e-6, params rtol = atol = 2e-4;
  * the compressed mean: within 1.1 x scale of the exact mean (the
    reference's limit) and equal to the reference's output to 1 ulp;
  * EP against the port's local ``moe_apply`` and the reference's EP:
    rtol = atol = 1e-5 on the output (float32 sums in another order),
    1e-6 on ``aux``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as rquant  # noqa: E402
from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.core.detector import DetectorConfig as RDetectorConfig  # noqa: E402
from repro.core.detector import detector_logical_axes as r_det_axes  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.models.common import ModelConfig as RModelConfig  # noqa: E402
from repro.msda.decoder import MSDADecoderConfig as RDecCfg  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import compress as rcompress  # noqa: E402
from repro.data import tokens as rtokens  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.detector import DetectorConfig, detector_logical_axes  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import P, spec_placements  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.msda.decoder import MSDADecoderConfig  # noqa: E402
from repro_torch.optim.adamw import OptConfig, adamw_init, tree_leaves  # noqa: E402
from repro_torch.optim.compress import compressed_psum_body, quantize_grad  # noqa: E402
from repro_torch.train.step import (TrainState, build_train_step,  # noqa: E402
                                    train_state_shardings)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG_KW = dict(family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, remat=False)
LAYOUTS = {
    "dense": CFG_KW,
    "fsdp": dict(CFG_KW, use_fsdp=True),
    "pure_dp": dict(CFG_KW, pure_dp=True),
    "moe": dict(CFG_KW, family="moe", n_experts=8, n_experts_active=2),
}
OPT_KW = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.0)
DATA_KW = dict(vocab_size=256, seq_len=32, global_batch=8, seed=3)
EP_SHAPE = (4, 16)                   # (B, S) of the EP input
MESH_A, MESH_EP = (4, 2), (2, 4)

# the reference side on 8 virtual devices: its sharded step, its specs and
# device slices, its EP and its compressed psum (reads/writes npz + json)
REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models.common import ModelConfig
from repro.optim.adamw import OptConfig
from repro.train.step import build_train_step, make_train_state, train_state_shardings
from repro.models import layers as L
from repro.configs import get_smoke_config
from repro.distributed.act_sharding import activation_policy
from repro.optim.compress import compressed_psum, quantize_grad
import dataclasses
from jax.experimental.shard_map import shard_map

inp = dict(np.load(sys.argv[1]))
meta = json.load(open(sys.argv[2]))
assert len(jax.devices()) == 8
out, info = {}, {}
devs = np.asarray(jax.devices())

cfg = ModelConfig(dtype=jnp.float32, **meta["cfg_kw"])
opt = OptConfig(**meta["opt_kw"])
batch = {"tokens": jnp.asarray(inp["tokens"])}
mesh = Mesh(devs.reshape(4, 2), ("data", "model"))
s1 = make_train_state(jax.random.PRNGKey(0), cfg)
with mesh:
    specs = train_state_shardings(cfg, mesh, jax.eval_shape(lambda: s1))
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, P))
    bsh = {"tokens": NamedSharding(mesh, P("data", None))}
    stepd = jax.jit(build_train_step(cfg, opt), in_shardings=(sh, bsh),
                    out_shardings=(sh, None))
    s1, m1 = stepd(s1, batch)
out["sharded_loss"] = np.asarray(m1["loss"])
for i, a in enumerate(jax.tree.leaves(s1.params)):
    out[f"sharded_p{i}"] = np.asarray(a)

info["layouts"] = {}
for name, kw in meta["layouts"].items():
    c = ModelConfig(dtype=jnp.float32, **kw)
    st = jax.eval_shape(lambda: make_train_state(jax.random.PRNGKey(0), c))
    sp = train_state_shardings(c, mesh, st)
    leaves = jax.tree.leaves(sp, is_leaf=lambda x: isinstance(x, P))
    shapes = [l.shape for l in jax.tree.leaves(st)]
    rows = []
    for spec, shape in zip(leaves, shapes):
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        rows.append({"spec": [list(e) if isinstance(e, tuple) else e
                              for e in spec],
                     "slices": [[[s.start, s.stop] for s in idx[d]]
                                for d in devs.reshape(-1)]})
    info["layouts"][name] = rows

ecfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype=jnp.float32)
p = {k[3:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("ep_")}
mesh_ep = Mesh(devs.reshape(2, 4), ("data", "model"))
with activation_policy(mesh_ep, "data"):
    eo, ea = L.moe_apply(p, ecfg, jnp.asarray(inp["x_ep"]))
out["ep_out"], out["ep_aux"] = np.asarray(eo), np.asarray(ea)

mesh_pd = Mesh(devs.reshape(2, 4), ("pod", "data"))
g = jnp.asarray(inp["g"])
fm = shard_map(lambda gl, r: compressed_psum(gl, "pod", bits=8, residual=r),
               mesh=mesh_pd, in_specs=(P(("pod", "data")), P(("pod", "data"))),
               out_specs=(P(("pod", "data")), P(("pod", "data"))))
o1, r1 = fm(g, jnp.zeros_like(g))
o2, r2 = fm(g, r1)
out.update(c_out=np.asarray(o1), c_res=np.asarray(r1), c_out2=np.asarray(o2),
           c_res2=np.asarray(r2))
# the codes compressed_psum sends: each row quantized on its pod group's
# largest scale (rows r and r + 4 share a data index)
for tag, gin in (("q", g), ("q2", g + r1)):
    scales = jnp.stack([quantize_grad(gin[r])[1] for r in range(8)])
    smax = jnp.maximum(scales[:4], scales[4:])
    smax = jnp.concatenate([smax, smax])[:, None]
    out["c_" + tag] = np.asarray(
        jnp.clip(jnp.round(gin / smax), -128, 127).astype(jnp.int32))
np.savez(sys.argv[3], **out)
json.dump(info, open(sys.argv[4], "w"))
"""


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_state(cfg_kw):
    rcfg = RModelConfig(dtype=jnp.float32, **cfg_kw)
    return rcfg, rstep.make_train_state(jax.random.PRNGKey(0), rcfg)


def _port_state(rstate):
    params = params_from_numpy(_np_tree(rstate.params), device="cpu")
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32))


def _ep_case():
    rcfg = dataclasses.replace(r_smoke("olmoe-1b-7b"), dtype=jnp.float32)
    rparams = _np_tree(RL.moe_init(jax.random.PRNGKey(5), rcfg))
    x = np.random.RandomState(11).randn(*EP_SHAPE, rcfg.d_model).astype(np.float32)
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), dtype=torch.float32)
    return rcfg, rparams, x, cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One run of everything: the reference subprocess and the 8 gloo
    ranks side by side, and the single-device and in-process results."""
    tmp = tmp_path_factory.mktemp("dist")
    _, rstate = _ref_state(CFG_KW)
    tokens = np.array(rtokens.synth_token_batch(
        rtokens.TokenDataConfig(**DATA_KW), 0)["tokens"])
    _, ep_params, ep_x, cfg_ep = _ep_case()
    ep_c = np.random.RandomState(12).randn(*ep_x.shape).astype(np.float32)
    g = np.random.RandomState(7).randn(8, 64).astype(np.float32)

    npz = dict(tokens=tokens, g=g, x_ep=ep_x,
               **{f"ep_{k}": v for k, v in ep_params.items()})
    np.savez(tmp / "in.npz", **npz)
    (tmp / "meta.json").write_text(json.dumps(
        {"cfg_kw": CFG_KW, "opt_kw": OPT_KW, "layouts": LAYOUTS}))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp / "in.npz"),
         str(tmp / "meta.json"), str(tmp / "ref.npz"), str(tmp / "ref.json")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        state = _port_state(rstate)
        batch = {"tokens": torch.from_numpy(tokens)}
        layouts = {}
        for name, kw in LAYOUTS.items():
            layouts[name] = (dict(kw, dtype=torch.float32),
                             _port_state(_ref_state(kw)[1]))
        ep_torch = params_from_numpy(ep_params, device="cpu")
        inputs = dict(
            train_cfg=dict(CFG_KW, dtype=torch.float32), opt_cfg=OPT_KW,
            state=state, batch=batch, ckpt_dir=str(tmp / "ckpt"),
            launch_ckpt=str(tmp / "launch_ckpt"),
            layouts=layouts,
            ep=dict(cfg={f.name: getattr(cfg_ep, f.name)
                         for f in dataclasses.fields(cfg_ep)},
                    params=ep_torch, x=torch.from_numpy(ep_x),
                    c=torch.from_numpy(ep_c)),
            g=torch.from_numpy(g))
        gloo = ranks.spawn(ranks.world8_ranks, 8, str(tmp / "ranks"), inputs,
                           timeout=240)
        so, se = ref_proc.communicate(timeout=400)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    assert ref_proc.returncode == 0, f"reference failed:\n{so}\n{se}"
    ref = dict(np.load(tmp / "ref.npz"))
    ref_info = json.loads((tmp / "ref.json").read_text())
    return dict(gloo=gloo, ref=ref, ref_info=ref_info, state=state,
                batch=batch, tokens=tokens, layouts=layouts, ep_params=ep_torch,
                ep_x=torch.from_numpy(ep_x), ep_c=torch.from_numpy(ep_c),
                cfg_ep=cfg_ep,
                g=torch.from_numpy(g), rstate=rstate, tmp=tmp)


# --------------------------------------------------------------------------
# pieces that need no world
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits,axis", [(12, None), (8, -1), (8, 1)])
def test_quantize_dequantize_match_reference(bits, axis):
    x = np.random.RandomState(bits).randn(4, 6, 8).astype(np.float32) * 3
    rq, rs = rquant.quantize(jnp.asarray(x), bits, axis)
    q, s = quant.quantize(torch.from_numpy(x), bits, axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(quant.dequantize(q, s).numpy(),
                                  np.asarray(rquant.dequantize(rq, rs)))


def test_pack_unpack_int8_match_reference():
    x = np.random.RandomState(3).randn(5, 7, 16).astype(np.float32)
    rq, rs = rquant.pack_int8(jnp.asarray(x))
    q, s = quant.pack_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(quant.unpack_int8(q, s).numpy(),
                                  np.asarray(rquant.unpack_int8(rq, rs)))


def _norm_tree(tree):
    """Specs / logical axes as nested plain lists (JAX and port alike)."""
    if isinstance(tree, dict):
        return {k: _norm_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: _norm_tree(v) for k, v in tree._asdict().items()}
    if isinstance(tree, list):
        return [_norm_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tuple(e) if isinstance(e, tuple) else e for e in tree)
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_axes_and_rules_overrides_match_reference(arch):
    rc, c = r_smoke(arch), get_smoke_config(arch)
    assert _norm_tree(registry.get_api(c).axes(c)) == \
        _norm_tree(RR.get_api(rc).axes(rc))
    for m in (1, 2, 4, 16):
        assert registry.rules_overrides(c, m) == RR.rules_overrides(rc, m)


def test_detector_logical_axes_match_reference():
    rcfg = RDetectorConfig(decoder=RDecCfg(n_layers=2))
    cfg = DetectorConfig(decoder=MSDADecoderConfig(n_layers=2))
    assert _norm_tree(detector_logical_axes(cfg)) == \
        _norm_tree(r_det_axes(rcfg))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_train_state_shardings_match_reference_specs(world, name):
    cfg_kw, state = world["layouts"][name]
    mesh = C.InProcessMesh(MESH_A, ("data", "model"))
    specs = train_state_shardings(ModelConfig(**cfg_kw), mesh, state)
    got = [_norm_tree(s) for s in
           jax.tree.leaves(_to_jax_specs(specs), is_leaf=_is_jspec)]
    want = [tuple(tuple(e) if isinstance(e, list) else e for e in row["spec"])
            for row in world["ref_info"]["layouts"][name]]
    assert got == want


def _is_jspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _to_jax_specs(tree):
    """A port spec tree as JAX PartitionSpecs (for JAX's leaf order)."""
    if isinstance(tree, P):
        return jax.sharding.PartitionSpec(*tree)
    if isinstance(tree, dict):
        return {k: _to_jax_specs(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_to_jax_specs(v) for v in tree])
    return type(tree)(_to_jax_specs(v) for v in tree)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_rank_shards_match_devices_indices_map(world, name):
    """Rank r's local shard of every leaf is the slice JAX's NamedSharding
    gives device r of the same mesh shape: ("pod", "data")-style splits
    of one dim go major to minor."""
    _, state = world["layouts"][name]
    full = tree_leaves(state)
    rows = world["ref_info"]["layouts"][name]
    assert len(rows) == len(full)
    for rank, res in enumerate(world["gloo"]):
        local = res["layouts"][name]
        for leaf, shard, row in zip(full, local, rows):
            sl = tuple(slice(a, b) for a, b in row["slices"][rank])
            assert torch.equal(shard, leaf[sl])


def test_spec_placements_split_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard
    mesh = C.InProcessMesh((2, 4, 2), ("pod", "data", "model"))
    assert spec_placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert spec_placements(P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        spec_placements(P(("data", "pod")), mesh)
    sizes = C.mesh_shape(mesh)
    # rank (pod 1, data 2, model 0) holds rows 6 of 8 (1 * 4 + 2)
    sl = C.local_slices(P(("pod", "data"), None), (16, 3), sizes,
                        {"pod": 1, "data": 2, "model": 0})
    assert sl == (slice(12, 14), slice(None))


def test_in_process_collectives():
    mesh = C.InProcessMesh((2, 3), ("data", "model"))
    seen = {}

    def make(rank, ctx):
        def body():
            x = torch.tensor([float(rank)])
            above, below = yield C.ring_exchange("model", x, x + 100)
            gat = yield C.all_gather("model", x, dim=0)
            tot = yield C.psum(("data", "model"), x)
            mx = yield C.pmax("data", x)
            mean = yield C.pmean("model", x)
            seen[rank] = (above.item(), below.item(), gat.tolist(), tot.item(),
                          mx.item(), mean.item())
            return rank
        return body()

    assert C.run_in_process(make, mesh) == list(range(6))
    # rank 4 = (data 1, model 1): neighbours 3 and 5 along "model"
    assert seen[4] == (3.0, 105.0, [3.0, 4.0, 5.0], 15.0, 4.0, 4.0)
    assert seen[0][:2] == (2.0, 101.0)                 # the ring wraps


# --------------------------------------------------------------------------
# the sharded step, reshard, EP, compressed psum, launcher (the world)
# --------------------------------------------------------------------------

def test_sharded_train_step_matches_single_device(world):
    opt = OptConfig(**OPT_KW)
    cfg = ModelConfig(dtype=torch.float32, **CFG_KW)
    s0, m0 = build_train_step(cfg, opt)(world["state"], world["batch"])
    rcfg = RModelConfig(dtype=jnp.float32, **CFG_KW)
    rs, rm = jax.jit(rstep.build_train_step(rcfg, radamw.OptConfig(**OPT_KW)))(
        world["rstate"], {"tokens": jnp.asarray(world["tokens"])})
    ref = world["ref"]
    for res in world["gloo"]:
        loss = float(res["train"]["loss"])
        for want in (float(m0["loss"]), float(rm["loss"]),
                     float(ref["sharded_loss"])):
            np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-6)
        got = res["train"]["params"]
        wants = (tree_leaves(s0.params), jax.tree.leaves(rs.params),
                 [ref[f"sharded_p{i}"] for i in range(len(got))])
        for want in wants:
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=2e-4, atol=2e-4)


def test_sharded_train_step_state_layout(world):
    """Every leaf of the state the step returns has the placements of
    ``train_state_shardings``, and each rank holds its slice."""
    mesh = C.InProcessMesh(MESH_A, ("data", "model"))
    cfg = ModelConfig(dtype=torch.float32, **CFG_KW)
    specs = train_state_shardings(cfg, mesh, world["state"])
    spec_list = [s for s in jax.tree.leaves(_to_jax_specs(specs),
                                            is_leaf=_is_jspec)]
    want_pl = [tuple(str(p) for p in spec_placements(tuple(s), mesh))
               for s in spec_list]
    full = [torch.as_tensor(x) for x in world["gloo"][0]["train"]["params"]]
    n_params = len(full)
    for rank, res in enumerate(world["gloo"]):
        assert res["train"]["placements"] == want_pl
        idx = mesh.coords(rank)
        for spec, leaf, local in zip(spec_list[:n_params], full,
                                     res["train"]["local"][:n_params]):
            assert torch.equal(local, leaf[C.local_slices(
                tuple(spec), leaf.shape, C.mesh_shape(mesh), idx)])


def test_elastic_reshard_bitwise(world):
    """Saved from a 4 x 2 mesh, restored onto 2 x 4 (and a live state
    moved across): bitwise the unsharded state."""
    want = tree_leaves(world["state"])
    for res in world["gloo"]:
        for key in ("reshard", "reshard_live"):
            assert len(res[key]) == len(want)
            for a, b in zip(res[key], want):
                assert torch.equal(a, b)


def _ep_in_process(world):
    mesh = C.InProcessMesh(MESH_EP, ("data", "model"))
    with acts.activation_policy(mesh, "data"):
        assert acts.model_axis_size() == 4
        return L.moe_apply(world["ep_params"], world["cfg_ep"], world["ep_x"])


def test_ep_matches_local_and_reference(world):
    out, aux = _ep_in_process(world)
    local, _ = L.moe_apply(world["ep_params"], world["cfg_ep"], world["ep_x"])
    np.testing.assert_allclose(out.numpy(), local.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), world["ref"]["ep_out"],
                               rtol=1e-5, atol=1e-5)
    # aux: each data shard's balance loss, averaged (the reference's EP)
    halves = [L.moe_apply(world["ep_params"], world["cfg_ep"], x)[1]
              for x in world["ep_x"].chunk(MESH_EP[0])]
    np.testing.assert_allclose(float(aux), float(sum(halves)) / len(halves),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(world["ref"]["ep_aux"]),
                               rtol=1e-6, atol=1e-6)
    # gloo ranks: (data d, model m) holds rows 2d .. 2d+1
    for rank, res in enumerate(world["gloo"]):
        d = rank // MESH_EP[1]
        np.testing.assert_allclose(res["ep"]["out"].numpy(),
                                   out[2 * d:2 * d + 2].numpy(), rtol=0, atol=0)


def test_ep_backward_matches_local(world):
    """Gradients through EP on the gloo ranks, summed over the ranks (each
    holds the part of a leaf's gradient that its own uses contribute),
    equal the local ``moe_apply``'s gradients of the whole batch's
    (out . c) + aux, aux the mean of the data shards' balance losses:
    float32 at rtol = atol = 1e-5, as the forward."""
    cfg = world["cfg_ep"]
    prm = {k: v.clone().requires_grad_(True)
           for k, v in world["ep_params"].items()}
    x = world["ep_x"].clone().requires_grad_(True)
    out, _ = L.moe_apply(prm, cfg, x)
    auxes = [L.moe_apply(prm, cfg, xx)[1] for xx in x.chunk(MESH_EP[0])]
    ((out * world["ep_c"]).sum() + sum(auxes) / len(auxes)).backward()
    grads = [res["ep_grad"] for res in world["gloo"]]
    for k, v in prm.items():
        got = sum(g[k] for g in grads)
        assert float(v.grad.abs().max()) > 0, k
        np.testing.assert_allclose(got.numpy(), v.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # x: data shard d's rows, summed over its model ranks
    per_d = [sum(grads[d * MESH_EP[1] + m]["x"] for m in range(MESH_EP[1]))
             for d in range(MESH_EP[0])]
    np.testing.assert_allclose(torch.cat(per_d).numpy(), x.grad.numpy(),
                               rtol=1e-5, atol=1e-5)


def _compress_in_process(g):
    mesh = C.InProcessMesh((2, 4), ("pod", "data"))
    spec = (("pod", "data"), None)

    def rounds(rank, ctx):
        def body():
            gl = g[C.local_slices(spec, g.shape, ctx.size, ctx.index)]
            o1, r1, q1 = yield from compressed_psum_body(
                ctx, gl, "pod", 8, torch.zeros_like(gl))
            o2, r2, q2 = yield from compressed_psum_body(ctx, gl, "pod", 8, r1)
            return dict(out=o1, res=r1, q=q1, out2=o2, res2=r2, q2=q2)
        return body()
    return C.run_in_process(rounds, mesh)


def test_compressed_psum_matches_reference(world):
    g = world["g"]
    ref = world["ref"]
    want = g.reshape(2, 4, 64).mean(0).repeat(2, 1)
    scale = float(g.abs().max()) / 127.0
    ranks_out = [r["compress"] for r in world["gloo"]]
    out = torch.cat([r["out"] for r in ranks_out])
    out2 = torch.cat([r["out2"] for r in ranks_out])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=scale * 1.1)
    e1 = (out - want).abs().mean()
    e2 = ((out + out2) / 2 - want).abs().mean()
    assert e2 <= e1 + 1e-7, (float(e1), float(e2))
    for tag in ("q", "q2"):
        np.testing.assert_array_equal(
            torch.cat([r[tag] for r in ranks_out]).numpy(), ref["c_" + tag])
    for tag in ("out", "res", "out2", "res2"):
        np.testing.assert_array_max_ulp(
            torch.cat([r[tag] for r in ranks_out]).numpy(), ref["c_" + tag],
            maxulp=1)
    # the pure pieces against the reference's
    rq, rs = rcompress.quantize_grad(jnp.asarray(g.numpy()))
    q, s = quantize_grad(g)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize("which", ["ep", "compressed_psum"])
def test_in_process_equals_gloo_bitwise(world, which):
    if which == "ep":
        out, aux = _ep_in_process(world)
        for rank, res in enumerate(world["gloo"]):
            d = rank // MESH_EP[1]
            assert torch.equal(res["ep"]["out"], out[2 * d:2 * d + 2])
            assert torch.equal(res["ep"]["aux"], aux)
        return
    local = _compress_in_process(world["g"])
    for rank, res in enumerate(world["gloo"]):
        for k, v in local[rank].items():
            assert torch.equal(res["compress"][k], v), k


def test_launcher_trains_and_resumes_over_the_world(world):
    """Under a world of 8 gloo ranks the launcher trains on the local mesh
    (8, 1): 2 steps with a checkpoint after each, then a run to 3 steps
    that resumes from the sharded store rank 0 wrote."""
    for res in world["gloo"]:
        assert res["launch_train"] == [0, 2, 0]
    store_dir = world["tmp"] / "launch_ckpt"
    assert sorted(os.listdir(store_dir)) == [
        "step_00000001", "step_00000002", "step_00000003"]


def test_launcher_production_mesh_needs_256(world):
    for res in world["gloo"]:
        assert res["launch"].startswith(
            "RuntimeError: mesh (16, 16) needs 256 devices, found 8"), res["launch"]
