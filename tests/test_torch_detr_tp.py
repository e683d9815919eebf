"""The DETR serve and train cells on model-axis shards: the port's rank
bodies (``launch.detr_cells.build_detr_cell``: ``core.encoder.encoder_body``
under ``act_sharding.tensor_parallel``, each rank on its columns of
``ffn1`` and rows of ``ffn2``, the 8 attention heads whole) against the
port's one-device encoder and the reference's jitted cells.

Configs, at ``SMALL_LEVELS`` (850 queries, B = 2) in float32 with
``DETR_CONFIGS`` patched as ``tests/test_torch_dryrun.py`` patches it:

  * ``baseline``: deformable-detr, 2 blocks, on (data, model) = (1, 2),
    (1, 4) and (2, 2);
  * ``defa``: deformable-detr-defa (PAP, FWP, range narrowing, INT12), 1
    block, on (1, 2), (1, 4), (2, 1) and (2, 2). One block, because a
    later block amplifies the FFN's float32 sum order through INT12
    rounding and PAP / FWP choices (2 blocks: 7e-5 of the largest output
    at (1, 4)). On a data split each rank quantizes its images on the
    scale of the whole batch (``act_sharding.batch_max``: one max over
    the data axes), as the reference's partitioner does;
    ``test_defa_int12_scale_is_the_whole_batchs`` holds one block at
    (2, 2) to 1e-5 of the largest output and shows that a scale of the
    rank's own images lies far outside it.

Checks:

  * serve: the ranks' outputs, assembled, against ``encoder_apply`` on
    one device and the reference's cell (``repro.launch.detr_cells``)
    jitted on 8 virtual CPU devices in a subprocess, the same parameters
    (the reference's init from one key) crossing through
    ``bridge.params_from_numpy``: atol 1e-5 x the largest |output|.
    ``defa`` against the reference: median |error| 1e-5 and max 2e-3 of
    the largest |value| (``tests/test_torch_model.py``'s DEFA rule): the
    port's own one-device DEFA encoder lies 3e-4 (6.7e-5 of the largest
    |output|) from the reference's on 325 of 435,200 outputs, where an
    INT12 rounding lands on the other side of a boundary in another
    float32 order, and the ranks add nothing to that;
  * train: the ranks' gradients (``train.step.grads_rank_body`` over the
    cell's ``loss_body``), assembled, against one device's autograd
    through ``encoder_apply``: atol 1e-5 x the leaf's largest |g|; after
    the cell's step the AdamW moments against the reference's cell's,
    1e-5 x the leaf's largest |m| or |v|, the loss rtol 1e-5; the new
    parameters held to AdamW of the old ones with those moments, as
    ``tests/test_torch_tp_train.py`` holds them;
  * ``CommStats`` at (1, 4): serve asks for one (B, N, D) float32
    model-axis sum per block and nothing else; the train step adds one
    backward sum per block (Megatron's copy into the FFN), the squared
    norm's scalar and the ZeRO-1 gathers of the updated slices, and its
    gradient half gathers nothing;
  * the fake run at (1, 4): no all-gather over the model axis (train:
    only the ZeRO-1 gathers), FLOPs per rank those of one rank less
    3/4 of the FFN's.
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

import numpy as np  # noqa: E402

from repro.configs.detr_family import CONFIGS as R_CONFIGS  # noqa: E402
from repro.core.encoder import init_encoder as r_init_encoder  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.encoder import encoder_apply  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.sharding import tree_map as spec_map  # noqa: E402
from repro_torch.launch import detr_cells, dryrun  # noqa: E402
from repro_torch.optim.adamw import (OptConfig, adamw_init, lr_at,  # noqa: E402
                                     tree_leaves, tree_map)
from repro_torch.train.step import (_extra_spec, grads_rank_body,  # noqa: E402
                                    leaf_paths, spec_leaves)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_LEVELS = ((40, 16), (20, 8), (10, 4), (5, 2))
N = sum(h * w for h, w in SMALL_LEVELS)
B = 2
CONFIGS = {"baseline": ("deformable-detr", 2), "defa": ("deformable-detr-defa", 1)}
CASES = [("baseline", (1, 2)), ("baseline", (1, 4)), ("baseline", (2, 2)),
         ("defa", (1, 2)), ("defa", (1, 4)), ("defa", (2, 1)),
         ("defa", (2, 2))]
IDS = [f"{c}-{d}x{t}" for c, (d, t) in CASES]

# the reference's serve and train cells on 8 virtual devices, per case;
# params from the same key as the test's, inputs from an npz
REF_SCRIPT = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core.encoder import init_encoder
from repro.launch import detr_cells as RD
from repro.optim.adamw import adamw_init

inp = dict(np.load(sys.argv[1]))
meta = json.load(open(sys.argv[2]))
devs = np.asarray(jax.devices())
assert len(devs) == 8
out = {}

def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)

fast = {"xla_backend_optimization_level": 0}
for which, (d, t) in meta["cases"]:
    name, n_blocks = meta["configs"][which]
    acfg = RD.DETR_CONFIGS[name]
    enc = acfg.encoder
    enc = dataclasses.replace(enc, n_blocks=n_blocks, dtype=jnp.float32,
                              attn=dataclasses.replace(enc.attn,
                                                       dtype=jnp.float32))
    RD.DETR_CONFIGS[name] = dataclasses.replace(
        acfg, level_shapes=tuple(map(tuple, meta["levels"])), serve_batch=meta["b"],
        train_batch=meta["b"], encoder=enc)
    params = init_encoder(jax.random.PRNGKey(meta["keys"][which]), enc)
    x, pos, refs = (jnp.asarray(inp[f"{which}/{k}"]) for k in ("x", "pos", "refs"))
    mesh = Mesh(devs[:d * t].reshape(d, t), ("data", "model"))
    tag = f"{which}/{d}x{t}"
    serve = RD.build_detr_cell(name, "serve", mesh)
    train = RD.build_detr_cell(name, "train", mesh)
    with mesh:
        f = jax.jit(serve.fn, in_shardings=serve.in_shardings,
                    out_shardings=serve.out_shardings, compiler_options=fast)
        out[f"{tag}/serve"] = np.asarray(f(params, x, pos, refs))
        g = jax.jit(train.fn, in_shardings=train.in_shardings,
                    out_shardings=train.out_shardings, compiler_options=fast)
        new_p, new_opt, loss = g(params, adamw_init(params), x, pos, refs)
    for part, tree in (("m", new_opt["m"]), ("v", new_opt["v"])):
        for key, v in flat(tree, f"{tag}/{part}"):
            out[key] = v
    out[f"{tag}/loss"] = np.asarray(loss)
np.savez(sys.argv[3], **out)
"""

is_t = lambda x: isinstance(x, torch.Tensor)


def _key(which):
    return sorted(CONFIGS).index(which)


def _patch(monkeypatch, which):
    """The port's DETR_CONFIGS entry at the small pyramid, in float32."""
    name, n_blocks = CONFIGS[which]
    acfg = detr_cells.DETR_CONFIGS[name]
    enc = acfg.encoder
    enc = dataclasses.replace(enc, n_blocks=n_blocks, dtype=torch.float32,
                              attn=dataclasses.replace(enc.attn,
                                                       dtype=torch.float32))
    acfg = dataclasses.replace(acfg, level_shapes=SMALL_LEVELS, serve_batch=B,
                               train_batch=B, encoder=enc)
    monkeypatch.setitem(detr_cells.DETR_CONFIGS, name, acfg)
    return name, enc


def _inputs(which):
    """Params (the reference's init, crossed to the port) and the
    pyramid, positions and reference points, from seeds."""
    name, n_blocks = CONFIGS[which]
    import jax.numpy as jnp
    renc = R_CONFIGS[name].encoder
    renc = dataclasses.replace(renc, n_blocks=n_blocks, dtype=jnp.float32,
                               attn=dataclasses.replace(renc.attn,
                                                        dtype=jnp.float32))
    rparams = jax.tree.map(np.asarray, r_init_encoder(
        jax.random.PRNGKey(_key(which)), renc))
    rng = np.random.RandomState(11 + _key(which))
    d = renc.attn.d_model
    arrays = {"x": rng.randn(B, N, d).astype(np.float32),
              "pos": (0.1 * rng.randn(N, d)).astype(np.float32),
              "refs": rng.uniform(0.02, 0.98, (N, 2)).astype(np.float32)}
    return params_from_numpy(rparams, device="cpu"), arrays


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference subprocess, and the port's inputs meanwhile."""
    tmp = tmp_path_factory.mktemp("detr_tp")
    data, npz = {}, {}
    for which in CONFIGS:
        params, arrays = _inputs(which)
        data[which] = (params, {k: torch.from_numpy(v) for k, v in arrays.items()})
        npz.update({f"{which}/{k}": v for k, v in arrays.items()})
    np.savez(tmp / "in.npz", **npz)
    (tmp / "meta.json").write_text(json.dumps(
        {"configs": CONFIGS, "cases": CASES, "levels": SMALL_LEVELS, "b": B,
         "keys": {w: _key(w) for w in CONFIGS}}))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp / "in.npz"),
         str(tmp / "meta.json"), str(tmp / "ref.npz")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        so, se = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{so}\n{se}"
    return dict(data=data, ref=dict(np.load(tmp / "ref.npz")))


def _local(tree, specs, ctx):
    return spec_map(lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size,
                                                   ctx.index)].clone(),
                    tree, specs, is_leaf=is_t)


def _run(cell, mesh, inputs, stats=None, grad=False):
    """Every rank's body in turn on its slices: (outputs, rank inputs)."""
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


def _close_ref(which, got, want, scale):
    """Against the reference's cell: 1e-5 of ``scale``; DEFA's INT12
    rounding flips held by the median and a looser max (see the module
    docstring)."""
    if which != "defa":
        return _close(got, want, scale)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    scale = max(float(scale), 1e-30)
    assert np.median(err) <= 1e-5 * scale and err.max() <= 2e-3 * scale, \
        (np.median(err) / scale, err.max() / scale)


def _batch(arrays):
    return (arrays["x"], arrays["pos"], arrays["refs"])


def _one_device_grads(params, enc, arrays):
    """The rolled-target MSE through ``encoder_apply`` (torch_gather) and
    its gradients, on one device."""
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    with torch.enable_grad():
        out, _ = encoder_apply(live, enc, *_batch(arrays), SMALL_LEVELS,
                               backend="torch_gather")
        tgt = torch.roll(arrays["x"], 1, dims=1)
        loss = torch.mean(torch.square(out - tgt))
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), grads


@pytest.mark.parametrize("which,mesh_shape", CASES, ids=IDS)
def test_serve_cell_matches_one_device_and_reference(world, which, mesh_shape,
                                                     monkeypatch):
    name, enc = _patch(monkeypatch, which)
    params, arrays = world["data"][which]
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    cell = detr_cells.build_detr_cell(name, "serve", mesh)
    outs, _ = _run(cell, mesh, (params,) + _batch(arrays))
    got = C.assemble(dict(enumerate(outs)), cell.in_shardings[1], (B, N, 256),
                     mesh)
    with torch.no_grad():
        want, _ = encoder_apply(params, enc, *_batch(arrays), SMALL_LEVELS)
    scale = want.abs().max()
    _close(got, want, scale)
    _close_ref(which, got,
               world["ref"][f"{which}/{mesh_shape[0]}x{mesh_shape[1]}/serve"],
               scale)


@pytest.mark.parametrize("which,mesh_shape", CASES, ids=IDS)
def test_train_cell_matches_one_device_and_reference(world, which, mesh_shape,
                                                     monkeypatch):
    name, enc = _patch(monkeypatch, which)
    params, arrays = world["data"][which]
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    cell = detr_cells.build_detr_cell(name, "train", mesh)
    p_specs = cell.in_shardings[0]
    loss1, grads1 = _one_device_grads(params, enc, arrays)
    # the gradient half on the ranks' shards
    body = grads_rank_body(enc, p_specs, _train_api(enc))
    batch = dict(zip(("x", "pos", "refs"), _batch(arrays)))
    b_specs = dict(zip(("x", "pos", "refs"), cell.in_shardings[2:]))
    with torch.enable_grad():
        outs = C.run_in_process(lambda r, ctx: body(
            ctx, _local(params, p_specs, ctx), _local(batch, b_specs, ctx)),
            mesh)
    for i, (want, sp) in enumerate(zip(grads1, spec_leaves(p_specs))):
        got = C.assemble({r: tree_leaves(o[2])[i] for r, o in enumerate(outs)},
                         sp, want.shape, mesh)
        _close(got, want, want.abs().max())
    # the cell's step
    opt = adamw_init(params)
    outs, _ = _run(cell, mesh, (params, opt) + _batch(arrays), grad=True)
    tag = f"{which}/{mesh_shape[0]}x{mesh_shape[1]}"
    ref = world["ref"]
    for o in outs:
        np.testing.assert_allclose(float(o[2]), float(loss1), rtol=1e-5)
        _close_ref(which, float(o[2]), float(ref[f"{tag}/loss"]),
                   float(ref[f"{tag}/loss"]))
    m_specs = spec_leaves(cell.in_shardings[1]["m"])
    new = {}
    for part, idx in (("p", 0), ("m", 1), ("v", 1)):
        specs = spec_leaves(p_specs) if part == "p" else m_specs
        new[part] = [C.assemble(
            {r: tree_leaves(o[idx] if part == "p" else o[idx][part])[i]
             for r, o in enumerate(outs)}, sp, full.shape, mesh)
            for i, (full, sp) in enumerate(zip(tree_leaves(params), specs))]
    for part in ("m", "v"):
        for path, got in zip(leaf_paths(params), new[part]):
            want = ref[f"{tag}/{part}/{path}"]
            _close_ref(which, got, want, np.abs(want).max())
    cfg = OptConfig()
    lr = float(lr_at(cfg, torch.ones((), dtype=torch.int32)))  # after 1 step
    b1c, b2c = 1 - cfg.beta1, 1 - cfg.beta2
    for p, m, v, got in zip(tree_leaves(params), new["m"], new["v"], new["p"]):
        want = p.double() - lr * ((m.double() / b1c) / (
            (v.double() / b2c).sqrt() + cfg.eps) + cfg.weight_decay * p)
        _close(got, want, want.abs().max(), 1e-6)


def test_defa_int12_scale_is_the_whole_batchs(world, monkeypatch):
    """One DEFA block at (data, model) = (2, 2): within 1e-5 of the
    largest output of ``encoder_apply`` on the whole batch; with each
    rank's INT12 scales taken over its own image only (``batch_max``
    made the identity), more than 1e-3 away."""
    import contextlib
    from repro_torch.distributed import act_sharding as acts
    name, enc = _patch(monkeypatch, "defa")
    params, arrays = world["data"]["defa"]
    mesh = C.InProcessMesh((2, 2), ("data", "model"))
    with torch.no_grad():
        want, _ = encoder_apply(params, enc, *_batch(arrays), SMALL_LEVELS)
    scale = float(want.abs().max())

    def error():
        cell = detr_cells.build_detr_cell(name, "serve", mesh)
        outs, _ = _run(cell, mesh, (params,) + _batch(arrays))
        got = C.assemble(dict(enumerate(outs)), cell.in_shardings[1],
                         (B, N, 256), mesh)
        return float((got - want).abs().max()) / scale
    assert error() <= 1e-5
    monkeypatch.setattr(acts, "batch_split",
                        lambda ctx: contextlib.nullcontext())
    assert error() > 1e-3


def _train_api(enc):
    """The train cell's objective as a ``ModelAPI`` with only its
    ``loss_body``."""
    from repro_torch.models.registry import ModelAPI
    return ModelAPI(*(None,) * len(ModelAPI._fields))._replace(
        loss_body=detr_cells._loss_body(enc, SMALL_LEVELS))


def _zero_gather_bytes(cell, rank_inputs) -> int:
    """Bytes a rank gathers back into the parameters' layout after AdamW:
    its moment slice of each leaf whose ``zero_spec`` adds an axis."""
    p_specs, o_specs = cell.in_shardings[0], cell.in_shardings[1]
    return sum(m.numel() * m.element_size() for m, ps, ms in zip(
        tree_leaves(rank_inputs[1]["m"]), spec_leaves(p_specs),
        spec_leaves(o_specs["m"])) if any(_extra_spec(ps, ms)))


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_comm_bytes_equal_the_formula(world, which, monkeypatch):
    name, enc = _patch(monkeypatch, which)
    params, arrays = world["data"][which]
    mesh = C.InProcessMesh((1, 4), ("data", "model"))
    row = B * N * enc.d_model * 4
    stats = C.CommStats()
    cell = detr_cells.build_detr_cell(name, "serve", mesh)
    _run(cell, mesh, (params,) + _batch(arrays), stats)
    for rank in range(4):
        assert stats.sent[rank] == {"sum": enc.n_blocks * row}
        assert stats.by_axis[rank] == {"sum": {"model": enc.n_blocks * row}}
    stats = C.CommStats()
    cell = detr_cells.build_detr_cell(name, "train", mesh)
    _, mine = _run(cell, mesh, (params, adamw_init(params)) + _batch(arrays),
                   stats, grad=True)
    for rank in range(4):
        assert stats.backward[rank] == {"sum": enc.n_blocks * row}
        assert stats.sent[rank] == {
            "sum": 2 * enc.n_blocks * row + 4,
            "all_gather": _zero_gather_bytes(cell, mine[rank])}
    # the gradient half asks for no gather at all
    stats = C.CommStats()
    body = grads_rank_body(enc, cell.in_shardings[0], _train_api(enc))
    batch = dict(zip(("x", "pos", "refs"), _batch(arrays)))
    b_specs = dict(zip(("x", "pos", "refs"), cell.in_shardings[2:]))
    with torch.enable_grad():
        C.run_in_process(lambda r, ctx: body(
            ctx, _local(params, cell.in_shardings[0], ctx),
            _local(batch, b_specs, ctx)), mesh, stats)
    assert all(set(stats.sent[r]) == {"sum"} for r in range(4))


def _ffn_flops(enc, b):
    """The encoder FFN's matmul FLOPs over ``b`` images."""
    return enc.n_blocks * 2 * (2 * b * N * enc.d_model * enc.d_ffn)


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_fake_run_asks_no_model_axis_gather(which, monkeypatch):
    name, enc = _patch(monkeypatch, which)
    mesh4 = ((1, 4), ("data", "model"))
    one = ((1, 1), ("data", "model"))
    serve = dryrun.run_fake(dryrun.detr_cell(name, "serve"), None,
                            device="cpu", mesh_shape=mesh4)
    whole = dryrun.run_fake(dryrun.detr_cell(name, "serve"), None,
                            device="cpu", mesh_shape=one)
    assert "all_gather" not in serve["collectives"]["requested"]
    assert serve["collectives"]["requested"]["sum"] == {
        "model": enc.n_blocks * B * N * enc.d_model * 4}
    assert serve["cost"]["flops"] == whole["cost"]["flops"] \
        - 3 * _ffn_flops(enc, B) // 4
    train = dryrun.run_fake(dryrun.detr_cell(name, "train"), None,
                            device="cpu", mesh_shape=mesh4)
    mesh = C.InProcessMesh(*mesh4)
    cell = detr_cells.build_detr_cell(name, "train", mesh)
    params, _ = _inputs(which)
    ctx = C.RankContext(mesh.coords(0), C.mesh_shape(mesh))
    rank0 = (None, _local(adamw_init(params), cell.in_shardings[1], ctx))
    assert train["collectives"]["requested"]["all_gather"] == {
        "model": _zero_gather_bytes(cell, rank0)}
