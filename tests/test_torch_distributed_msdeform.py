"""The port's band-sharded MSDeformAttn (halo exchange) against the JAX
reference (counterpart of tests/test_distributed_msdeform.py).

The port's ranks are 4 gloo processes on the CPU (tests/torch_dist_ranks.py);
the reference's ``msdeform_attn_banded`` runs in a subprocess with 8
virtual CPU devices, as its own test runs it, but compiled at XLA's
backend optimization level 0: at the default level XLA's CPU backend
miscompiles the reference's halo branch, which its own test never takes
(``halo2`` then disagrees with the single-device oracle by up to 0.47;
eager, or at level 0, it agrees to 1e-6). The single-device oracle
(``msdeform_attn_apply`` on the padded pyramid) runs in this process.

Geometries (d_model 64, 4 heads, PAP top-8, B = 2, pyramid
((18, 20), (9, 10), (5, 5), (3, 3)), ranges (3, 2, 2, 1), offset weights
drawn so that offsets move with the query and hit the range clip):
  * ``gathered4``: the reference test's, 4 bands on a (data 1, model 4)
    mesh: rows 5/3/2/1 against halos 5/4/4/3, so every level takes the
    all-gather branch;
  * ``halo2``: 2 bands on a (data 2, model 2) mesh with the batch split
    over "data": rows 9/5/3/2, so levels 0 and 1 exchange halos.

Tolerances:
  * without INT12, against the single-device oracle: rtol = atol = 2e-4
    (the reference test's limit);
  * with INT12 (act_bits = weight_bits = 12), against the reference's
    banded layer: one INT12 step of the smallest band's value amax. The
    scales are band-local in both; a single-device scale would differ
    by more;
  * in-process ranks against gloo ranks: bitwise;
  * padding, reordering and geometry: exact.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import distributed_msdeform as RDM  # noqa: E402
from repro.core.encoder import encoder_logical_axes as r_enc_axes  # noqa: E402
from repro.core.msdeform_attn import MSDeformAttnConfig as RCfg  # noqa: E402
from repro.core.msdeform_attn import init_msdeform_attn as r_init  # noqa: E402
from repro.core.msdeform_attn import msdeform_attn_apply as r_apply  # noqa: E402
from repro.configs.detr_family import CONFIGS as R_DETR  # noqa: E402
from repro.distributed.sharding import logical_to_spec as r_to_spec  # noqa: E402
from repro.launch.detr_cells import _detr_rules as r_detr_rules  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.detr_family import CONFIGS, LEVEL_SHAPES  # noqa: E402
from repro_torch.core import distributed_msdeform as DM  # noqa: E402
from repro_torch.core.encoder import encoder_apply, init_encoder  # noqa: E402
from repro_torch.core.msdeform_attn import MSDeformAttnConfig  # noqa: E402
from repro_torch.core.quant import maybe_fake_quant, qmax  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.launch import detr_cells  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GEOM = ((18, 20), (9, 10), (5, 5), (3, 3))
RANGES = (3.0, 2.0, 2.0, 1.0)
D, H, B = 64, 4, 2
CASES = {                     # name: (bands, port mesh, batch axes)
    "gathered4": (4, (1, 4), ()),
    "halo2": (2, (2, 2), ("data",)),
}
ALL = [f"{n}{s}" for n in CASES for s in ("", "_int12")]

REF_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.msdeform_attn import MSDeformAttnConfig
from repro.core.distributed_msdeform import msdeform_attn_banded

inp = dict(np.load(sys.argv[1]))
devs = np.asarray(jax.devices())
assert len(devs) == 8
out = {}
for name, n_bands, mesh_shape, baxes in (
        ("gathered4", 4, (2, 4), ()), ("halo2", 2, (2, 2), ("data",))):
    mesh = Mesh(devs[:mesh_shape[0] * mesh_shape[1]].reshape(mesh_shape),
                ("data", "model"))
    cfg = MSDeformAttnConfig(d_model=64, n_heads=4, range_narrow=(3., 2., 2., 1.),
                             pap_mode="topk", pap_keep=8, act_bits=12,
                             weight_bits=12)
    prm = {k[2:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("p_")}
    padded = tuple(map(tuple, inp[name + "_padded"]))
    bspec = baxes[0] if baxes else None
    sh = NamedSharding(mesh, P(bspec, "model", None))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)
    with mesh:
        o = jax.jit(lambda p_, q_, r_, x_: msdeform_attn_banded(
            p_, cfg, q_, r_, x_, padded, mesh, batch_axes=baxes))(
            prm, put(inp[name + "_q"]), put(inp[name + "_refs"]),
            put(inp[name + "_x"]))
    out[name] = np.asarray(o)
np.savez(sys.argv[2], **out)
"""


def _cfg_kw(int12: bool):
    bits = 12 if int12 else None
    return dict(d_model=D, n_heads=H, range_narrow=RANGES, pap_mode="topk",
                pap_keep=8, act_bits=bits, weight_bits=bits)


def _params():
    """The reference's init with offset weights drawn from a numpy seed
    (its init zeroes them, which would make every offset constant)."""
    p = jax.tree.map(np.asarray, r_init(jax.random.PRNGKey(0), RCfg(**_cfg_kw(False))))
    p = dict(p)
    p["offs_w"] = (np.random.RandomState(5).randn(*p["offs_w"].shape)
                   * 0.1).astype(np.float32)
    return p


def _case_inputs(name):
    """Band-major (q, refs, x) of a geometry, the padded shapes, and the
    level-major originals for the oracle."""
    n_bands = CASES[name][0]
    rs = np.random.RandomState(1)
    n_in = sum(h * w for h, w in GEOM)
    x = rs.randn(B, n_in, D).astype(np.float32)
    xp, padded = DM.pad_levels_to_bands(torch.from_numpy(x), GEOM, n_bands)
    n_pad = xp.shape[1]
    refs = []
    for hp, w in padded:
        ys, xs = np.meshgrid((np.arange(hp) + 0.5) / hp, (np.arange(w) + 0.5) / w,
                             indexing="ij")
        refs.append(np.stack([xs.reshape(-1), ys.reshape(-1)], 1))
    refs = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        np.concatenate(refs, 0).astype(np.float32)[None], (B, n_pad, 2))))
    q = torch.from_numpy(rs.randn(B, n_pad, D).astype(np.float32))
    qb, _, inv = DM.band_reorder(q, padded, n_bands)
    xb, _, _ = DM.band_reorder(xp, padded, n_bands)
    rb, _, _ = DM.band_reorder(refs, padded, n_bands)
    return dict(q=qb, refs=rb, x=xb, padded=padded, inv=inv,
                q_lm=q, refs_lm=refs, x_lm=xp, x_raw=x)


def _spec(batch_axes):
    return (batch_axes[0] if batch_axes else None, "model", None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("banded")
    params = _params()
    inputs = {n: _case_inputs(n) for n in CASES}
    npz = {f"p_{k}": v for k, v in params.items()}
    for n, c in inputs.items():
        npz.update({f"{n}_q": c["q"].numpy(), f"{n}_refs": c["refs"].numpy(),
                    f"{n}_x": c["x"].numpy(), f"{n}_padded": np.asarray(c["padded"])})
    np.savez(tmp / "in.npz", **npz)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8"
               " --xla_backend_optimization_level=0",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_SCRIPT), str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    tparams = params_from_numpy(params, device="cpu")
    try:
        cases = {}
        for name in ALL:
            base = name.replace("_int12", "")
            n_bands, mesh, baxes = CASES[base]
            c = inputs[base]
            cases[name] = dict(mesh=mesh, batch_axes=baxes,
                               cfg=_cfg_kw(name.endswith("_int12")),
                               params=tparams, q=c["q"], refs=c["refs"],
                               x=c["x"], padded_shapes=c["padded"])
        gloo = ranks.spawn(ranks.banded_ranks, 4, str(tmp / "ranks"),
                           {"cases": cases}, timeout=240)
        so, se = ref_proc.communicate(timeout=400)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    assert ref_proc.returncode == 0, f"reference failed:\n{so}\n{se}"
    return dict(params=params, tparams=tparams, inputs=inputs, cases=cases,
                gloo=gloo, ref=dict(np.load(tmp / "ref.npz")))


def _assemble(runs, name):
    """The gloo ranks' outputs as one band-major (B, N_pad, D) tensor."""
    case = runs["cases"][name]
    mesh = C.InProcessMesh(case["mesh"], ("data", "model"))
    parts = {r: runs["gloo"][r][name]["out"] for r in range(mesh.size)}
    q = case["q"]
    return C.assemble(parts, _spec(case["batch_axes"]), q.shape, mesh)


def _in_process(runs, name):
    case = runs["cases"][name]
    mesh = C.InProcessMesh(case["mesh"], ("data", "model"))
    return DM.msdeform_attn_banded(
        case["params"], MSDeformAttnConfig(**case["cfg"]), case["q"],
        case["refs"], case["x"], case["padded_shapes"], mesh,
        batch_axes=case["batch_axes"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_matches_single_device_oracle(runs, name):
    c = runs["inputs"][name]
    want, _ = r_apply(runs["params"], RCfg(**_cfg_kw(False)),
                      jnp.asarray(c["q_lm"].numpy()),
                      jnp.asarray(c["refs_lm"].numpy()),
                      jnp.asarray(c["x_lm"].numpy()), c["padded"])
    got = _assemble(runs, name)[:, torch.as_tensor(c["inv"])]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def _band_value_step(runs, name) -> float:
    """One INT12 step of the smallest band's value amax (the scale the
    banded layer quantizes the band's values on)."""
    case = runs["cases"][name]
    mesh = C.InProcessMesh(case["mesh"], ("data", "model"))
    sizes = C.mesh_shape(mesh)
    p = case["params"]
    w = maybe_fake_quant(p["value_w"], 12)
    steps = []
    for r in range(mesh.size):
        xl = case["x"][C.local_slices(_spec(case["batch_axes"]), case["x"].shape,
                                      sizes, mesh.coords(r))]
        v = torch.einsum("bnd,dhk->bnhk", xl, w) + p["value_b"]
        steps.append(float(v.abs().max()) / qmax(12))
    return min(steps)


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_int12_matches_reference_banded(runs, name):
    step = _band_value_step(runs, name + "_int12")
    got = _assemble(runs, name + "_int12")
    want = runs["ref"][name]
    err = np.abs(got.numpy() - want).max()
    assert err <= step, (err, step)
    # the band-local grid is not the image's: the single-device INT12
    # layer differs by more than the banded layers differ from each other
    c = runs["inputs"][name]
    single, _ = r_apply(runs["params"], RCfg(**_cfg_kw(True)),
                        jnp.asarray(c["q_lm"].numpy()),
                        jnp.asarray(c["refs_lm"].numpy()),
                        jnp.asarray(c["x_lm"].numpy()), c["padded"])
    gap = np.abs(got.numpy()[:, c["inv"]] - np.asarray(single)).max()
    assert gap > err, (gap, err)


@pytest.mark.parametrize("name", ALL)
def test_banded_in_process_equals_gloo_bitwise(runs, name):
    assert torch.equal(_in_process(runs, name), _assemble(runs, name))


@pytest.mark.parametrize("name,levels", [
    ("gathered4", [False] * 4), ("halo2", [True, True, False, False])])
def test_band_branches_of_the_test_geometries(runs, name, levels):
    padded = runs["inputs"][name]["padded"]
    n_bands = CASES[name][0]
    assert DM.halo_levels(padded, n_bands, RANGES) == levels
    assert DM.band_layout(padded, n_bands, RANGES) == \
        tuple(RDM.band_layout(padded, n_bands, RANGES)) or \
        list(DM.band_layout(padded, n_bands, RANGES)) == \
        list(RDM.band_layout(padded, n_bands, RANGES))


@pytest.mark.parametrize("n_bands,rows,levels", [
    (2, [50, 25, 13, 7], [True] * 4),
    (4, [25, 13, 7, 4], [True, False, False, False])])
def test_full_width_band_branches(n_bands, rows, levels):
    ranges = CONFIGS["deformable-detr-defa"].encoder.attn.range_narrow
    padded, _ = detr_cells.padded_geometry(LEVEL_SHAPES, n_bands, ranges)
    assert DM.band_layout(LEVEL_SHAPES, n_bands, ranges) == \
        (rows, [18, 14, 10, 6])
    assert DM.halo_levels(padded, n_bands, ranges) == levels


def test_comm_bytes_counted_from_the_collectives(runs):
    """What each gloo rank handed to the collectives equals the
    reference's formula: 2·Σ halo_l·W_l·D over halo levels plus its band
    of each gathered level, per image, times its images and item size."""
    ranges = CONFIGS["deformable-detr-defa"].encoder.attn.range_narrow
    padded2, _ = detr_cells.padded_geometry(LEVEL_SHAPES, 2, ranges)
    assert DM.band_comm_pixels(padded2, 2, ranges) == 9456
    for name, (n_bands, mesh, baxes) in CASES.items():
        padded = runs["inputs"][name]["padded"]
        b_local = B // (mesh[0] if baxes else 1)
        want = DM.band_comm_pixels(padded, n_bands, RANGES) * D * 4 * b_local
        for res in runs["gloo"]:
            assert sum(res[name]["sent"].values()) == want


def test_pad_and_reorder_match_reference():
    x = np.random.RandomState(2).randn(B, sum(h * w for h, w in GEOM), 8) \
        .astype(np.float32)
    for n_bands in (2, 4):
        rp, rshapes = RDM.pad_levels_to_bands(jnp.asarray(x), GEOM, n_bands)
        tp, tshapes = DM.pad_levels_to_bands(torch.from_numpy(x), GEOM, n_bands)
        assert tshapes == rshapes
        np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
        rb, rperm, rinv = RDM.band_reorder(rp, rshapes, n_bands)
        tb, perm, inv = DM.band_reorder(tp, tshapes, n_bands)
        np.testing.assert_array_equal(perm, rperm)
        np.testing.assert_array_equal(inv, rinv)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
        refs = detr_cells.band_major_refs(tshapes, n_bands, 1)[0]
        lm = []
        for hp, w in tshapes:
            ys, xs = np.meshgrid((np.arange(hp) + 0.5) / hp,
                                 (np.arange(w) + 0.5) / w, indexing="ij")
            lm.append(np.stack([xs.reshape(-1), ys.reshape(-1)], 1))
        np.testing.assert_array_equal(
            refs.numpy(), np.concatenate(lm, 0).astype(np.float32)[perm])


def test_detr_rules_and_encoder_specs_match_reference():
    rcfg = R_DETR["deformable-detr-defa"].encoder
    want = jax.tree.map(lambda a: tuple(r_to_spec(a, r_detr_rules(None))),
                        r_enc_axes(rcfg),
                        is_leaf=lambda x: isinstance(x, tuple))
    mesh = C.InProcessMesh((1, 2), ("data", "model"))
    stack = detr_cells.build_banded_detr_stack("deformable-detr-defa", mesh, 2)
    got = jax.tree.map(tuple, stack.param_specs,
                       is_leaf=lambda x: isinstance(x, tuple))
    assert got == want
    assert stack.attn_cfg.fwp_mode == "off"


def test_banded_stack_matches_single_card_encoder():
    """One full-width block (the 800 x 1333 pyramid, d_model 256, 8 heads,
    PAP top-4, ranges (16, 12, 8, 4)) in float32 without INT12, on 2
    in-process bands, against the single-device encoder (torch_gather,
    FWP off) on the same padded pyramid: 2e-4."""
    enc = CONFIGS["deformable-detr-defa"].encoder
    attn = dataclasses.replace(enc.attn, act_bits=None, weight_bits=None,
                               dtype=torch.float32, fwp_mode="off")
    enc = dataclasses.replace(enc, attn=attn, n_blocks=1, dtype=torch.float32)
    mesh = C.InProcessMesh((1, 2), ("data", "model"))
    stack = detr_cells.build_banded_detr_stack("deformable-detr-defa", mesh, 1,
                                               enc_cfg=enc)
    gen = torch.Generator().manual_seed(0)
    params = init_encoder(enc, gen, device="cpu")
    blk = params["blocks"][0]["attn"]
    blk["offs_w"] = torch.randn(blk["offs_w"].shape, generator=gen) * 0.05
    n_in = sum(h * w for h, w in LEVEL_SHAPES)
    x = torch.randn((1, n_in, 256), generator=gen)
    xp, padded = DM.pad_levels_to_bands(x, LEVEL_SHAPES, 2)
    assert padded == stack.padded_shapes
    pos = torch.randn((stack.n_pad, 256), generator=gen) * 0.1
    refs = detr_cells.band_major_refs(padded, 2, 1)
    xb, perm, inv = DM.band_reorder(xp, padded, 2)
    stats = C.CommStats()
    got = stack.fn(params, xb, pos, refs, stats)[:, torch.as_tensor(inv)]
    want, _ = encoder_apply(params, enc, xp, pos[torch.as_tensor(inv)],
                            refs[:, torch.as_tensor(inv)], padded,
                            backend="torch_gather")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    # one block, one image: each band sends 9,456 pixel rows of 256 floats
    assert stats.rank_bytes(0) == stats.rank_bytes(1) == 9456 * 256 * 4


BF16_GEOM = ((8, 10), (4, 5), (2, 3), (1, 2))


@pytest.mark.parametrize("bits", [12, None])
def test_bf16_encoder_with_float32_refs_matches_reference(bits):
    """bf16 blocks with float32 reference points (the banded cell's
    inputs): the reference promotes to float32 after the first attention
    (``jnp`` promotion in ``nn.linear``, ``nn.layer_norm`` and the
    projections), and so does the port. Two blocks, d_model 64, PAP top-8,
    against the reference's ``encoder_apply`` (jnp_gather). The first
    block runs in bf16, where the two round products in other orders and
    a rounding can flip a PAP pick: the median |error| at most 2^-9 (a
    quarter of a bf16 step at 1) and the max at most 2^-3 (outputs are
    LayerNorm'd, |out| up to ~4)."""
    from repro.core.encoder import EncoderConfig as REnc
    from repro.core.encoder import encoder_apply as r_encoder_apply
    from repro.core.encoder import init_encoder as r_init_encoder
    from repro_torch.core.encoder import EncoderConfig
    kw = dict(_cfg_kw(False), act_bits=bits, weight_bits=bits)
    rcfg = REnc(attn=RCfg(**kw, dtype=jnp.bfloat16), n_blocks=2, d_ffn=128,
                dtype=jnp.bfloat16)
    cfg = EncoderConfig(attn=MSDeformAttnConfig(**kw, dtype=torch.bfloat16),
                        n_blocks=2, d_ffn=128, dtype=torch.bfloat16)
    rparams = r_init_encoder(jax.random.PRNGKey(3), rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    assert params["blocks"][0]["ln1"]["scale"].dtype == torch.bfloat16
    n = sum(h * w for h, w in BF16_GEOM)
    rs = np.random.RandomState(4)
    x = rs.randn(2, n, D).astype(np.float32)
    pos = (rs.randn(n, D) * 0.1).astype(np.float32)
    refs = rs.rand(2, n, 2).astype(np.float32)
    want, _ = r_encoder_apply(rparams, rcfg, jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(pos, jnp.bfloat16), jnp.asarray(refs),
                              BF16_GEOM, backend="jnp_gather")
    got, _ = encoder_apply(params, cfg, torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(pos).to(torch.bfloat16),
                           torch.from_numpy(refs), BF16_GEOM,
                           backend="torch_gather")
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(want))
    assert np.median(err) <= 2.0 ** -9, np.median(err)
    assert err.max() <= 2.0 ** -3, err.max()


def test_bf16_int12_banded_stack_matches_single_card_encoder():
    """The bf16 INT12 banded stack (2 in-process bands, two blocks, d_model
    64) against the single-card ``encoder_apply`` on the same padded
    pyramid with float32 reference points, within chip_smoke.py's limits
    for the full-width stack: the median at most 8 bf16 steps of each
    output, the max |error| under 1.0. The two differ by band-local INT12
    scales and by the single card's float32 promotion."""
    from repro_torch.core.encoder import EncoderConfig
    kw = dict(_cfg_kw(True), range_narrow=(3.0, 2.0, 2.0, 1.0))
    enc = EncoderConfig(attn=MSDeformAttnConfig(**kw, dtype=torch.bfloat16),
                        n_blocks=2, d_ffn=128, dtype=torch.bfloat16)
    mesh = C.InProcessMesh((1, 2), ("data", "model"))
    stack = detr_cells.build_banded_detr_stack(
        "deformable-detr-defa", mesh, B, enc_cfg=enc, level_shapes=GEOM)
    gen = torch.Generator().manual_seed(6)
    params = init_encoder(enc, gen, device="cpu")
    for blk in params["blocks"]:
        a = blk["attn"]
        a["offs_w"] = (torch.randn(a["offs_w"].shape, generator=gen)
                       * 0.1).to(torch.bfloat16)
    x = torch.randn((B, sum(h * w for h, w in GEOM), D), generator=gen)
    xp, padded = DM.pad_levels_to_bands(x.to(torch.bfloat16), GEOM, 2)
    assert padded == stack.padded_shapes
    pos = (torch.randn((stack.n_pad, D), generator=gen) * 0.1).to(torch.bfloat16)
    refs = detr_cells.band_major_refs(padded, 2, B)
    xb, _, inv = DM.band_reorder(xp, padded, 2)
    inv = torch.as_tensor(inv)
    got = stack.fn(params, xb, pos, refs)[:, inv]
    want, _ = encoder_apply(params, dataclasses.replace(enc, attn=stack.attn_cfg),
                            xp, pos[inv], refs[:, inv], padded,
                            backend="torch_gather")
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    err = (got.float() - want).abs()
    steps = err / torch.exp2(torch.floor(torch.log2(
        want.abs().clamp(min=2 ** -100))) - 7)
    assert float(steps.median()) <= 8, float(steps.median())
    assert float(err.max()) < 1.0, float(err.max())
