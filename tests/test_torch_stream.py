"""The port's streaming subsystem (``repro_torch/stream/``, the streaming
row updates of ``msda/cache.py`` and ``kernels/msgs_decode.py``, and
``StreamingDetrEngine``) against the reference's ``repro/stream/``.

Every property of ``tests/test_stream.py`` has a counterpart here, at its
sizes (``LEVELS``, ``D``, ``N_IN``), with inputs drawn from numpy seeds:

  * the port's own oracle: a streamed cache equals a from-scratch build
    of the same frame under the manager's current keep geometry, BITWISE
    (incremental, partial and admitted rows are computed by the same
    operations on the same inputs as the scratch build's rows); with
    ``delta_threshold=0`` and ``update_frac=1`` the incremental path
    reproduces a rebuild bitwise across a keep transition;
  * the tables are written in place: their addresses do not move from
    frame to frame;
  * parity across packages: both managers run the same frames and are fed
    the same frequencies through ``observe`` (so the keep geometry is
    compared exactly and no decoder's float decides it). Per frame: the
    same mode and dirty counts, equal ``pix2slot`` / ``keep_idx``, the
    value table, staged table and scale within rtol 1e-5 / atol 1e-6
    (float32), and int8 codes equal except at most 1e-4 of them (a code
    whose float32 projection sits within an ulp of a rounding tie may
    take the neighbouring code; at these sizes that allows none).

On the CPU ``cuda_decode`` runs K2's plain version; the card's kernel is
held on the streamed table by ``chip_smoke.py``'s ``stream`` phase."""
import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import msda as rmsda  # noqa: E402
from repro.core.msdeform_attn import MSDeformAttnConfig as RConfig  # noqa: E402
from repro.core.msdeform_attn import init_msdeform_attn  # noqa: E402
from repro.kernels import msgs_decode as rdecode  # noqa: E402
from repro.stream import StreamConfig as RStreamConfig  # noqa: E402
from repro.stream import TemporalCacheManager as RManager  # noqa: E402
from repro.stream import drifting_scene as r_drifting_scene  # noqa: E402
from repro.stream import tile_geometry as r_tile_geometry  # noqa: E402
from repro.stream.tiles import changed_tiles as r_changed_tiles  # noqa: E402
from repro_torch import msda  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import fwp as fwp_lib  # noqa: E402
from repro_torch.core.msdeform_attn import MSDeformAttnConfig  # noqa: E402
from repro_torch.kernels import msgs_decode  # noqa: E402
from repro_torch.msda.cache import (build_value_cache,  # noqa: E402
                                    scatter_table_rows)
from repro_torch.msda.pipeline import MSDAPipelineState  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.obs.validate import validate_jsonl  # noqa: E402
from repro_torch.serve import StreamingDetrEngine  # noqa: E402
from repro_torch.msda.autotune import plan_table_scope  # noqa: E402
from repro_torch.stream import (StreamConfig, TemporalCacheManager,  # noqa: E402
                                changed_tiles, drifting_scene, tile_geometry)

torch.set_num_threads(1)

LEVELS = ((8, 10), (4, 5), (2, 3))
N_IN = sum(h * w for h, w in LEVELS)
D = 32
REF_BACKEND = {"torch_gather": "jnp_gather", "cuda_decode": "pallas_decode"}


def _kw(**kw):
    base = dict(d_model=D, n_heads=4, n_levels=len(LEVELS),
                fwp_mode="compact", fwp_k=1.0, fwp_capacity=0.6,
                range_narrow=(4.0, 3.0, 2.0))
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _ref_params():
    """The reference's MSDA params (numpy): the value projection both
    managers share."""
    p = init_msdeform_attn(jax.random.PRNGKey(0), RConfig(**_kw()))
    return jax.tree.map(np.asarray, p)


def _vparams():
    p = _ref_params()
    return {k: p[k] for k in ("value_w", "value_b")}


def _mgr(cfg_kw=None, scfg=None, batch=2, backend="torch_gather",
         n_queries=16):
    cfg = MSDeformAttnConfig(**_kw(**(cfg_kw or {})))
    plan = msda.make_plan(cfg, LEVELS, backend=backend, n_queries=n_queries,
                          n_consumers=2)
    return TemporalCacheManager(plan, params_from_numpy(_vparams(), "cpu"),
                                scfg, batch=batch), plan


def _ref_mgr(cfg_kw=None, scfg=None, batch=2, backend="torch_gather",
             n_queries=16):
    cfg = RConfig(**_kw(**(cfg_kw or {})))
    plan = rmsda.make_plan(cfg, LEVELS, backend=REF_BACKEND[backend],
                           n_queries=n_queries, n_consumers=2)
    return RManager(plan, jax.tree.map(jnp.asarray, _vparams()),
                    RStreamConfig(**dataclasses.asdict(scfg)), batch=batch)


def _x(seed, batch=2):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, N_IN, D)).astype(np.float32))


def _scratch(mgr, plan, x):
    """A from-scratch build under the manager's CURRENT keep geometry."""
    return build_value_cache(mgr.params, plan, torch.as_tensor(x),
                             MSDAPipelineState(fwp=mgr.fwp))


def _assert_cache_equal(got, want):
    assert torch.equal(got.v, want.v)
    for name in ("pix2slot", "keep_idx", "scale"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert torch.equal(g, w), name
    assert (got.staged is None) == (want.staged is None)
    if want.staged is not None:
        assert torch.equal(got.staged.v, want.staged.v)
        assert (got.staged.remap is None) == (want.staged.remap is None)
        if want.staged.remap is not None:
            assert torch.equal(got.staged.remap, want.staged.remap)


def _addresses(cache):
    ts = (cache.v, cache.pix2slot, cache.keep_idx, cache.scale,
          None if cache.staged is None else cache.staged.v)
    return tuple(None if t is None else t.data_ptr() for t in ts)


def _flip_freq(seed, shape, level0_only=False):
    """Frequencies whose EMA moves the warm-start keep set: 10 or 0 at
    random, only inside level 0 (ones elsewhere) when asked."""
    rng = np.random.default_rng(seed)
    flip = np.where(rng.uniform(size=shape) > 0.5, 10.0, 0.0)
    if level0_only:
        h0w0 = LEVELS[0][0] * LEVELS[0][1]
        out = np.ones(shape)
        out[:, :h0w0] = flip[:, :h0w0]
        flip = out
    return flip.astype(np.float32)


# --------------------------------------------------------------------------
# tile geometry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tile_rows", [1, 2, 3])
def test_tile_geometry_row_aligned_partition_equals_reference(tile_rows):
    geo = tile_geometry(LEVELS, tile_rows=tile_rows)
    ref = r_tile_geometry(LEVELS, tile_rows=tile_rows)
    assert geo.n_in == N_IN and geo.n_tiles == ref.n_tiles
    for name in ("tile_of_pixel", "tile_level", "tile_pix_start",
                 "tile_pix_count"):
        np.testing.assert_array_equal(getattr(geo, name), getattr(ref, name))
    covered = np.zeros(N_IN, bool)
    for t in range(geo.n_tiles):
        lo = geo.tile_pix_start[t]
        hi = lo + geo.tile_pix_count[t]
        assert not covered[lo:hi].any()
        covered[lo:hi] = True
        np.testing.assert_array_equal(geo.tile_of_pixel[lo:hi], t)
        assert geo.tile_pix_count[t] % LEVELS[geo.tile_level[t]][1] == 0
    assert covered.all()
    with pytest.raises(ValueError):
        tile_geometry(LEVELS, tile_rows=0)


@pytest.mark.parametrize("threshold", [0.0, 0.3, 1e9])
def test_changed_tiles_equal_reference(threshold):
    x_ref = _x(1)
    x_new = x_ref.clone()
    x_new[0, 3:6] += 0.5
    x_new[1, 90:92, :4] -= 0.2
    geo, rgeo = tile_geometry(LEVELS, 2), r_tile_geometry(LEVELS, 2)
    got = changed_tiles(geo, x_new, x_ref, threshold)
    want = r_changed_tiles(rgeo, jnp.asarray(x_new.numpy()),
                           jnp.asarray(x_ref.numpy()), threshold)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# incremental parity (the port's own oracle) and in-place tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fwp_mode,backend", [
    ("compact", "torch_gather"), ("off", "torch_gather"),
    ("mask", "torch_gather"), ("compact", "cuda_decode")])
def test_incremental_tile_update_matches_scratch_build(fwp_mode, backend):
    mgr, plan = _mgr({"fwp_mode": fwp_mode},
                     StreamConfig(tile_rows=2, delta_threshold=1e-6,
                                  update_frac=0.5), backend=backend)
    x0 = _x(1)
    cache0, _ = mgr.step(x0)
    where = _addresses(cache0)
    x1 = x0.clone()
    x1[:, 3:6] += 0.5                            # one tile of level 0
    cache, st = mgr.step(x1)
    assert st["mode"] == "incremental", st
    assert st["n_dirty"] > 0
    _assert_cache_equal(cache, _scratch(mgr, plan, x1))
    assert _addresses(cache) == where            # written in place
    if backend == "cuda_decode":
        assert cache.staged is not None


def test_threshold0_parity_across_frames_with_keep_transition():
    """delta_threshold 0 marks every tile changed: across 5 frames,
    including a keep transition, the streamed cache equals a per-frame
    rebuild bitwise."""
    mgr, plan = _mgr(None, StreamConfig(tile_rows=2, delta_threshold=0.0,
                                        update_frac=1.0))
    base = _x(2)
    freq = _flip_freq(9, (2, N_IN))
    modes, transitions = [], 0
    for t in range(5):
        x = base + 0.1 * t * torch.sign(base)
        cache, st = mgr.step(x)
        modes.append(st["mode"])
        transitions += st["keep_transition"]
        _assert_cache_equal(cache, _scratch(mgr, plan, x))
        mgr.observe(freq)
    assert transitions >= 1, modes
    assert modes.count("incremental") >= 3, modes
    assert mgr.last_stats["mode"] == "incremental"


def test_over_budget_dirt_falls_back_to_rebuild():
    mgr, plan = _mgr(None, StreamConfig(tile_rows=2, delta_threshold=1e-6,
                                        update_frac=0.05))
    x0 = _x(3)
    mgr.step(x0)
    x1 = x0 + 1.0                                 # everything changes
    cache, st = mgr.step(x1)
    assert st["mode"] == "rebuild" and st["reason"] == "dirty>budget"
    _assert_cache_equal(cache, _scratch(mgr, plan, x1))


def test_subthreshold_drift_accumulates_against_last_projection():
    thr = 0.5
    mgr, _ = _mgr({"fwp_mode": "off"},
                  StreamConfig(tile_rows=2, delta_threshold=thr,
                               update_frac=1.0))
    x0 = _x(4)
    mgr.step(x0)
    x1 = x0.clone()
    x1[:, 0:3] += 0.3 * thr                       # below threshold
    _, st1 = mgr.step(x1)
    assert st1["mode"] == "incremental" and st1["n_dirty"] == 0
    x2 = x0.clone()
    x2[:, 0:3] += 1.2 * thr                       # cumulative drift crosses
    _, st2 = mgr.step(x2)
    assert st2["n_dirty"] > 0, st2


def test_frozen_scale_quant_keeps_table_grid_stable():
    """INT12: re-projecting unchanged rows against the frozen scale
    reproduces the table bitwise, and the frozen scale is the build's."""
    mgr, _ = _mgr({"act_bits": 12, "weight_bits": 12},
                  StreamConfig(tile_rows=2, delta_threshold=0.0,
                               update_frac=1.0))
    x0 = _x(5)
    cache0, _ = mgr.step(x0)
    v0 = cache0.v.clone()
    scale0 = mgr.act_scale.clone()
    cache1, st = mgr.step(x0)                     # same memory, all "dirty"
    assert st["mode"] == "incremental"
    assert torch.equal(cache1.v, v0)
    assert torch.equal(mgr.act_scale, scale0)


def test_probed_diff_detects_full_width_changes():
    mgr, plan = _mgr(None, StreamConfig(tile_rows=2, delta_threshold=1e-6,
                                        update_frac=0.5,
                                        diff_channel_stride=4))
    x0 = _x(6)
    mgr.step(x0)
    assert mgr.x_ref.shape == (2, N_IN, D // 4)
    x1 = x0.clone()
    x1[:, 3:6] += 0.5
    cache, st = mgr.step(x1)
    assert st["mode"] == "incremental" and st["n_dirty"] > 0
    _assert_cache_equal(cache, _scratch(mgr, plan, x1))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_update_staged_rows_matches_full_restage_in_place(dtype):
    """Writing a row subset into the staged layout equals restaging the
    updated table: bitwise, at the same address, equal to the
    reference's functional update; and K2 (its plain version on the
    CPU) gives bitwise the same output on both."""
    rng = np.random.default_rng(7)
    b, n_rows, h, dh, u = 2, 11, 4, 8, 5
    v = rng.normal(size=(b, n_rows, h, dh)).astype(np.float32)
    rows = rng.normal(size=(b, u, h, dh)).astype(np.float32)
    idx = np.stack([[0, 3, 4, 7, 10], [1, 2, 5, 8, 9]]).astype(np.int32)
    scale = None
    vt, rt = torch.from_numpy(v), torch.from_numpy(rows)
    if dtype == "int8":
        scale = torch.from_numpy(np.abs(v).max(axis=1, keepdims=True) / 127)
        vt = torch.clamp(torch.round(vt / scale), -128, 127).to(torch.int8)
        rt = torch.clamp(torch.round(rt / scale), -128, 127).to(torch.int8)
    staged = msgs_decode.stage_decode_table(vt, head_pack=2, scale=scale)
    where = staged.v.data_ptr()
    got = msgs_decode.update_staged_rows(staged, torch.from_numpy(idx), rt)
    assert got.v.data_ptr() == where and got is staged
    v2 = vt.clone()
    v2[torch.arange(b)[:, None], torch.from_numpy(idx).long()] = rt
    want = msgs_decode.stage_decode_table(v2, head_pack=2, scale=scale)
    assert torch.equal(got.v, want.v)
    ref = rdecode.update_staged_rows(
        rdecode.stage_decode_table(jnp.asarray(vt.numpy()), head_pack=2),
        jnp.asarray(idx), jnp.asarray(rt.numpy()))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(ref.v))
    # K2 on the updated table and on the fresh staging
    pts_rng = np.random.default_rng(8)
    nq, k = 6, 4
    x = torch.from_numpy(pts_rng.uniform(-1, 10, (b, nq, h, k))
                         .astype(np.float32))
    y = torch.from_numpy(pts_rng.uniform(-1, 3, (b, nq, h, k))
                         .astype(np.float32))
    zeros = torch.zeros((b, nq, h, k), dtype=torch.int32)
    wl, hl = zeros + n_rows, zeros + 1
    p = torch.from_numpy(pts_rng.uniform(0, 1, (b, nq, h, k))
                         .astype(np.float32))
    a = msgs_decode.msgs_decode(got, x, y, zeros, wl, hl, p)
    c = msgs_decode.msgs_decode(want, x, y, zeros, wl, hl, p)
    assert torch.equal(a, c)


# --------------------------------------------------------------------------
# staged-bytes accounting
# --------------------------------------------------------------------------

def test_drifting_scene_frames_equal_reference():
    levels = ((16, 20), (8, 10), (4, 5), (2, 3))
    got = drifting_scene(17, levels, 8, 5, batch=2, noise=0.01)
    want = r_drifting_scene(17, levels, 8, 5, batch=2, noise=0.01)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_drifting_scene_bytes_ratio_at_least_2x_and_equals_reference():
    """The reference's criterion (``benchmarks/fmap_reuse._stream_staged``
    at 32 frames): incremental updates stage at least 2x fewer bytes than
    per-frame rebuilds. Both managers run the same frames and are fed the
    same per-pixel feature magnitude (numpy) as sampling frequency; their
    reports are equal."""
    levels = ((16, 20), (8, 10), (4, 5), (2, 3))
    d = 64
    kw = dict(d_model=d, n_heads=4, fwp_mode="compact", fwp_capacity=0.6,
              range_narrow=(8.0, 6.0, 4.0, 3.0))
    rplan = rmsda.make_plan(RConfig(**kw), levels, backend="jnp_gather",
                            n_queries=32, n_consumers=6)
    plan = msda.make_plan(MSDeformAttnConfig(**kw), levels,
                          backend="torch_gather", n_queries=32, n_consumers=6)
    p = jax.tree.map(np.asarray,
                     init_msdeform_attn(jax.random.PRNGKey(11), RConfig(**kw)))
    vp = {k: p[k] for k in ("value_w", "value_b")}
    scfg = dict(tile_rows=1, delta_threshold=1e-4, update_frac=0.3)
    ref = RManager(rplan, jax.tree.map(jnp.asarray, vp),
                   RStreamConfig(**scfg), batch=1)
    mgr = TemporalCacheManager(plan, params_from_numpy(vp, "cpu"),
                               StreamConfig(**scfg), batch=1)
    for x in drifting_scene(17, levels, d, 32):
        freq = np.linalg.norm(x, axis=-1).astype(np.float32)
        _, st = mgr.step(x)
        _, rst = ref.step(jnp.asarray(x))
        assert (st["mode"], st["n_dirty"]) == (rst["mode"], rst["n_dirty"])
        mgr.observe(freq)
        ref.observe(jnp.asarray(freq))
    r = mgr.report()
    assert r == ref.report()
    assert r["bytes_ratio"] >= 2.0, r
    assert r["incremental_frames"] > r["rebuild_frames"], r


def test_frame_stats_and_pipeline_state_carry_stream_accounting():
    mgr, plan = _mgr(None, StreamConfig(tile_rows=2, delta_threshold=1e-6,
                                        update_frac=0.5))
    x0 = _x(8)
    _, st = mgr.step(x0)
    assert st["mode"] == "rebuild"
    assert st["staged_bytes"] == st["rebuild_bytes"] == mgr._full_bytes
    x1 = x0.clone()
    x1[:, 0:3] += 0.5
    _, st = mgr.step(x1)
    assert st["mode"] == "incremental"
    assert st["staged_bytes"] == plan.table_bytes_for_rows(
        mgr.update_rows, with_indirection=False)
    state = mgr.pipeline_state()
    assert state.stream is st and state.fwp is mgr.fwp
    assert state.advance(None, None).stream is st
    r = mgr.report()
    assert r["frames"] == 2 and r["rebuild_frames"] == 1
    assert r["staged_bytes_total"] == st["staged_bytes"] + mgr._full_bytes
    plan_s = dataclasses.replace(plan, stream_update_rows=mgr.update_rows)
    assert "stream<=" in plan_s.describe()
    snap = plan_s.snapshot()["stream"]
    assert snap["update_rows"] == mgr.update_rows
    assert snap["rebuild_bytes"] == plan.cache_table_bytes
    assert mgr.obs.metrics.value("stream_frames_total", mode="incremental") \
        == 1
    assert mgr.obs.metrics.value("stream_rebuilds_total",
                                 reason="first-frame") == 1


# --------------------------------------------------------------------------
# parity across packages, frame by frame
# --------------------------------------------------------------------------

def _assert_manager_parity(cache, st, mgr, rcache, rst, rmgr, table):
    for key in ("mode", "reason", "n_dirty", "tiles_changed",
                "keep_transition", "restaged_levels", "admitted_slots",
                "staged_bytes", "rebuild_bytes"):
        assert st[key] == rst[key], (key, st, rst)
    for name in ("pix2slot", "keep_idx"):
        g, w = getattr(cache, name), getattr(rcache, name)
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pairs = [(cache.v, rcache.v)]
    if rcache.staged is not None:
        pairs.append((cache.staged.v, rcache.staged.v))
        np.testing.assert_array_equal(cache.staged.remap.numpy(),
                                      np.asarray(rcache.staged.remap))
    if table == "int8":
        np.testing.assert_allclose(cache.scale.numpy(),
                                   np.asarray(rcache.scale), rtol=1e-5,
                                   atol=1e-6)
        for g, w in pairs:
            assert g.dtype == torch.int8
            off = int((g.numpy() != np.asarray(w)).sum())
            assert off <= 1e-4 * g.numel(), off
    else:
        for g, w in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_array_equal(mgr.x_ref.numpy(), np.asarray(rmgr.x_ref))
    if rmgr.fwp is not None:
        np.testing.assert_array_equal(mgr.fwp.keep_idx.numpy(),
                                      np.asarray(rmgr.fwp.keep_idx))
        np.testing.assert_array_equal(mgr.ema.numpy(), np.asarray(rmgr.ema))


@pytest.mark.parametrize("table", ["float32", "int8"])
@pytest.mark.parametrize("backend", ["torch_gather", "cuda_decode"])
def test_managers_agree_with_the_reference_frame_by_frame(backend, table):
    """Two sessions of drifting scenes, 10 frames, fed one set of
    frequencies per frame: mostly incremental frames, with level-0-only
    keep flips (partial restages) on frames 3 and 7 and a whole-table
    flip (rebuild) on frame 5."""
    scfg = StreamConfig(tile_rows=1, delta_threshold=1e-4, update_frac=0.5)
    kw = {"table_dtype": table}
    mgr, _ = _mgr(kw, scfg, backend=backend)
    rmgr = _ref_mgr(kw, scfg, backend=backend)
    scenes = [drifting_scene(s, LEVELS, D, 10)[:] for s in (1, 2)]
    modes = []
    for t in range(10):
        x = np.concatenate([scenes[0][t], scenes[1][t]])
        cache, st = mgr.step(x)
        rcache, rst = rmgr.step(jnp.asarray(x))
        _assert_manager_parity(cache, st, mgr, rcache, rst, rmgr, table)
        modes.append(st["mode"])
        if t in (2, 6):
            freq = _flip_freq(t, (2, N_IN), level0_only=True)
        elif t == 4:
            freq = _flip_freq(t, (2, N_IN))
        else:
            freq = np.linalg.norm(x, axis=-1).astype(np.float32)
        assert mgr.observe(freq) == rmgr.observe(jnp.asarray(freq))
    assert mgr.report() == rmgr.report()
    assert {"incremental", "partial", "rebuild"} <= set(modes), modes


# --------------------------------------------------------------------------
# decoder + engine
# --------------------------------------------------------------------------

def _decoder_setup():
    cfg = MSDeformAttnConfig(**_kw())
    dec_cfg = msda.MSDADecoderConfig(n_layers=2, n_queries=8, d_ffn=32)
    gen = torch.Generator().manual_seed(11)
    params = {
        "decoder": msda.init_decoder(dec_cfg, cfg, gen),
        "cls_head": {"w": torch.randn((D, 3), generator=gen) * 0.1,
                     "b": torch.zeros((3,))},
        "box_head": {"w": torch.randn((D, 4), generator=gen) * 0.1,
                     "b": torch.zeros((4,))},
    }
    return cfg, dec_cfg, params


def _engine(max_sessions=2, scfg=None, **kw):
    cfg, dec_cfg, params = _decoder_setup()
    scfg = scfg or StreamConfig(tile_rows=1, delta_threshold=1e-4,
                                update_frac=0.5)
    kw.setdefault("obs", Observability.disabled())
    return StreamingDetrEngine(cfg, dec_cfg, params, LEVELS,
                               max_sessions=max_sessions, stream_cfg=scfg,
                               device="cpu", **kw), dec_cfg


@pytest.mark.parametrize("backend", ["torch_gather", "cuda_decode"])
def test_decoder_apply_accepts_external_cache(backend):
    cfg, dec_cfg, params = _decoder_setup()
    plan = msda.make_plan(cfg, LEVELS, backend=backend,
                          n_queries=dec_cfg.n_queries,
                          n_consumers=dec_cfg.n_layers)
    memory = _x(12)
    h_int, refs_int, _ = msda.decoder_apply(params["decoder"], dec_cfg,
                                            plan, memory)
    cache = build_value_cache(params["decoder"]["value"], plan, memory)
    h_ext, refs_ext, dstate = msda.decoder_apply(
        params["decoder"], dec_cfg, plan, memory, cache=cache,
        state=MSDAPipelineState().with_stream({"mode": "incremental"}))
    assert torch.equal(h_int, h_ext) and torch.equal(refs_int, refs_ext)
    assert dstate.cache is cache
    assert dstate.stream == {"mode": "incremental"}


def test_streaming_engine_sessions_end_to_end():
    """The counterpart of the reference's
    tests/test_stream.py::test_streaming_engine_sessions_end_to_end, which
    fails in the reference itself: its last bound, staged bytes <= rebuild
    bytes, does not hold for the reference's own accounting here (a
    partial frame pays its restage plus the incremental budget: 138,872
    against 134,816 bytes). This test asserts every other assertion of
    that test, and holds the port's accounting to the reference's: the
    same frames through the reference's manager, fed the port engine's
    own frequencies, give the same report."""
    engine, dec_cfg = _engine(backend="cuda_decode")
    assert "streaming" in engine.describe()
    s0 = engine.open_session()
    s1 = engine.open_session()
    scenes = {s0: drifting_scene(1, LEVELS, D, 4),
              s1: drifting_scene(2, LEVELS, D, 4)}
    for t in range(4):
        for sid in (s0, s1):
            engine.submit_frame(sid, scenes[sid][t][0])
    rmgr = _ref_mgr(None, engine.mgr.scfg, backend="cuda_decode")
    observe = engine.mgr.observe

    def both_observe(freq):
        rmgr.step(jnp.asarray(np.stack(
            [scenes[s][engine.sessions[s].frames_done][0] for s in (s0, s1)])))
        rmgr.observe(jnp.asarray(freq.numpy()))
        return observe(freq)
    engine.mgr.observe = both_observe
    engine.run_until_drained()
    for sid in (s0, s1):
        sess = engine.close_session(sid)
        assert len(sess.results) == 4
        for res in sess.results:
            assert res["cls_probs"].shape == (dec_cfg.n_queries, 3)
            assert res["boxes"].shape == (dec_cfg.n_queries, 4)
            assert np.isfinite(res["boxes"]).all()
            assert res["stream"]["mode"] in ("rebuild", "incremental",
                                             "partial")
    r = engine.report()
    assert r["frames"] == 4
    assert r == rmgr.report()
    s2 = engine.open_session()
    assert engine.sessions[s2].slot in (0, 1)


def test_partial_restage_matches_scratch_build_in_place():
    for backend in ("torch_gather", "cuda_decode"):
        mgr, plan = _mgr(None, StreamConfig(tile_rows=2, delta_threshold=0.0,
                                            update_frac=1.0), backend=backend)
        x0 = _x(31)
        cache0, _ = mgr.step(x0)
        where = _addresses(cache0)
        mgr.observe(_flip_freq(32, (2, N_IN), level0_only=True))
        assert mgr._geometry_stale
        assert mgr._transition_levels() == (0,)
        x1 = x0 + 0.05 * torch.sign(x0)
        cache, st = mgr.step(x1)
        assert st["mode"] == "partial" and st["reason"] == "keep-transition"
        assert st["restaged_levels"] == (0,)
        _assert_cache_equal(cache, _scratch(mgr, plan, x1))
        assert _addresses(cache) == where
        assert mgr.report()["partial_frames"] == 1
        assert st["staged_bytes"] == plan.table_bytes_for_rows(
            mgr._slot_offs[1], with_indirection=False) \
            + LEVELS[0][0] * LEVELS[0][1] * 4 + mgr._incr_bytes


def test_whole_geometry_transition_still_rebuilds():
    mgr, _ = _mgr(None, StreamConfig(tile_rows=2, delta_threshold=0.0,
                                     update_frac=1.0))
    x0 = _x(32)
    mgr.step(x0)
    mgr.observe(_flip_freq(33, (2, N_IN)))
    assert mgr._geometry_stale
    assert mgr._transition_levels() is None
    _, st = mgr.step(x0)
    assert st["mode"] == "rebuild" and st["reason"] == "keep-transition"


def test_permute_slots_is_state_permutation():
    mk = lambda: _mgr(None, StreamConfig(tile_rows=2, delta_threshold=1e-6,
                                         update_frac=0.5),
                      backend="cuda_decode")[0]
    x0 = _x(33)
    x1 = x0.clone()
    x1[:, 3:6] += 0.5
    m_a = mk()
    m_a.step(x0)
    c_a, st_a = m_a.step(x1)
    m_b = mk()
    m_b.step(x0)
    m_b.permute_slots((1, 0))
    c_b, st_b = m_b.step(x1.flip(0))
    assert st_a["mode"] == st_b["mode"] == "incremental"
    assert torch.equal(c_b.v, c_a.v.flip(0))
    assert torch.equal(c_b.staged.v, c_a.staged.v.flip(0))
    assert torch.equal(c_b.staged.remap, c_a.staged.remap.flip(0))
    assert torch.equal(m_b.x_ref, m_a.x_ref.flip(0))
    with pytest.raises(ValueError):
        m_b.permute_slots((0, 0))
    with pytest.raises(ValueError):
        m_b.permute_slots((0, 1, 2))


def test_engine_reorder_sessions_never_drops_or_duplicates():
    """Sessions move to adjacent slots by centroid: the session set and the
    slot multiset are kept, every per-slot table after the move is the
    unmoved engine's table permuted (bitwise), and each session's next
    detections equal the unmoved engine's. On the CPU those are held to
    1e-6, not bitwise: a batch row's products change position inside the
    (B*Nq, D) matmuls, and the CPU BLAS rounds one row position
    differently from another (one box coordinate moves by one ulp here).
    ``chip_smoke.py`` holds them bitwise on the card."""
    engines = [_engine(max_sessions=3)[0] for _ in range(2)]
    sids = [[e.open_session() for _ in range(3)] for e in engines]
    scenes = [drifting_scene(seed, LEVELS, D, 3) for seed in (3, 2, 1)]
    for e, ss in zip(engines, sids):
        for t in range(2):
            for i, sid in enumerate(ss):
                e.submit_frame(sid, scenes[i][t][0])
        e.run_until_drained()
    engine = engines[0]
    before = {s.sid: s.slot for s in engine.sessions.values()}
    mapping = engine.reorder_sessions()
    assert set(mapping) == set(before)
    assert sorted(mapping.values()) == sorted(before.values())
    assert mapping != before          # these scenes do move
    for sid, slot in mapping.items():
        assert engine.sessions[sid].slot == slot
    perm = [None] * 3                  # new slot -> the other engine's slot
    for sid, slot in mapping.items():
        perm[slot] = engines[1].sessions[sid].slot
    moved, kept = engine.mgr, engines[1].mgr
    for name in ("v", "pix2slot", "keep_idx"):
        assert torch.equal(getattr(moved.cache, name),
                           getattr(kept.cache, name)[perm]), name
    assert torch.equal(moved.x_ref, kept.x_ref[perm])
    assert torch.equal(moved.ema, kept.ema[perm])
    assert torch.equal(moved.fwp.keep_idx, kept.fwp.keep_idx[perm])
    for e, ss in zip(engines, sids):
        for i, sid in enumerate(ss):
            e.submit_frame(sid, scenes[i][2][0])
        assert e.step() == 3
    for sid in sids[0]:
        a = engines[0].sessions[sid].results
        b = engines[1].sessions[sid].results
        assert len(a) == 3
        assert a[-1]["stream"]["mode"] == b[-1]["stream"]["mode"]
        for key in ("cls_probs", "boxes"):
            np.testing.assert_allclose(a[-1][key], b[-1][key], rtol=0,
                                       atol=1e-6)
    freed = engine.close_session(sids[0][0]).slot
    s_new = engine.open_session()
    assert engine.sessions[s_new].slot == freed


def test_engine_reorder_noop_cases():
    engine, _ = _engine()
    assert engine.reorder_sessions() == {}
    s0 = engine.open_session()
    assert engine.reorder_sessions() == {s0: engine.sessions[s0].slot}


# --------------------------------------------------------------------------
# int8 streaming, dtype guards, plan swap, admission
# --------------------------------------------------------------------------

def test_int8_stream_stays_int8_end_to_end():
    mgr, plan = _mgr({"table_dtype": "int8"},
                     StreamConfig(tile_rows=2, delta_threshold=1e-6,
                                  update_frac=0.5), backend="cuda_decode")
    assert plan.quantized_table
    x0 = _x(21)
    cache0, st0 = mgr.step(x0)
    assert st0["mode"] == "rebuild"
    assert cache0.v.dtype == torch.int8 and cache0.staged.v.dtype == torch.int8
    assert cache0.scale.dtype == torch.float32
    s0 = cache0.scale.clone()
    x1 = x0.clone()
    x1[:, 3:6] += 0.5
    cache1, st1 = mgr.step(x1)
    assert st1["mode"] == "incremental" and st1["n_dirty"] > 0
    assert cache1.v.dtype == torch.int8 and cache1.staged.v.dtype == torch.int8
    assert torch.equal(cache1.scale, s0)          # frozen
    v1 = cache1.v.clone()
    cache2, st2 = mgr.step(x1)
    assert st2["mode"] == "incremental"
    assert torch.equal(cache2.v, v1)
    assert mgr.report()["table_dtype"] == "int8"


def test_int8_scatter_and_staged_update_reject_dtype_drift():
    mgr, _ = _mgr({"table_dtype": "int8"},
                  StreamConfig(tile_rows=2, delta_threshold=1e-6,
                               update_frac=0.5), backend="cuda_decode")
    cache, _ = mgr.step(_x(22))
    idx = torch.zeros((2, 1), dtype=torch.int32)
    f32_rows = torch.zeros((2, 1) + tuple(cache.v.shape[2:]))
    before = cache.v.clone(), cache.staged.v.clone()
    with pytest.raises(TypeError, match="frozen scale"):
        scatter_table_rows(cache.v, idx, f32_rows)
    with pytest.raises(TypeError, match="dtype"):
        msgs_decode.update_staged_rows(cache.staged, idx, f32_rows)
    assert torch.equal(cache.v, before[0])
    assert torch.equal(cache.staged.v, before[1])
    codes = f32_rows.to(torch.int8)
    assert scatter_table_rows(cache.v, idx, codes).dtype == torch.int8
    assert msgs_decode.update_staged_rows(cache.staged, idx, codes).v.dtype \
        == torch.int8


def test_mid_stream_plan_swap_forces_full_rebuild():
    mgr, plan = _mgr(None, StreamConfig(tile_rows=2, delta_threshold=1e-6,
                                        update_frac=0.5))
    x0 = _x(23)
    mgr.step(x0)
    x1 = x0.clone()
    x1[:, 0:3] += 0.5
    cache, st = mgr.step(x1)
    assert st["mode"] == "incremental"
    assert cache.scale is None and cache.v.dtype == torch.float32
    mgr.plan = msda.make_plan(
        dataclasses.replace(plan.cfg, table_dtype="int8"), LEVELS,
        backend="torch_gather", n_queries=16, n_consumers=2)
    cache, st = mgr.step(x1)
    assert st["mode"] == "rebuild" and st["reason"] == "plan-change", st
    assert cache.v.dtype == torch.int8 and cache.scale is not None
    assert mgr.report()["table_dtype"] == "int8"
    x2 = x0.clone()
    x2[:, 0:3] += 0.7
    cache, st = mgr.step(x2)
    assert st["mode"] == "incremental" and cache.v.dtype == torch.int8


def test_streaming_engine_admission_is_slot_local():
    """A session joining mid-stream builds only its slot's rows (a
    batch-1 build copied into the slot), the running session rides the
    incremental path, the admitted slot equals a from-scratch build of
    its own frame bitwise, and churn calls no path for the first time
    again."""
    engine, _ = _engine(scfg=StreamConfig(tile_rows=1, delta_threshold=1e-4,
                                          update_frac=0.9),
                        update_fwp=False, backend="cuda_decode",
                        obs=Observability.create())
    mgr = engine.mgr
    s0 = engine.open_session()
    scene = drifting_scene(3, LEVELS, D, 3)
    engine.submit_frame(s0, scene[0][0])
    engine.step()
    engine.submit_frame(s0, scene[1][0])
    engine.step()
    assert mgr.last_stats["mode"] == "incremental"
    where = _addresses(mgr.cache)
    s1 = engine.open_session()
    engine.submit_frame(s0, scene[2][0])
    engine.submit_frame(s1, scene[0][0])
    engine.step()
    st = mgr.last_stats
    assert st["mode"] == "incremental", st
    assert st["admitted_slots"] == (1,), st
    assert mgr.rebuild_frames == 1
    assert _addresses(mgr.cache) == where
    f = mgr.fwp
    fwp1 = fwp_lib.FWPState(keep_mask=f.keep_mask[1:2],
                            keep_idx=f.keep_idx[1:2],
                            pix2slot=f.pix2slot[1:2], freq=f.freq[1:2])
    ref = build_value_cache(mgr.params, mgr.plan,
                            torch.from_numpy(scene[0][0])[None],
                            MSDAPipelineState(fwp=fwp1))
    assert torch.equal(mgr.cache.v[1], ref.v[0])
    assert torch.equal(mgr.cache.staged.v[1], ref.staged.v[0])
    with pytest.raises(RuntimeError):
        engine.open_session()
    traces = dict(mgr.trace_counts)
    assert traces == {"build": 2, "frame": 1, "restage": 0}
    engine.close_session(s1)
    s2 = engine.open_session()
    engine.submit_frame(s2, scene[1][0])
    engine.step()
    assert mgr.trace_counts == traces
    assert mgr.last_stats["admitted_slots"] == (1,)
    assert mgr.last_stats["mode"] == "incremental"
    assert mgr.rebuild_frames == 1


# --------------------------------------------------------------------------
# telemetry and capacity
# --------------------------------------------------------------------------

def test_engine_telemetry_log_validates(tmp_path):
    path = tmp_path / "stream.jsonl"
    obs = Observability.create(jsonl_path=str(path))
    engine, _ = _engine(obs=obs)
    sid = engine.open_session()
    for x in drifting_scene(4, LEVELS, D, 3):
        engine.submit_frame(sid, x[0])
    engine.run_until_drained()
    obs.close()
    events = [json.loads(line) for line in open(path)]
    plans = [e for e in events if e["type"] == "plan"]
    assert len(plans) == 1 and plans[0]["engine"] == "StreamingDetrEngine"
    assert plans[0]["plan"]["stream"]["update_rows"] == engine.mgr.update_rows
    info = validate_jsonl(str(path))
    for name in ("stream_frames_total", "staged_bytes_total",
                 "stream_span_seconds", "stream_frame_latency_seconds",
                 "msda_traces_total", "stream_dirty_slots"):
        assert name in info["metrics"], (name, info["metrics"])
    m = obs.metrics
    assert m.get("stream_frame_latency_seconds").total_count() == 3
    for span in ("decode", "rebuild", "diff"):
        assert m.get("stream_span_seconds").count(span=span) >= 1, span


def test_capacity_estimate_per_session_bytes_follow_the_reference():
    engine, _ = _engine()
    est = engine.capacity_estimate(budget_bytes=10_000_000)
    assert est["budget_source"] == "caller"
    assert est["rows_per_session"] == engine.mgr._n_rows
    rplan = rmsda.make_plan(RConfig(**_kw()), LEVELS, backend="jnp_gather",
                            n_queries=8, n_consumers=2)
    for d in ("float32", "int8"):
        want = dataclasses.replace(rplan, table_dtype=d).table_bytes_for_rows(
            engine.mgr._n_rows, with_indirection=True)
        assert est["per_dtype"][d]["bytes_per_session"] == want
        assert est["per_dtype"][d]["sessions"] == 10_000_000 // want
    # the engine applied the committed 'cpu' entry: its measured budget
    # is the default, as the reference's tuned window budget is; with no
    # entry applied the host's available memory stands in for the TPU
    # constant
    default = engine.capacity_estimate()
    assert default["budget_source"] == "measured"
    assert default["budget_bytes"] == \
        msda.tuned_entry()["staging_budget_bytes"]
    with plan_table_scope():
        default = engine.capacity_estimate()
    assert default["budget_source"] == "host_free"
    assert default["budget_bytes"] > 0
