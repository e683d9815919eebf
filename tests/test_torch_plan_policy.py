"""The port's planner held to the reference's on the CPU.

  * ``auto``: for a grid of configs, level shapes, table dtypes (float32,
    int8) and query geometries (raster, decode-shaped), with explicit
    ``vmem_budget_bytes``, ``staging_budget_bytes``,
    ``measured_window_bytes`` and a decode-sweep verdict injected into
    both packages, the port picks the reference's counterpart every time:
    for the CPU the reference's names mapped, for a card (stubbed) the
    same but with K1 where the reference falls back to its gather;
  * every bytes figure (``value_table_bytes``, ``fits_vmem``,
    ``cache_table_bytes``, ``decode_operand_bytes``, ``window_bytes`` /
    ``window_bytes_compact``, ``table_bytes_for_rows``) and
    ``with_measured_tile_window``'s four figures on one numpy set of
    reference points equal the reference's exactly;
  * the knee, veto and crossover rules pick what the reference's
    calibrations pick on the same injected timings;
  * with no entry applied, ``auto`` resolves each served bucket as at the
    parent commit: ``cuda_fused`` in the encoder, ``cuda_decode`` in the
    decoder, for the CPU and for a card with the H100's 50 MiB L2;
  * ``core.msdeform_attn.msdeform_attn_apply`` equals the reference's
    (float32, ``torch_gather`` against ``jnp_gather``) at
    ``tests/test_torch_msda.py``'s tolerance, rtol = atol = 1e-5."""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import msda as rmsda  # noqa: E402
from repro.core import msdeform_attn as rattn  # noqa: E402
from repro.msda import autotune as rautotune  # noqa: E402
from repro.msda import plan as rplan_lib  # noqa: E402
from repro_torch import msda  # noqa: E402
from repro_torch.core import msdeform_attn as tattn  # noqa: E402
from repro_torch.msda import autotune  # noqa: E402
from repro_torch.msda import plan as plan_lib  # noqa: E402
from test_torch_autotune import _stub_card  # noqa: E402
from test_torch_msda import _assert_fwp_equal, _inputs, _t  # noqa: E402

torch.set_num_threads(1)

PORT_NAME = {"jnp_gather": "torch_gather", "pallas_fused": "cuda_fused",
             "pallas_windowed": "cuda_windowed",
             "pallas_decode": "cuda_decode"}
#: a plan for a card takes K1 where the reference falls back to its gather
CARD_NAME = dict(PORT_NAME, jnp_gather="cuda_fused")
PLATFORMS = {"cpu": PORT_NAME, "card": CARD_NAME}


@pytest.fixture(autouse=True)
def _untuned_plans():
    with autotune.plan_table_scope():
        yield

CONFIGS = {
    "dh16_narrow": dict(d_model=64, n_heads=4,
                        range_narrow=(6.0, 4.0, 3.0, 2.0)),
    "dh16_narrow_compact": dict(d_model=64, n_heads=4, fwp_mode="compact",
                                fwp_capacity=0.6,
                                range_narrow=(6.0, 4.0, 3.0, 2.0)),
    "dh32_unbounded": dict(d_model=128, n_heads=4),
    "dh128_native_compact": dict(d_model=256, n_heads=2, fwp_mode="compact",
                                 fwp_capacity=0.5,
                                 range_narrow=(5.0, 4.0, 3.0, 2.0)),
}
LEVEL_SETS = {"toy": ((16, 20), (8, 10), (4, 5), (2, 3)),
              "stream": ((32, 40), (16, 20), (8, 10), (4, 5))}
TABLES = ("float32", "int8")
QUERIES = {"raster": None, "decode": 30}

BUDGETS = (2**12, 2**16, 2**19, 2**22, 2**26)
MEASURED = (None, 2**13, 2**18)
VERDICTS = (None, False)


def _pair(name, table):
    kw = dict(CONFIGS[name], table_dtype=table)
    return rattn.MSDeformAttnConfig(**kw), tattn.MSDeformAttnConfig(**kw)


def _verdict(v):
    """Inject a decode-sweep verdict (None: no entry) into both planners;
    the budgets are passed explicitly, so only the verdict is read."""
    entry = None if v is None else {"decode_sweep_beneficial": v}
    rplan_lib.apply_tuned_plan_table(entry)
    plan_lib.apply_tuned_plan_table(entry)


def _cases():
    return list(itertools.product(CONFIGS, LEVEL_SETS, TABLES, QUERIES))


@pytest.mark.parametrize("platform", sorted(PLATFORMS))
@pytest.mark.parametrize("name,levels,table,geometry", _cases())
def test_auto_picks_the_reference_counterpart(name, levels, table, geometry,
                                              platform, monkeypatch):
    if platform == "card":
        _stub_card(monkeypatch)
    counterpart = PLATFORMS[platform]
    rcfg, tcfg = _pair(name, table)
    shapes, nq = LEVEL_SETS[levels], QUERIES[geometry]
    picks = set()
    for verdict in VERDICTS:
        _verdict(verdict)
        for vmem, staging, measured in itertools.product(BUDGETS, BUDGETS,
                                                         MEASURED):
            kw = dict(backend="auto", n_queries=nq, n_consumers=6,
                      vmem_budget_bytes=vmem, staging_budget_bytes=staging,
                      measured_window_bytes=measured, budget_source="static")
            want = rmsda.make_plan(rcfg, shapes, **kw)
            got = msda.make_plan(tcfg, shapes, **kw)
            assert got.backend == counterpart[want.backend], (verdict, kw)
            picks.add(want.backend)
    _verdict(None)
    # every case reaches more than one branch of the policy (on a card
    # the gather branch and the fused one both resolve to K1)
    assert len(picks) >= 2, picks


def test_the_grid_reaches_every_backend():
    seen = set()
    for name, levels, table, geometry in _cases():
        rcfg, tcfg = _pair(name, table)
        for vmem, staging, measured in itertools.product(BUDGETS, BUDGETS,
                                                         MEASURED):
            seen.add(msda.make_plan(
                tcfg, LEVEL_SETS[levels], backend="auto",
                n_queries=QUERIES[geometry], vmem_budget_bytes=vmem,
                staging_budget_bytes=staging,
                measured_window_bytes=measured).backend)
    assert seen == {"torch_gather", "cuda_fused", "cuda_windowed",
                    "cuda_decode"}


def _ref_points(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, (1, n, 2)).astype(np.float32)


@pytest.mark.parametrize("order", ["none", "zorder"])
@pytest.mark.parametrize("name,levels,table,geometry", _cases())
def test_bytes_figures_equal_the_reference(name, levels, table, geometry,
                                           order):
    rcfg, tcfg = _pair(name, table)
    rcfg = dataclasses.replace(rcfg, query_order=order)
    tcfg = dataclasses.replace(tcfg, query_order=order)
    shapes, nq = LEVEL_SETS[levels], QUERIES[geometry]
    kw = dict(backend="torch_gather", n_queries=nq, n_consumers=6,
              vmem_budget_bytes=2**20, staging_budget_bytes=2**19,
              budget_source="static")
    want = rmsda.make_plan(rcfg, shapes, **dict(kw, backend="jnp_gather"))
    got = msda.make_plan(tcfg, shapes, **kw)
    for field in ("value_table_bytes", "fits_vmem", "cache_table_bytes",
                  "decode_operand_bytes", "window_bytes",
                  "window_bytes_compact", "block_q", "block_q_levels",
                  "tile_q", "vmem_budget_bytes", "staging_budget_bytes",
                  "budget_source", "lane_layout", "head_pack", "n_in"):
        assert getattr(got, field) == getattr(want, field), field
    for rows in (1, 77, got.n_in):
        for ind in (False, True):
            assert got.table_bytes_for_rows(rows, ind) \
                == want.table_bytes_for_rows(rows, ind)
    refs = _ref_points(nq or got.n_in, seed=0)
    assert got.with_measured_tile_window(refs).measured_tilewin \
        == want.with_measured_tile_window(refs).measured_tilewin
    if tcfg.range_narrow is not None:
        assert got.with_measured_tile_window(refs).measured_tilewin \
            is not None
    assert got.with_measured_tile_window(refs).snapshot() == \
        dict(want.with_measured_tile_window(refs).snapshot(),
             backend=got.backend)


def test_snapshot_and_describe_carry_the_budget():
    _, tcfg = _pair("dh16_narrow", "float32")
    shapes = LEVEL_SETS["toy"]
    plan = msda.make_plan(tcfg, shapes, backend="auto")
    snap = plan.snapshot()
    assert snap["budget_source"] == "static"
    assert snap["staging_budget_bytes"] == plan_lib.DEFAULT_WINDOW_STAGING_BUDGET
    assert "budget=static(51200KB)" in plan.describe()
    plan_lib.apply_tuned_plan_table({"staging_budget_bytes": 3 * 2**20})
    plan = msda.plan_for(tcfg, shapes, "auto")
    assert "budget=measured(3072KB)" in plan.describe()


# --------------------------------------------------------------------------
# The calibration rules against the reference's on injected timings
# --------------------------------------------------------------------------

class _Clock:
    """Stands in for the reference's ``_time``: hands out timings in call
    order."""

    def __init__(self, values):
        self.values = list(values)

    def __call__(self, *a, **k):
        return self.values.pop(0)


KNEE_PROFILES = {
    "flat": [1.0, 2.0, 4.0, 8.0, 16.0, 32.0],
    "knee_at_8": [1.0, 2.0, 4.0, 8.0, 40.0, 90.0],
    "knee_at_4": [1.0, 2.0, 4.2, 30.0, 70.0, 150.0],
    "overhead_bound": [5.0, 5.2, 5.5, 6.0, 8.0, 12.0],
    "noisy": [1.3, 2.0, 4.8, 8.1, 16.5, 70.0],
}


@pytest.mark.parametrize("profile", sorted(KNEE_PROFILES))
def test_knee_rule_picks_the_reference_budget(profile, monkeypatch):
    times = [t * 1e-4 for t in KNEE_PROFILES[profile]]
    monkeypatch.setattr(rautotune, "_time", _Clock(times))
    sizes = (1, 2, 4, 8, 16, 32)
    want, detail = rautotune.measure_staging_budget(sizes_mb=sizes)
    # the reference's per-byte figure divides by its probed table bytes
    rows = [max(4096, mb * 2**20 // (128 * 4)) for mb in sizes]
    per_byte = {mb * 2**20: t / (r * 128 * 4)
                for mb, t, r in zip(sizes, times, rows)}
    assert autotune.knee_budget(per_byte, rautotune.BUDGET_CLAMP) == want


DECODE_PROFILES = {
    "sweep_wins": ([1.0, 1.1, 0.9], [1.5, 1.4, 1.6]),
    "parity": ([1.0, 1.02, 0.98], [0.99, 1.0, 1.01]),
    "decisive_loss": ([1.0, 1.1, 1.05], [0.7, 0.75, 0.8]),
    "at_tolerance": ([1.0, 1.0, 1.0], [0.85, 0.9, 0.86]),
}


@pytest.mark.parametrize("profile", sorted(DECODE_PROFILES))
def test_veto_rule_picks_the_reference_verdict(profile, monkeypatch):
    dec, fus = DECODE_PROFILES[profile]
    order = [t for pair in zip(dec, fus) for t in pair]   # interleaved
    monkeypatch.setattr(rautotune, "_time", _Clock(order))
    want, want_speedup, _ = rautotune.measure_decode_sweep(repeats=3)
    got, speedup = autotune.decode_verdict(min(dec), min(fus))
    assert got == want
    assert speedup == pytest.approx(want_speedup, rel=1e-12)


STREAM_PROFILES = {
    "exact_diff_cheap": ([1.0, 0.9, 0.8], 10.0, [4.0, 2.5, 1.2]),
    "stride_needed": ([4.0, 3.0, 2.0], 10.0, [5.0, 3.0, 1.5]),
    "nothing_fits": ([9.0, 8.0, 7.0], 10.0, [6.0, 5.0, 4.0]),
    "largest_budget": ([0.5, 0.4, 0.3], 10.0, [5.0, 2.0, 1.0]),
}


@pytest.mark.parametrize("profile", sorted(STREAM_PROFILES))
def test_crossover_rule_picks_the_reference_pair(profile, monkeypatch):
    diffs, rebuild, updates = STREAM_PROFILES[profile]
    monkeypatch.setattr(rautotune, "_time",
                        _Clock(diffs + [rebuild] + updates))
    want_stride, want_frac, _ = rautotune.measure_stream_crossover()
    got = autotune.stream_crossover(dict(zip((1, 2, 4), diffs)),
                                    dict(zip((0.5, 0.25, 0.125), updates)),
                                    rebuild)
    assert got == (want_stride, want_frac)


# --------------------------------------------------------------------------
# Served buckets with no entry applied: the parent commit's picks
# --------------------------------------------------------------------------

def _served():
    from repro_torch.configs.detr_family import CONFIGS as FAMILY, with_dtype
    from repro_torch.train.detr import train_config
    attn = with_dtype(FAMILY["deformable-detr-defa"].encoder,
                      torch.float32).attn
    shapes = plan_lib.level_shapes_for_resolution
    return {
        "512px_float32": (attn, shapes(512)),
        "1024px_int8": (dataclasses.replace(attn, table_dtype="int8"),
                        shapes(1024)),
        "1024px_float32": (attn, shapes(1024)),
        "train_512px": (train_config().encoder.attn, shapes(512)),
        "stream_512px_int8": (dataclasses.replace(attn, table_dtype="int8"),
                              shapes(512)),
    }


@pytest.mark.parametrize("platform", sorted(PLATFORMS))
@pytest.mark.parametrize("bucket", sorted(_served()))
def test_served_buckets_resolve_as_at_the_parent_commit(bucket, platform,
                                                        monkeypatch):
    if platform == "card":
        _stub_card(monkeypatch)
    attn, shapes = _served()[bucket]
    assert plan_lib.tuned_entry() is None
    enc = msda.plan_for(attn, shapes, "auto")
    dec = msda.plan_for(attn, shapes, "auto", 300, 6)
    assert (enc.backend, dec.backend) == ("cuda_fused", "cuda_decode")
    assert enc.budget_source == dec.budget_source == "static"
    # the trainer's encoder keeps its own backend by name
    if bucket == "train_512px":
        assert msda.plan_for(attn, shapes).backend == "torch_gather"


# --------------------------------------------------------------------------
# The compat shim
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fwp,pap,stats", [("off", "off", False),
                                           ("compact", "topk", True),
                                           ("mask", "threshold", True)])
def test_msdeform_attn_apply_matches_reference(fwp, pap, stats):
    kw, params, q, refs, x = _inputs(64)
    kw = dict(kw, fwp_mode=fwp, pap_mode=pap)
    rcfg, tcfg = rattn.MSDeformAttnConfig(**kw), tattn.MSDeformAttnConfig(**kw)
    levels = ((16, 20), (8, 10), (4, 5), (2, 3))
    want, raux = rattn.msdeform_attn_apply(params, rcfg, q, refs, x, levels,
                                           collect_stats=stats)
    p = {k: _t(v) for k, v in params.items()}
    got, aux = tattn.msdeform_attn_apply(p, tcfg, _t(q), _t(refs), _t(x),
                                         levels, collect_stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert set(aux) == set(raux)
    if fwp != "off":
        _assert_fwp_equal(aux["fwp_state"], raux["fwp_state"])
    for k in set(aux) - {"fwp_state"}:
        np.testing.assert_allclose(np.asarray(aux[k], np.float64),
                                   np.asarray(raux[k], np.float64),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # a second block fed the first block's FWP link, as an encoder chains
    if fwp != "off":
        want2, _ = rattn.msdeform_attn_apply(params, rcfg, q, refs, x, levels,
                                             raux["fwp_state"])
        got2, _ = tattn.msdeform_attn_apply(p, tcfg, _t(q), _t(refs), _t(x),
                                            levels, aux["fwp_state"])
        np.testing.assert_allclose(got2.numpy(), np.asarray(want2),
                                   rtol=1e-5, atol=1e-5)
    jax.clear_caches()
