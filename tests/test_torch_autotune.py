"""The port's measured plan table (``repro_torch.msda.autotune``): the
counterparts of ``tests/test_autotune.py`` (persistence round trip,
platform merge, corrupt / wrong-schema / partial tables, the committed
table's ``--no-measure`` and ``--check`` legs, ``ensure_applied``, the
``plan_for`` memo across env and table flips, the env pin, the tuned
stream crossover, the decode veto, tuned-vs-static bit identity), plus a
CPU measurement end to end, the serve engines' use of the table and
``capacity_estimate``'s precedence.

Every test runs inside :func:`repro_torch.msda.autotune.plan_table_scope`:
it starts with no entry applied and none loaded, and what it applies does
not outlive it. A card's platform is stubbed (:func:`_stub_card`) to show
that entries and the ``auto`` policy's last resort are per platform."""
import json
import os
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.msda import autotune  # noqa: E402
from repro_torch.msda import plan as plan_lib  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CFG = autotune._default_cfg()
LEVELS = autotune.CALIB_LEVELS


CARD = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _untuned_plans():
    with autotune.plan_table_scope():
        yield


def _stub_card(monkeypatch, l2=50 * 2**20):
    """Plans for ``"cuda"`` (and for ``device=None``) are for a stubbed
    card named ``CARD`` with an ``l2``-byte L2; the CPU stays the CPU."""
    real = plan_lib.platform_of

    def platform_of(device=None):
        if device is None or torch.device(device).type == "cuda":
            return CARD, l2
        return real(device)
    monkeypatch.setattr(plan_lib, "platform_of", platform_of)


def _entry(budget=12 * 2**20, stride=2, frac=0.5, beneficial=True):
    """A structurally valid platform entry with distinctive values."""
    return {"provenance": "measured", "platform": "cpu",
            "staging_budget_bytes": int(budget),
            "decode_sweep_beneficial": bool(beneficial),
            "decode_persistent_speedup": 1.0,
            "stream": {"diff_channel_stride": int(stride),
                       "update_frac": float(frac)}}


# --------------------------------------------------------------------------
# Persistence round trip
# --------------------------------------------------------------------------

def test_round_trip_identical_plan(tmp_path):
    path = str(tmp_path / "autotune_torch.json")
    entry = _entry(budget=12 * 2**20)
    autotune.save_entry(entry, path, "cpu")

    loaded = autotune.plan_autotune(device="cpu", measure=False,
                                    cache_path=path)
    assert loaded == entry
    plan_a = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan_a.staging_budget_bytes == 12 * 2**20
    assert plan_a.budget_source == "measured"
    assert "budget=measured" in plan_a.describe()

    plan_lib.apply_tuned_plan_table(None)
    reloaded = autotune.plan_autotune(device="cpu", measure=False,
                                      cache_path=path)
    assert reloaded == entry
    assert plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6) == plan_a


def test_save_entry_merges_platforms(tmp_path):
    path = str(tmp_path / "autotune_torch.json")
    card = "cuda:NVIDIA H100 80GB HBM3"
    autotune.save_entry(dict(_entry(budget=2**20), platform=card), path,
                        platform=card)
    autotune.save_entry(_entry(budget=12 * 2**20), path, platform="cpu")
    table = autotune.load_table(path)
    assert set(table["platforms"]) == {card, "cpu"}
    assert table["platforms"][card]["staging_budget_bytes"] == 2**20


def test_platform_key_names_the_card():
    assert autotune.platform_key("cpu") == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            autotune.platform_key()


def test_default_table_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_MSDA_AUTOTUNE_TABLE", raising=False)
    assert autotune.default_table_path() == os.path.join(
        ROOT, "results", "autotune_torch.json")
    monkeypatch.setenv("REPRO_TORCH_MSDA_AUTOTUNE_TABLE", "/elsewhere.json")
    assert autotune.default_table_path() == "/elsewhere.json"


# --------------------------------------------------------------------------
# Corrupt / partial tables fall back to the static formulas
# --------------------------------------------------------------------------

def test_corrupt_table_warns_and_falls_back(tmp_path):
    path = tmp_path / "autotune_torch.json"
    path.write_text("{not json at all")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        got = autotune.plan_autotune(device="cpu", measure=False,
                                     cache_path=str(path), warn_missing=False)
    assert got is None
    plan = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan.budget_source == "static"
    assert plan.staging_budget_bytes == plan_lib.DEFAULT_WINDOW_STAGING_BUDGET


def test_wrong_schema_warns_and_falls_back(tmp_path):
    path = tmp_path / "autotune_torch.json"
    path.write_text(json.dumps({"schema": 999, "platforms": {}}))
    with pytest.warns(RuntimeWarning, match="schema"):
        assert autotune.load_table(str(path)) is None


def test_partial_entry_warns_and_falls_back(tmp_path):
    path = tmp_path / "autotune_torch.json"
    bad = _entry()
    del bad["stream"]
    path.write_text(json.dumps({"schema": autotune.SCHEMA_VERSION,
                                "platforms": {"cpu": bad}}))
    with pytest.warns(RuntimeWarning, match="partial/invalid"):
        got = autotune.plan_autotune(device="cpu", measure=False,
                                     cache_path=str(path), warn_missing=False)
    assert got is None
    assert plan_lib.tuned_entry() is None


def test_missing_table_is_silent():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert autotune.load_table("/nonexistent/autotune_torch.json") is None


def test_valid_entry_rejects_partials():
    assert autotune.valid_entry(_entry())
    for mutate in (
        lambda e: e.pop("staging_budget_bytes"),
        lambda e: e.update(staging_budget_bytes=0),
        lambda e: e.pop("decode_sweep_beneficial"),
        lambda e: e.pop("stream"),
        lambda e: e["stream"].update(diff_channel_stride=0),
        lambda e: e["stream"].update(update_frac=0.0),
        lambda e: e["stream"].update(update_frac=1.5),
    ):
        e = _entry()
        mutate(e)
        assert not autotune.valid_entry(e), e


# --------------------------------------------------------------------------
# The committed table: the CI leg, no timing
# --------------------------------------------------------------------------

def test_committed_table_no_measure():
    entry = autotune.plan_autotune(device="cpu", measure=False)
    assert entry is not None, (
        "no committed 'cpu' entry in results/autotune_torch.json")
    assert entry["provenance"] == "measured" and autotune.valid_entry(entry)
    plan = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan.budget_source == "measured"
    assert "budget=measured" in plan.describe()
    # the reference's table is not the port's
    assert os.path.basename(autotune.default_table_path()) \
        == "autotune_torch.json"


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_TORCH_MSDA_AUTOTUNE_TABLE", None)
    return subprocess.run([sys.executable, "-m", "repro_torch.msda.autotune",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_committed_table_check_cli():
    """The CI leg verbatim, as a subprocess: --device cpu --no-measure
    --check exits 0 (measured provenance, tuned == static bitwise in the
    encoder and the decoder)."""
    r = _cli("--device", "cpu", "--no-measure", "--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "provenance ok" in r.stdout and "budget=measured" in r.stdout
    assert r.stdout.count("bit-identity ok") == 2, r.stdout


def test_cli_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default runs there")
    r = _cli("--no-measure", "--check")
    assert r.returncode != 0
    assert "torch.cuda.is_available" in r.stderr


def test_ensure_applied_is_load_only_and_once():
    got = autotune.ensure_applied("cpu")
    assert got is not None and got == plan_lib.tuned_entry()
    assert autotune.ensure_applied("cpu") == got
    plan_lib.apply_tuned_plan_table(None)
    assert autotune.ensure_applied("cpu") is None      # tried once already


def test_ensure_applied_never_raises(tmp_path):
    bad = tmp_path / "autotune_torch.json"
    bad.write_text("garbage{")
    assert autotune.ensure_applied("cpu", cache_path=str(bad)) is None
    assert plan_lib.tuned_entry() is None
    assert plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6).budget_source \
        == "static"


# --------------------------------------------------------------------------
# plan_for's memo across mid-process changes
# --------------------------------------------------------------------------

def test_plan_for_env_budget_flip(monkeypatch):
    plan0 = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan0.staging_budget_bytes == \
        plan_lib.DEFAULT_WINDOW_STAGING_BUDGET
    monkeypatch.setenv("REPRO_MSDA_VMEM_BUDGET", "1024")
    plan1 = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan1.staging_budget_bytes == 1024
    assert plan1 != plan0 and plan1.backend == "cuda_fused"
    monkeypatch.setenv("REPRO_MSDA_VMEM_BUDGET", "0x400")
    assert plan_lib.window_staging_budget() == 1024
    monkeypatch.setenv("REPRO_MSDA_VMEM_BUDGET", "lots")
    with pytest.raises(ValueError, match="integer byte count"):
        plan_lib.window_staging_budget()
    monkeypatch.delenv("REPRO_MSDA_VMEM_BUDGET")
    assert plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6) == plan0


def test_plan_for_env_table_dtype_flip(monkeypatch):
    plan0 = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan0.table_dtype == "float32"
    monkeypatch.setenv("REPRO_MSDA_TABLE_DTYPE", "int8")
    plan1 = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan1.table_dtype == "int8"
    assert plan1 != plan0


def test_plan_for_env_query_order_flip(monkeypatch):
    plan0 = plan_lib.plan_for(CFG, LEVELS, None)
    assert plan0.query_order == "none"
    monkeypatch.setenv("REPRO_MSDA_QUERY_ORDER", "zorder")
    plan1 = plan_lib.plan_for(CFG, LEVELS, None)
    assert plan1.query_order == "zorder"
    assert plan1 != plan0


def test_plan_for_tuned_table_flip():
    plan0 = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan0.budget_source == "static"
    plan_lib.apply_tuned_plan_table(_entry(budget=24 * 2**20))
    plan1 = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan1.staging_budget_bytes == 24 * 2**20
    assert plan1.budget_source == "measured"
    plan_lib.apply_tuned_plan_table(None)
    assert plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6) == plan0


def test_env_pin_beats_tuned_table(monkeypatch):
    plan_lib.apply_tuned_plan_table(_entry(budget=24 * 2**20))
    monkeypatch.setenv("REPRO_MSDA_VMEM_BUDGET", str(2 * 2**20))
    plan = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan.staging_budget_bytes == 2 * 2**20
    assert plan.budget_source == "static"


# --------------------------------------------------------------------------
# The tuned knobs reach the stream config and the auto policy
# --------------------------------------------------------------------------

def test_resolve_stream_config_consumes_tuned_table():
    from repro_torch.stream import StreamConfig, resolve_stream_config
    base = resolve_stream_config(None)
    assert (base.diff_channel_stride, base.update_frac) == (1, 0.25)
    plan_lib.apply_tuned_plan_table(_entry(stride=2, frac=0.5))
    tuned = resolve_stream_config(None)
    assert (tuned.diff_channel_stride, tuned.update_frac) == (2, 0.5)
    mine = StreamConfig(diff_channel_stride=4)
    assert resolve_stream_config(mine) is mine
    plan_lib.apply_tuned_plan_table(None)
    again = resolve_stream_config(None)
    assert (again.diff_channel_stride, again.update_frac) == (1, 0.25)


def test_decode_sweep_veto_gates_auto():
    plan_yes = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan_yes.backend == "cuda_decode"
    plan_lib.apply_tuned_plan_table(_entry(beneficial=False))
    plan_no = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6)
    assert plan_no.backend == "cuda_fused"


def test_tuned_vs_static_bit_identity():
    plan_lib.apply_tuned_plan_table(_entry(budget=24 * 2**20))
    res = autotune.tuned_vs_static(CFG, LEVELS, CPU, batch=1, n_queries=64,
                                   n_layers=2)
    assert plan_lib.tuned_entry() is not None            # restored
    assert {r: v["backend"] for r, v in res.items()} == \
        {"encoder": "cuda_fused", "decoder": "cuda_decode"}
    for r in res.values():
        assert r["bitwise"]
        assert r["budget"] == {"measured": 24 * 2**20,
                               "static": plan_lib.DEFAULT_WINDOW_STAGING_BUDGET}


# --------------------------------------------------------------------------
# Beyond the reference's tests
# --------------------------------------------------------------------------

def test_measure_on_cpu_persists_and_applies_a_valid_entry(tmp_path):
    """The measurement path end to end on the CPU (the staging probe
    through K1's plain version at the reference's sizes, the decode stack,
    the stream crossover), persisted and applied."""
    path = str(tmp_path / "autotune_torch.json")
    entry = autotune.plan_autotune(device="cpu", measure=True, force=True,
                                   cache_path=path, iters=1)
    assert autotune.valid_entry(entry) and entry["platform"] == "cpu"
    assert plan_lib.tuned_entry() == entry
    assert autotune.load_table(path)["platforms"]["cpu"] == entry
    cal = entry["calibration"]
    assert cal["staging_budget"]["sizes_mb"] == list(autotune.CPU_PROBE_MB)
    assert cal["decode_sweep"]["level_shapes"] == [list(s) for s in LEVELS]
    lo, hi = autotune.CPU_BUDGET_CLAMP
    assert lo <= entry["staging_budget_bytes"] <= hi


def test_card_probe_sizes_straddle_the_l2(monkeypatch):
    """The card's probed sizes from its L2 (an H100 SXM's 50 MiB here,
    stubbed): whole MiB from L2/8 to 4 x L2, inside the Hopper clamp."""
    _stub_card(monkeypatch)
    sizes, clamp, l2 = autotune.probe_sizes("cuda")
    assert l2 == 50 * 2**20 and clamp == autotune.BUDGET_CLAMP
    assert min(sizes) < l2 < max(sizes)
    assert [s // 2**20 for s in sizes] == [6, 12, 19, 25, 31, 38, 44, 50,
                                           62, 75, 100, 200]


def test_serve_engine_plans_on_the_committed_entry(tmp_path, monkeypatch,
                                                    capsys):
    """A CPU DetrServeEngine applies the committed 'cpu' entry before it
    plans: its JSONL ``plan`` events carry ``budget_source`` and
    ``staging_budget_bytes``, and the dashboard prints ``budget=measured``
    (not ``budget=?``)."""
    from test_torch_serve_capture import _engine, _images
    from repro_torch.obs.dashboard import main as dashboard_main
    from repro_torch.obs.obs import OBS_JSONL_ENV
    from repro_torch.serve import DetrRequest
    committed = autotune.load_table()["platforms"]["cpu"]
    path = str(tmp_path / "serve.jsonl")
    monkeypatch.setenv(OBS_JSONL_ENV, path)
    engine = _engine(resolutions=(32,))
    assert plan_lib.tuned_entry() == committed
    for i, im in enumerate(_images(2, 32)):
        engine.submit(DetrRequest(rid=i, image=im))
    engine.run_until_drained()
    assert engine.bucket_table()[0]["budget_source"] == "measured"
    engine.close()
    plans = [e for e in map(json.loads, open(path)) if e["type"] == "plan"]
    assert plans and all(p["plan"]["budget_source"] == "measured"
                         and p["plan"]["staging_budget_bytes"]
                         == committed["staging_budget_bytes"]
                         for p in plans)
    capsys.readouterr()
    assert dashboard_main(["--jsonl", path]) == 0
    text = capsys.readouterr().out
    assert "budget=measured" in text and "budget=?" not in text


def test_capacity_estimate_takes_the_reference_precedence(monkeypatch):
    """caller > REPRO_MSDA_VMEM_BUDGET pin > measured entry > host_free."""
    from test_torch_stream import _engine
    engine, _ = _engine()
    plan_lib.apply_tuned_plan_table(_entry(budget=24 * 2**20))
    est = engine.capacity_estimate()
    assert (est["budget_bytes"], est["budget_source"]) == (24 * 2**20,
                                                           "measured")
    monkeypatch.setenv("REPRO_MSDA_VMEM_BUDGET", str(2**20))
    est = engine.capacity_estimate()
    assert (est["budget_bytes"], est["budget_source"]) == (2**20, "static")
    est = engine.capacity_estimate(budget_bytes=5_000_000)
    assert (est["budget_bytes"], est["budget_source"]) == (5_000_000,
                                                           "caller")
    monkeypatch.delenv("REPRO_MSDA_VMEM_BUDGET")
    plan_lib.apply_tuned_plan_table(None)
    assert engine.capacity_estimate()["budget_source"] == "host_free"
    per = est["per_dtype"]["float32"]["bytes_per_session"]
    assert est["per_dtype"]["float32"]["sessions"] == 5_000_000 // per


def test_streaming_engine_takes_the_tuned_crossover(tmp_path):
    """StreamingDetrEngine applies its device's entry before it resolves
    the default StreamConfig: the table's stride and update fraction."""
    from test_torch_stream import LEVELS as S_LEVELS, _decoder_setup
    from repro_torch.obs import Observability
    from repro_torch.serve import StreamingDetrEngine
    path = str(tmp_path / "autotune_torch.json")
    autotune.save_entry(_entry(stride=2, frac=0.5), path, "cpu")
    autotune.ensure_applied("cpu", cache_path=path)
    cfg, dec_cfg, params = _decoder_setup()
    engine = StreamingDetrEngine(cfg, dec_cfg, params, S_LEVELS,
                                 obs=Observability.disabled(), device="cpu")
    assert engine.mgr.scfg.diff_channel_stride == 2
    assert engine.mgr.scfg.update_frac == 0.5
    assert engine.plan.budget_source == "measured"


def test_cpu_engine_entry_never_reaches_card_plans(tmp_path, monkeypatch):
    """Entries are per platform: a CPU engine's applied entry leaves a
    plan for a card on the card's static budget (its L2), the card's own
    entry is loaded for it by ensure_applied, and each platform keeps its
    own afterwards."""
    from test_torch_stream import _engine
    path = str(tmp_path / "autotune_torch.json")
    autotune.save_entry(_entry(budget=3 * 2**20, beneficial=False), path,
                        "cpu")
    autotune.save_entry(dict(_entry(budget=40 * 2**20), platform=CARD), path,
                        CARD)
    monkeypatch.setenv("REPRO_TORCH_MSDA_AUTOTUNE_TABLE", path)
    engine, _ = _engine()
    assert engine.plan.staging_budget_bytes == 3 * 2**20
    _stub_card(monkeypatch, l2=48 * 2**20)
    card = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6, device="cuda")
    assert (card.budget_source, card.staging_budget_bytes,
            card.vmem_budget_bytes) == ("static", 48 * 2**20, 48 * 2**20)
    assert card.backend == "cuda_decode"         # the CPU's veto stays there
    assert autotune.ensure_applied("cuda")["staging_budget_bytes"] \
        == 40 * 2**20
    card = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6, device="cuda")
    assert (card.budget_source, card.staging_budget_bytes) == \
        ("measured", 40 * 2**20)
    cpu = plan_lib.plan_for(CFG, LEVELS, "auto", 64, 6, device="cpu")
    assert (cpu.staging_budget_bytes, cpu.backend) == (3 * 2**20,
                                                       "cuda_fused")
    assert set(plan_lib.tuned_entries()) == {"cpu", CARD}


@pytest.mark.parametrize("decode", [False, True])
def test_auto_last_resort_on_a_card_is_k1(monkeypatch, decode):
    """A table over both budgets with no range narrowing (no window gate):
    the reference falls back to its gather, which a plan for the CPU
    keeps; a plan for a card takes K1, which gathers from global memory
    at any table size."""
    from repro_torch.core.msdeform_attn import MSDeformAttnConfig
    cfg = MSDeformAttnConfig(d_model=256, n_heads=8)
    levels = plan_lib.level_shapes_for_resolution(1280)
    nq = 300 if decode else None
    cpu = plan_lib.make_plan(cfg, levels, backend="auto", n_queries=nq,
                             device="cpu")
    assert not cpu.fits_vmem and cpu.backend == "torch_gather"
    _stub_card(monkeypatch)
    card = plan_lib.make_plan(cfg, levels, backend="auto", n_queries=nq,
                              device="cuda")
    assert card.value_table_bytes > card.vmem_budget_bytes == 50 * 2**20
    assert card.backend == "cuda_fused"


def test_calibration_rules_are_pure_functions():
    assert autotune.knee_budget({2**20: 1.0, 2**21: 1.4, 2**22: 3.0},
                                (2**20, 2**23)) == 2**21
    assert autotune.knee_budget({2**20: 1.0}, (2**22, 2**23)) == 2**22
    assert autotune.decode_verdict(1.0, 0.8) == (False, 0.8)
    assert autotune.decode_verdict(1.0, 0.9) == (True, 0.9)
    assert autotune.stream_crossover({1: 3.0, 2: 1.0, 4: 0.5},
                                     {0.5: 5.5, 0.25: 4.0, 0.125: 1.0},
                                     10.0) == (2, 0.25)
    assert np.isfinite(autotune.decode_verdict(0.0, 1.0)[1])
