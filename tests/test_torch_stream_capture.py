"""The streaming paths as CUDA-graph bodies (``repro_torch/stream/graphs.py``,
the manager's build / frame / restage / hysteresis bodies and the
streaming engine's decode body), on the CPU, where every body runs
eagerly exactly as the card captures it:

  * every tensor a graph reads or writes keeps its address across a
    scripted run of every path (first frame, incremental, over budget,
    partial restage, admission, ``reset_slot``, ``permute_slots``,
    ``observe``), and a plan swap counts new first calls;
  * the fused speculative frame equals the reference's
    ``repro.stream.TemporalCacheManager`` frame by frame, bitwise (modes,
    dirty counts, geometry, diff reference, keep state, value and staged
    tables, int8 codes and scales), over-budget frames after a
    speculation included, and the speculation leaves nothing behind: a
    rebuilt frame equals a scratch build bitwise;
  * no body reads the device from the host (``Tensor.item``, ``tolist``,
    ``__bool__``, ``__int__``, ``__float__`` and ``.cpu()`` raise while
    one runs), and after warm-up neither the first-call counts nor the
    host constants built move under session churn.

Sizes and helpers are those of ``tests/test_torch_stream.py``."""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_stream as cases  # noqa: E402
from repro_torch import bridge, msda  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.stream import StreamConfig, drifting_scene  # noqa: E402
from repro_torch.stream.graphs import StreamGraphs  # noqa: E402

torch.set_num_threads(1)

LEVELS, N_IN, D = cases.LEVELS, cases.N_IN, cases.D
SCFG = StreamConfig(tile_rows=1, delta_threshold=1e-4, update_frac=0.9)


def _standing(mgr, engine=None):
    """name -> data_ptr of every tensor a streaming graph reads or writes."""
    c = mgr.cache
    named = {"v": c.v, "pix2slot": c.pix2slot, "keep_idx": c.keep_idx,
             "scale": c.scale, "staged.v": c.staged.v,
             "staged.scale": c.staged.scale, "staged.remap": c.staged.remap,
             "x_ref": mgr.x_ref, "ema": mgr.ema, "act_scale": mgr.act_scale,
             "input": mgr._x}
    for name, st in (("fwp", mgr.fwp), ("cache_fwp", mgr._cache_fwp)):
        for field, t in zip(st._fields, st):
            named[f"{name}.{field}"] = t
    if engine is not None:
        named["engine.memory"] = engine._memory
    return {k: None if t is None else t.data_ptr() for k, t in named.items()}


def _frames(n, seeds=(1, 2)):
    scenes = [drifting_scene(s, LEVELS, D, n) for s in seeds]
    return [np.concatenate([sc[t] for sc in scenes]) for t in range(n)]


def _scripted_run(mgr, x, after=lambda event: None, ref=None):
    """Every path of the manager in turn, the frame input written in place
    into ``x`` (bound as the standing input): first frame, incremental,
    over budget, partial restage, admission (or, under a frozen
    activation scale, the rebuild that stands for it), ``permute_slots``
    and ``observe``. ``ref``, a reference manager, takes the same calls
    on the same numpy inputs; ``after(event)`` runs after each call.
    Returns the frames' (mode, reason, admitted slots)."""
    frames = _frames(6)
    modes = []

    def step(t, bump=0.0):
        x.copy_(torch.from_numpy(frames[t]) + bump)
        _, st = mgr.step(x)
        if ref is not None:
            ref.step(jnp.asarray(x.numpy().copy()))
        modes.append((st["mode"], st["reason"], st["admitted_slots"]))
        after("step")

    def observe(freq):
        stale = mgr.observe(freq)
        if ref is not None:
            assert stale == ref.observe(jnp.asarray(freq))
        after("observe")

    def both(name, *args):
        getattr(mgr, name)(*args)
        if ref is not None:
            getattr(ref, name)(*args)
        after(name)
    step(0)                                        # first frame
    observe(np.ones((2, N_IN), np.float32))        # the warm keep set stays
    step(1)                                        # incremental
    step(2, bump=1.0)                              # every tile dirty
    observe(cases._flip_freq(5, (2, N_IN), level0_only=True))
    step(3)                                        # partial restage
    both("reset_slot", 1)
    step(4)                                        # admission
    both("permute_slots", (1, 0))
    observe(np.linalg.norm(frames[4], axis=-1).astype(np.float32))
    step(5)
    return modes


@pytest.mark.parametrize("table,act_bits", [("float32", 12), ("int8", None)])
def test_standing_tensors_keep_their_addresses(table, act_bits):
    mgr, plan = cases._mgr({"table_dtype": table, "act_bits": act_bits},
                           SCFG, backend="cuda_decode")
    x = torch.zeros((2, N_IN, D))
    mgr.bind_input(x)
    where, levels = {}, set()

    def check(event):
        if event == "step" and mgr.last_stats["restaged_levels"]:
            levels.add(mgr.last_stats["restaged_levels"])
        now = _standing(mgr)
        where.update({k: v for k, v in now.items() if k not in where})
        assert now == where
    modes = _scripted_run(mgr, x, check)
    assert [m[:2] for m in modes[:4]] == [
        ("rebuild", "first-frame"), ("incremental", ""),
        ("rebuild", "dirty>budget"), ("partial", "keep-transition")]
    if act_bits is None:
        assert modes[4] == ("incremental", "", (1,))
        assert where["act_scale"] is None and where["scale"] is not None
    else:       # a frozen act grid: the reset slot's keep rows restage
        assert modes[4] == ("partial", "keep-transition", ())
        assert where["act_scale"] is not None
    assert where["input"] == x.data_ptr()
    traces = mgr.trace_counts
    hyst = int(mgr._m_traces.value(fn="hysteresis"))
    assert traces["frame"] == hyst == 1         # one key per level tuple
    assert traces["restage"] == len(levels) >= 1
    assert traces["build"] == (2 if act_bits is None else 1)
    swapped = dataclasses.replace(plan.cfg, table_dtype="int8"
                                  if table == "float32" else "float32")
    mgr.plan = msda.make_plan(swapped, LEVELS, backend="cuda_decode",
                              n_queries=16, n_consumers=2)
    _, st = mgr.step(x)
    assert st["reason"] == "plan-change"
    assert mgr.trace_counts["build"] == traces["build"] + 1
    mgr.step(x)
    assert mgr.trace_counts["frame"] == traces["frame"] + 1
    assert _standing(mgr)["v"] != where["v"]       # the table moved


@pytest.mark.parametrize("table", ["float32", "int8"])
def test_fused_frame_equals_the_reference(table):
    """The scripted run through both managers, fed the same numpy frames
    and frequencies; frame 2's speculative update is over budget, which
    the reference discards and the port's rebuild overwrites. Bitwise
    after every call: modes, dirty counts, bytes, keep geometry, diff
    reference, EMA and keep state, int8 codes and scales. The float
    values of the tables are held to the parity tolerance of
    ``tests/test_torch_stream.py`` (the two packages' einsums round an
    ulp apart) and, on every rebuilt frame, bitwise to the port's
    scratch build: the speculation leaves nothing behind."""
    kw = {"table_dtype": table}
    mgr, plan = cases._mgr(kw, SCFG, backend="cuda_decode")
    rmgr = cases._ref_mgr(kw, SCFG, backend="cuda_decode")
    x = torch.zeros((2, N_IN, D))
    mgr.bind_input(x)
    exact = lambda got, want: np.testing.assert_array_equal(
        got.numpy(), np.asarray(want))

    def check(event):
        cache, rcache = mgr.cache, rmgr.cache
        for got, want in ((mgr.x_ref, rmgr.x_ref), (mgr.ema, rmgr.ema),
                          (cache.pix2slot, rcache.pix2slot),
                          (cache.keep_idx, rcache.keep_idx),
                          (cache.staged.remap, rcache.staged.remap)):
            exact(got, want)
        for field in ("keep_mask", "keep_idx", "pix2slot", "freq"):
            exact(getattr(mgr.fwp, field), getattr(rmgr.fwp, field))
            exact(getattr(mgr._cache_fwp, field),
                  getattr(rmgr._cache_fwp, field))
        if event != "step":
            return
        st, rst = mgr.last_stats, rmgr.last_stats
        for key in ("mode", "reason", "n_dirty", "tiles_changed",
                    "admitted_slots", "restaged_levels", "staged_bytes"):
            assert st[key] == rst[key], (key, st, rst)
        if table == "int8":
            exact(cache.v, rcache.v)
            exact(cache.staged.v, rcache.staged.v)
            np.testing.assert_allclose(cache.scale.numpy(),
                                       np.asarray(rcache.scale),
                                       rtol=1e-5, atol=1e-6)
        else:
            for got, want in ((cache.v, rcache.v),
                              (cache.staged.v, rcache.staged.v)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-6)
        if st["mode"] == "rebuild":
            cases._assert_cache_equal(cache, cases._scratch(mgr, plan, x))
            assert torch.equal(mgr.x_ref, x)
    modes = _scripted_run(mgr, x, check, ref=rmgr)
    assert ("rebuild", "dirty>budget", ()) in modes
    assert mgr.report() == rmgr.report()


@contextlib.contextmanager
def _host_reads_raise():
    def refuse(name):
        def raise_(*_a, **_k):
            raise AssertionError(f"host read Tensor.{name} in a graph body")
        return raise_
    names = ("item", "tolist", "__bool__", "__int__", "__float__", "cpu")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def test_graph_bodies_read_nothing_back_and_warm_up_once(monkeypatch):
    """Every path's body runs with the host reads refused; after a
    warm-up of every path, a second round of churn (close, open,
    admission, reorder, more frames) calls no path for the first time
    and builds no host constant."""
    ran = []
    real_run, real_call = StreamGraphs.run, StreamGraphs._call

    def run(self, fn, key, body):
        ran.append(fn)
        return real_run(self, fn, key, body)

    def call(self, body):
        with _host_reads_raise():
            return real_call(self, body)
    monkeypatch.setattr(StreamGraphs, "run", run)
    monkeypatch.setattr(StreamGraphs, "_call", call)

    mgr, _ = cases._mgr(None, SCFG, backend="cuda_decode")
    x = torch.zeros((2, N_IN, D))
    mgr.bind_input(x)
    _scripted_run(mgr, x)
    assert set(ran) == {"build", "frame", "restage", "hysteresis"}

    engine, _ = cases._engine(scfg=SCFG, backend="cuda_decode",
                              obs=Observability.create())
    scenes = [drifting_scene(s, LEVELS, D, 12) for s in (1, 2, 3, 4)]

    def churn(t0):
        sids = list(engine.sessions)
        engine.close_session(sids[-1])
        new = engine.open_session()
        for t in range(t0, t0 + 3):
            for k, sid in enumerate(engine.sessions):
                engine.submit_frame(sid, scenes[(sid + k) % 4][t][0])
            engine.step()
            if t == t0 + 1:
                engine.reorder_sessions()
        return new
    for _ in range(2):
        engine.open_session()
    for t in range(3):
        for sid in engine.sessions:
            engine.submit_frame(sid, scenes[sid][t][0])
        engine.step()
    churn(3)
    assert "decode" in ran
    counts = lambda: {fn: int(engine.mgr._m_traces.value(fn=fn))
                      for fn in ("build", "frame", "restage", "hysteresis",
                                 "decode")}
    warm, misses = counts(), bridge.host_constant_misses()
    assert engine.mgr.report()["frames"] == 6
    churn(6)
    churn(9)
    assert counts() == warm
    assert bridge.host_constant_misses() == misses
    assert any(r["stream"]["admitted_slots"]
               for s in engine.sessions.values() for r in s.results)


def test_engine_memory_is_the_managers_input_and_frames_are_copied_in():
    """The engine's static batch is the manager's standing input (no copy
    per step), idle slots keep their last memory, and a reorder permutes
    the batch in place."""
    engine, _ = cases._engine(scfg=SCFG)
    where = engine._memory.data_ptr()
    s0, s1 = engine.open_session(), engine.open_session()
    scene = drifting_scene(7, LEVELS, D, 3)
    engine.submit_frame(s0, scene[0][0])
    engine.submit_frame(s1, scene[1][0])
    engine.step()
    assert engine.mgr._x is engine._memory
    engine.submit_frame(s0, scene[2][0])
    engine.step()                                  # s1 idle
    assert torch.equal(engine._memory[0], torch.from_numpy(scene[2][0]))
    assert torch.equal(engine._memory[1], torch.from_numpy(scene[1][0]))
    engine.reorder_sessions()
    rows = {engine.sessions[s0].slot: scene[2][0],
            engine.sessions[s1].slot: scene[1][0]}
    for slot, want in rows.items():
        assert torch.equal(engine._memory[slot], torch.from_numpy(want))
    assert engine._memory.data_ptr() == where
    logits, boxes = engine.last_outputs
    assert logits.shape[:2] == boxes.shape[:2] == (2, 8)


def test_stream_graphs_count_first_calls_and_clear():
    """The graph set on the CPU: every call runs the body; the first
    call of each key is counted once, and again after ``clear``."""
    seen = []
    graphs = StreamGraphs(torch.device("cpu"), on_prepare=seen.append)
    assert not graphs.capture
    calls = []
    for key in ((2,), (2,), (1,)):
        assert graphs.run("frame", key, lambda: calls.append(1) or 7) == 7
    assert len(calls) == 3 and seen == ["frame", "frame"]
    graphs.clear()
    graphs.run("frame", (2,), lambda: None)
    assert seen == ["frame"] * 3 and len(graphs) == 0
