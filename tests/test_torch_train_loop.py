"""The port's LM training pieces and fault-tolerant loop against the JAX
reference (counterparts of tests/test_substrate.py's data, train-step,
checkpoint and restart tests), the detector trained through the loop,
and the training launcher.

Sizes: the reference's substrate model (2 layers, d_model 64, 4 query /
2 KV heads, d_ff 128, vocab 256, float32) on 8 x 32-token batches; the
detector at 32 px with 1 encoder block and 1 decoder layer of 8 queries.

Tolerances:
  * data: exact (determinism, shapes, ranges);
  * the LM train step against ``repro.train.step.build_train_step`` from
    converted params on the same numpy tokens: loss rtol 1e-5, params
    rtol = atol = 5e-4 after two steps (float32 sums in another order);
  * gradient accumulation against the full batch: the reference's rtol
    1e-5 on the loss and 5e-4 on the params;
  * crash and restart against an uninterrupted run: bitwise on the CPU
    (the reference holds itself to 1e-6), for the LM and the detector.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import tokens as rtokens  # noqa: E402
from repro.models.common import ModelConfig as RModelConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core.detector import init_detector  # noqa: E402
from repro_torch.data import fold_in  # noqa: E402
from repro_torch.data.tokens import (TokenDataConfig, synth_token_batch,  # noqa: E402
                                     token_stream)
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.optim.adamw import OptConfig, adamw_init, tree_leaves  # noqa: E402
from repro_torch.train import detr  # noqa: E402
from repro_torch.train.loop import (FailureInjector, SimulatedNodeFailure,  # noqa: E402
                                    TrainLoopConfig, train_loop)
from repro_torch.train.step import (TrainState, build_train_step,  # noqa: E402
                                    make_train_state)

torch.set_num_threads(1)

CFG_KW = dict(family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, remat=False)
CFG = ModelConfig(dtype=torch.float32, **CFG_KW)
RCFG = RModelConfig(dtype=jnp.float32, **CFG_KW)
DATA = TokenDataConfig(vocab_size=256, seq_len=32, global_batch=8, seed=3)
OPT_KW = dict(lr=1e-2, warmup_steps=2, total_steps=50, weight_decay=0.0)
OPT = OptConfig(**OPT_KW)
QUIET = dict(log=lambda s: None)


def _batch(step):
    return synth_token_batch(DATA, step, device="cpu")


def _state(cfg=CFG):
    return make_train_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _assert_bitwise(a_tree, b_tree):
    a, b = tree_leaves(a_tree), tree_leaves(b_tree)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_data_pipeline_deterministic_and_sharded():
    b1, b2 = _batch(7), _batch(7)
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], _batch(8)["tokens"])
    shards = [synth_token_batch(DATA, 7, shard_id=i, num_shards=4,
                                device="cpu")["tokens"] for i in range(4)]
    assert all(s.shape == (2, 33) for s in shards)
    assert not torch.equal(shards[0], shards[1])
    stream = token_stream(DATA, start_step=7, device="cpu")
    assert torch.equal(next(stream)["tokens"], b1["tokens"])
    assert torch.equal(next(stream)["tokens"], _batch(8)["tokens"])


def test_data_structure_follows_the_reference():
    """Ids in [0, min(vocab, 4096)), Zipf-heavy low ids, and the motif
    bank drawn from seed + 1 written n_insert times into every row."""
    big = TokenDataConfig(vocab_size=100_000, seq_len=255, global_batch=4,
                          seed=0)
    toks = synth_token_batch(big, 0, device="cpu")["tokens"]
    ref = np.asarray(rtokens.synth_token_batch(
        rtokens.TokenDataConfig(100_000, 255, 4, seed=0), 0)["tokens"])
    assert toks.shape == ref.shape == (4, 256)
    assert int(toks.max()) < 4096 and int(toks.min()) >= 0
    # rank-1 share of the Zipf(1.2) unigrams, port and reference alike
    share = float((toks == 0).float().mean())
    assert abs(share - float((ref == 0).mean())) < 0.1 and share > 0.1
    bank = torch.randint(0, 4096, (big.n_motifs, big.motif_len),
                         generator=torch.Generator().manual_seed(1))
    n_insert = 256 // (4 * big.motif_len)
    for row in toks:
        windows = row.unfold(0, big.motif_len, 1)          # (S - m + 1, m)
        hits = (windows[:, None, :] == bank[None]).all(-1).any(-1)
        assert 1 <= int(hits.sum()) <= n_insert


def test_fold_in_keys_are_independent_and_stable():
    a = torch.rand(4, generator=fold_in(3, 7))
    assert torch.equal(a, torch.rand(4, generator=fold_in(3, 7)))
    assert not torch.equal(a, torch.rand(4, generator=fold_in(3, 8)))
    assert not torch.equal(a, torch.rand(4, generator=fold_in(4, 7)))


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def test_training_loss_decreases():
    step = build_train_step(CFG, OPT)
    state, losses = _state(), []
    for i in range(15):
        state, m = step(state, _batch(i))
        losses.append(float(m["loss"]))
    assert int(state.step) == 15 and int(state.opt["step"]) == 15
    assert losses[-1] < losses[0] - 0.3, losses


def test_grad_accumulation_matches_full_batch():
    cfg4 = dataclasses.replace(CFG, grad_accum=4)
    s1, m1 = build_train_step(CFG, OPT)(_state(), _batch(0))
    s4, m4 = build_train_step(cfg4, OPT)(_state(cfg4), _batch(0))
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5, atol=1e-5)
    assert set(m4) == set(m1) >= {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    for a, c in zip(tree_leaves(s1.params), tree_leaves(s4.params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(accum):
    rcfg = dataclasses.replace(RCFG, grad_accum=accum)
    cfg = dataclasses.replace(CFG, grad_accum=accum)
    r_state = rstep.make_train_state(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, r_state.params),
                               device="cpu")
    state = TrainState(params, adamw_init(params),
                       torch.zeros((), dtype=torch.int32))
    r_step = jax.jit(rstep.build_train_step(rcfg, radamw.OptConfig(**OPT_KW)))
    step = build_train_step(cfg, OPT)
    data = rtokens.TokenDataConfig(vocab_size=256, seq_len=32, global_batch=8,
                                   seed=3)
    for i in range(2):
        tokens = np.array(rtokens.synth_token_batch(data, i)["tokens"])
        r_state, r_m = r_step(r_state, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]), rtol=1e-5,
                                       err_msg=k)
    assert int(state.step) == int(r_state.step) == 2
    for a, b in zip(tree_leaves(state.params), jax.tree.leaves(r_state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4,
                                   atol=5e-4)
    for a, b in zip(tree_leaves(state.opt["m"]), jax.tree.leaves(r_state.opt["m"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4,
                                   atol=5e-4)


# --------------------------------------------------------------------------
# checkpoint and restart
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state, _ = build_train_step(CFG, OPT)(_state(), _batch(0))
    store.save_checkpoint(str(tmp_path), 5, state)
    assert store.latest_step(str(tmp_path)) == 5
    step, loaded = store.load_checkpoint(str(tmp_path))
    restored = store.restore_into(_state(), loaded)
    assert isinstance(restored, TrainState) and step == 5
    _assert_bitwise(restored, state)


def test_failure_injection_and_restart_determinism(tmp_path):
    """Crash at step 7, restart from the step-5 checkpoint, and land
    bitwise where an uninterrupted run lands."""
    loop_cfg = TrainLoopConfig(total_steps=12, ckpt_every=5, log_every=100)
    # the uninterrupted run has a step of its own: a step's returned state
    # is its standing state, which the crashed run's step would rewrite
    ref, ref_stats = train_loop(_state(), build_train_step(CFG, OPT), _batch,
                                loop_cfg, ckpt_dir=None, **QUIET)
    step_fn = build_train_step(CFG, OPT)

    ckpt_dir = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedNodeFailure):
        train_loop(_state(), step_fn, _batch, loop_cfg, ckpt_dir=ckpt_dir,
                   injector=FailureInjector(fail_at_step=7), **QUIET)
    assert store.latest_step(ckpt_dir) == 5
    restarted, stats = train_loop(_state(), step_fn, _batch, loop_cfg,
                                  ckpt_dir=ckpt_dir, **QUIET)
    assert stats["start"] == 5 and len(stats["losses"]) == 7
    assert stats["losses"] == ref_stats["losses"][5:]
    _assert_bitwise(restarted, ref)
    assert store.latest_step(ckpt_dir) == 12
    assert len(stats["snapshot_s"]) == len(stats["write_s"]) == 2   # 10, 12


def test_loop_logs_history_and_keeps_checkpoints(tmp_path):
    loop_cfg = TrainLoopConfig(total_steps=6, ckpt_every=1, keep_ckpts=2,
                               log_every=100)
    state, stats = train_loop(_state(), build_train_step(CFG, OPT), _batch,
                              loop_cfg, ckpt_dir=str(tmp_path), **QUIET)
    assert [h["step"] for h in stats["history"]] == list(range(6))
    assert all({"loss", "grad_norm", "lr", "wall_ms", "write_in_flight"}
               <= set(h) for h in stats["history"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000005",
                                                          "step_00000006"]
    _, loaded = store.load_checkpoint(str(tmp_path))
    _assert_bitwise(store.restore_into(_state(), loaded), state)


def test_straggler_counted_when_a_step_is_slowed(monkeypatch):
    # the loop reads a clock that each step moves by 10 ms and the slowed
    # step by 500 ms, so that a busy host cannot add a straggler
    import types
    from repro_torch.train import loop
    clock = [0.0]
    monkeypatch.setattr(loop, "time",
                        types.SimpleNamespace(monotonic=lambda: clock[0]))
    step_fn = build_train_step(CFG, OPT)

    def slowed(state, batch):
        clock[0] += 0.5 if int(state.step) == 8 else 0.01
        return step_fn(state, batch)
    _, stats = train_loop(_state(), slowed, _batch,
                          TrainLoopConfig(total_steps=10, log_every=100),
                          **QUIET)
    assert stats["straggler_events"] == 1
    assert [r["step"] for r in stats["history"] if r["wall_ms"] > 100] == [8]


# --------------------------------------------------------------------------
# the detector through the loop
# --------------------------------------------------------------------------

def test_detector_train_loop_restart_is_bitwise(tmp_path):
    cfg = detr.train_config(img_size=32, n_blocks=1, n_layers=1, n_queries=8)
    run = dict(cfg=cfg, steps=4, batch=1, device="cpu", ckpt_every=1,
               **QUIET)
    ref, ref_stats = detr.train_detector(
        gen=torch.Generator().manual_seed(0), **run)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedNodeFailure):
        detr.train_detector(gen=torch.Generator().manual_seed(0),
                            ckpt_dir=ckpt, injector=FailureInjector(2), **run)
    assert store.latest_step(ckpt) == 2
    # a restart draws fresh weights from another seed: the checkpoint wins
    state, stats = detr.train_detector(gen=torch.Generator().manual_seed(9),
                                       ckpt_dir=ckpt, **run)
    assert stats["start"] == 2 and int(state.step) == 4
    assert stats["losses"] == ref_stats["losses"][2:]
    _assert_bitwise(state, ref)


def test_detector_api_step_is_the_detector_train_step():
    # train.step's builders with the detector's ModelAPI take the step
    # detr.train_step takes: the same state, metrics and params, bitwise
    cfg = detr.train_config(img_size=32, n_blocks=1, n_layers=1, n_queries=8)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    api = detr.detector_api("cuda_decode")
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu", api=api)
    params0 = init_detector(cfg, torch.Generator().manual_seed(0), "cpu")
    _assert_bitwise(state.params, params0)
    assert int(state.step) == 0
    batch = detr.detection_batches(cfg, 1, device="cpu")(0)
    new, metrics = build_train_step(cfg, opt_cfg, api)(state, batch)
    params, opt, want, _ = detr.train_step(params0, adamw_init(params0),
                                           batch, cfg, opt_cfg,
                                           backend="cuda_decode")
    assert int(new.step) == 1 and set(metrics) == set(want)
    for k in want:
        assert torch.equal(metrics[k], want[k]), k
    _assert_bitwise(new.params, params)
    _assert_bitwise(new.opt, opt)


def test_detection_batches_are_keyed_by_step():
    cfg = detr.train_config(img_size=32, n_blocks=1, n_layers=1, n_queries=8)
    draw = detr.detection_batches(cfg, 2, seed=5, device="cpu")
    a, b = draw(3), draw(3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[3]["box"], b[3]["box"])
    assert not torch.equal(draw(4)[0], a[0])


# --------------------------------------------------------------------------
# the launcher and the demo
# --------------------------------------------------------------------------

def test_launcher_crashes_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch
    argv = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SimulatedNodeFailure):
        launch.main(argv + ["--fail-at", "3"])
    assert store.latest_step(str(tmp_path)) == 2
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint step=2" in out and "[train] done" in out
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 "
                       "devices, found 1"):
        launch.main(argv + ["--production-mesh"])
    if not torch.cuda.is_available():           # the default is the card
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            launch.main(argv[:3])


def test_fault_tolerant_demo_is_bitwise_on_the_cpu():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_fault_tolerant_train.py"
    spec = importlib.util.spec_from_file_location("torch_ft_demo", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    r = demo.run("cpu", log=lambda s: None)
    assert r["resumed_from"] == 8
    assert r["losses_restarted"] == r["losses_reference"][8:]
    _assert_bitwise(r["restarted"], r["reference"])


def test_update_frees_its_tensors_without_the_cycle_collector():
    """A train step's gradients and states are freed as soon as the last
    reference goes, not when the cyclic garbage collector next runs: on
    the card they are gigabytes (the LM step at minitron-4b's widths ran
    out of memory while a reference cycle in ``tree_unflatten`` kept
    them). The step writes its standing state in place, so no state is
    superseded; dropping the step and its state frees every leaf."""
    import gc
    import weakref
    step = build_train_step(CFG, OPT)
    state = _state()
    enabled = gc.isenabled()
    gc.disable()
    try:
        new, metrics = step(state, _batch(0))
        refs = [weakref.ref(t) for t in tree_leaves(tuple(new))]
        again, metrics = step(new, _batch(1))
        assert all(a is b for a, b in zip(tree_leaves(tuple(again)),
                                          tree_leaves(tuple(new))))
        del new, again, metrics, step
        assert sum(r() is not None for r in refs) == 0
    finally:
        if enabled:
            gc.enable()
