"""Fault-tolerant LM training demo of the PyTorch port: checkpoint/restart
across an injected node failure, landing where an uninterrupted run
lands (port of examples/fault_tolerant_train.py).

  PYTHONPATH=src python examples/torch_fault_tolerant_train.py [--device cpu]

On the card, bitwise equality needs deterministic kernels:
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``--deterministic``).
"""
import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenDataConfig, synth_token_batch
from repro_torch.optim.adamw import OptConfig, tree_leaves
from repro_torch.train.loop import (
    FailureInjector, SimulatedNodeFailure, TrainLoopConfig, train_loop)
from repro_torch.train.step import build_train_step, make_train_state


def run(device, log=print, capture=True) -> dict:
    """Crash at 13 of 24 steps, restart, and an uninterrupted run; returns
    the restarted and the uninterrupted final states and losses. Runs A
    and A' share one captured step (the restart lands in its standing
    state); run B, the reference, has a step of its own, as another
    process would (``capture=False``: both steps run eagerly)."""
    dev = resolve_device(device)
    cfg = get_smoke_config("deepseek-7b")
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8, seed=1)
    opt = OptConfig(lr=3e-3, warmup_steps=3, total_steps=24)
    loop_cfg = TrainLoopConfig(total_steps=24, ckpt_every=8, log_every=4)
    step_fn = build_train_step(cfg, opt, capture=capture)
    batch_fn = lambda s: synth_token_batch(data, s, device=dev)
    fresh = lambda: make_train_state(cfg, torch.Generator().manual_seed(0),
                                     device=dev)

    ckpt_dir = tempfile.mkdtemp(prefix="ft_demo_")
    try:
        log("=== run A: crash injected at step 13 ===")
        try:
            train_loop(fresh(), step_fn, batch_fn, loop_cfg, ckpt_dir=ckpt_dir,
                       injector=FailureInjector(fail_at_step=13), log=log)
        except SimulatedNodeFailure as e:
            log(f"!! {e} — node lost, restarting from checkpoint")

        log("=== run A': restart (fresh process state + checkpoint) ===")
        state2, stats2 = train_loop(fresh(), step_fn, batch_fn, loop_cfg,
                                    ckpt_dir=ckpt_dir, log=log)

        log("=== run B: uninterrupted reference ===")
        ref, stats_ref = train_loop(fresh(), build_train_step(
            cfg, opt, capture=capture), batch_fn, loop_cfg, ckpt_dir=None,
            log=log)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"restarted": state2, "reference": ref,
            "losses_restarted": stats2["losses"],
            "losses_reference": stats_ref["losses"],
            "resumed_from": stats2["start"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic CUDA kernels (bitwise restarts)")
    args = ap.parse_args()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    r = run(args.device)
    leaves = zip(tree_leaves(r["restarted"].params),
                 tree_leaves(r["reference"].params))
    deltas = [float((a.float() - b.float()).abs().max()) for a, b in leaves]
    print(f"\nmax param delta (restarted vs uninterrupted): {max(deltas):.2e}")
    assert max(deltas) < 1e-5, "restart must be deterministic!"
    print("crash -> restart -> IDENTICAL final params  [OK]")


if __name__ == "__main__":
    main()
