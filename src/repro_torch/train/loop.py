"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler detection, deterministic data resume (port of
``repro/train/loop.py``).

Contract:
  * the loop ALWAYS starts from ``latest_step(ckpt_dir)`` if present: a
    crashed or preempted worker restarts where an uninterrupted run
    would be, because batches derive from (seed, step), not from an
    iterator's state;
  * :class:`FailureInjector` raises at a chosen step to simulate node
    loss;
  * per-step wall time is tracked against a rolling median: a step
    slower than ``straggler_factor`` x the median is logged as a
    straggler event.

A step's wall clock ends at a sync on its loss (``float``), the
counterpart of the reference's ``jax.block_until_ready``. A captured
step (``train.step.TrainStep``) owns a standing state: the loop hands
it the caller's state first and restores a checkpoint into it in place,
so that its graphs read the restored values."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          load_checkpoint, restore_into)
from repro_torch.train.step import TrainState, TrainStep


class SimulatedNodeFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    failed: bool = False

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step \
                and not self.failed:
            self.failed = True
            raise SimulatedNodeFailure(f"injected node failure at step {step}")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


def train_loop(
    state: TrainState,
    train_step: Callable,
    batch_fn: Callable[[int], Any],       # step -> batch (deterministic!)
    loop_cfg: TrainLoopConfig,
    ckpt_dir: Optional[str] = None,
    injector: Optional[FailureInjector] = None,
    log: Callable[[str], None] = print,
) -> tuple[TrainState, dict]:
    """Runs (resumes) training. Returns (final state, stats).

    stats: ``straggler_events``, ``losses`` (one per step run), as the
    reference's; ``start`` (the step it resumed from), ``history`` (per
    step: every metric as a float, ``step``, ``wall_ms`` and
    ``write_in_flight``, whether a checkpoint write was queued or running
    when the step began), and, with a ``ckpt_dir``, ``snapshot_s`` /
    ``write_s`` (each save's synchronous snapshot and threaded write)."""
    start = 0
    # a step of build_train_step: a checkpoint is restored into its
    # standing state, in place (no second state-sized copy, 17 GB for the
    # 2-layer minitron-4b); any other step callable copies a state that
    # is not its own in at its call
    standing = isinstance(train_step, TrainStep)
    if standing:
        state = train_step.adopt(state)
    if ckpt_dir is not None:
        last = latest_step(ckpt_dir)
        if last is not None:
            _, loaded = load_checkpoint(ckpt_dir, last)
            state = restore_into(state, loaded, in_place=standing)
            start = last
            log(f"[loop] restored checkpoint step={last}")
    ckpt = AsyncCheckpointer(ckpt_dir, keep=loop_cfg.keep_ckpts) \
        if ckpt_dir is not None else None

    times: list[float] = []
    stats = {"straggler_events": 0, "losses": [], "start": start,
             "history": []}
    try:
        for step in range(start, loop_cfg.total_steps):
            if injector is not None:
                injector.maybe_fail(step)
            in_flight = ckpt is not None and ckpt.busy
            t0 = time.monotonic()
            batch = batch_fn(step)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])          # syncs on the loss
            dt = time.monotonic() - t0
            times.append(dt)
            med = float(np.median(times[-32:]))
            if len(times) > 5 and dt > loop_cfg.straggler_factor * med:
                stats["straggler_events"] += 1
                log(f"[loop] STRAGGLER step={step} {dt:.3f}s vs median {med:.3f}s")
            stats["losses"].append(loss)
            row = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (torch.Tensor, float, int))}
            row.update(step=step, wall_ms=dt * 1e3, write_in_flight=in_flight)
            stats["history"].append(row)
            if step % loop_cfg.log_every == 0:
                log(f"[loop] step={step} loss={loss:.4f} ({dt:.2f}s)")
            next_step = step + 1
            if ckpt is not None and (next_step % loop_cfg.ckpt_every == 0
                                     or next_step == loop_cfg.total_steps):
                ckpt.save(next_step, state)
    finally:
        if ckpt is not None:
            ckpt.close()
            stats.update(snapshot_s=list(ckpt.snapshot_s),
                         write_s=list(ckpt.write_s))
    return state, stats
