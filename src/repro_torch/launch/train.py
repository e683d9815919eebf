"""Training launcher (port of ``repro/launch/train.py``).

Real optimizer steps, checkpoint/restart, straggler monitor: the
reference's control plane on one card, or on the CPU with ``--device
cpu``. Under ``torchrun`` (one rank per card, NCCL; gloo with ``--device
cpu``) it trains over the world: the local mesh ``(world, 1)`` named
("data", "model"), or with ``--production-mesh`` the reference's 16x16
mesh, which needs 256 ranks. The state is laid out by
``train_state_shardings`` and each rank trains on its rows of the batch
(``train.step.build_sharded_train_step``, eager). On one device the step
is ``train.step.build_train_step``'s, a CUDA graph on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --smoke --device cpu --steps 30 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch minitron-4b --smoke --steps 30
"""
from __future__ import annotations

import argparse
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.bridge import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import fold_in
from repro_torch.data.tokens import TokenDataConfig, synth_token_batch
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import FailureInjector, TrainLoopConfig, train_loop
from repro_torch.train.step import (
    build_sharded_train_step, build_train_step, local_batch, make_train_state,
    place_train_state, train_state_shardings)


def _join_world(device: str) -> torch.device:
    """Join the process group torchrun describes (its env:// variables);
    returns this rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(minutes=5))
    return resolve_device(dev)


def train_batch(cfg, data_cfg: TokenDataConfig, step: int, device) -> dict:
    """The launcher's batch of ``step``: data/tokens' batch, and for vlm
    and encdec the stub frontend's embeddings, (batch, n, d_model)
    normals keyed by (seed 7 / 8, step), as the reference folds its key."""
    dev = resolve_device(device)
    b = synth_token_batch(data_cfg, step, device=dev)

    def stub_inputs(seed: int, n: int):
        x = torch.randn((data_cfg.global_batch, n, cfg.d_model),
                        generator=fold_in(seed, step))
        return x.to(device=dev, dtype=cfg.dtype)
    if cfg.family == "vlm":
        b["img_embeds"] = stub_inputs(7, cfg.n_img_tokens)
    if cfg.family == "encdec":
        b["frames"] = stub_inputs(8, cfg.enc_seq_len)
    return b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated node failure at this step")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    in_world = "WORLD_SIZE" in os.environ or dist.is_initialized()
    dev = _join_world(args.device) if in_world else resolve_device(args.device)
    mesh = None
    if args.production_mesh or in_world:
        from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
        # the production mesh raises, as the reference's does, on a world
        # smaller than its 256 ranks (a process outside torchrun is a world
        # of one)
        mesh = make_production_mesh() if args.production_mesh \
            else make_local_mesh()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data_cfg = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=0)

    def batch_fn(step: int):
        b = train_batch(cfg, data_cfg, step, dev)
        return b if mesh is None else local_batch(b, mesh)

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    # weights drawn on the device itself: a published-width model on the card
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    if mesh is None:                 # captured on the card (CUDA graphs)
        step_fn = build_train_step(cfg, opt_cfg)
    else:
        specs = train_state_shardings(cfg, mesh, state)
        state = place_train_state(state, specs, mesh)
        step_fn = build_sharded_train_step(cfg, opt_cfg, mesh, specs)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every, log_every=5)
    state, stats = train_loop(state, step_fn, batch_fn, loop_cfg,
                              ckpt_dir=args.ckpt_dir, injector=injector)
    if mesh is not None:
        dist.barrier()              # rank 0 has written its checkpoints
    if mesh is None or dist.get_rank() == 0:
        print(f"[train] done: final loss {stats['losses'][-1]:.4f}, "
              f"stragglers={stats['straggler_events']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
