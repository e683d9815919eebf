"""Training launcher (port of ``repro/launch/train.py``, local mode).

One device, real optimizer steps, checkpoint/restart, straggler monitor:
the reference's control plane on one card, or on the CPU with
``--device cpu``. The reference's fleet mode (``--production-mesh``)
waits for the distributed port and raises.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --smoke --device cpu --steps 30 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import fold_in
from repro_torch.data.tokens import TokenDataConfig, synth_token_batch
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import FailureInjector, TrainLoopConfig, train_loop
from repro_torch.train.step import build_train_step, make_train_state


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
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh needs the distributed port (ROADMAP.md "
            "section 1, item 'Distributed'); this launcher runs on one device")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data_cfg = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=0)

    def stub_inputs(seed: int, step: int, n: int):
        """The stub frontend's embeddings: (batch, n, d_model) normals
        keyed by (seed, step), as the reference folds its key."""
        x = torch.randn((args.batch, n, cfg.d_model), generator=fold_in(seed, step))
        return x.to(device=dev, dtype=cfg.dtype)

    def batch_fn(step: int):
        b = synth_token_batch(data_cfg, step, device=dev)
        if cfg.family == "vlm":
            b["img_embeds"] = stub_inputs(7, step, cfg.n_img_tokens)
        if cfg.family == "encdec":
            b["frames"] = stub_inputs(8, step, cfg.enc_seq_len)
        return b

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    # weights drawn on the device itself: a published-width model on the card
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every, log_every=5)
    state, stats = train_loop(state, build_train_step(cfg, opt_cfg), batch_fn,
                              loop_cfg, ckpt_dir=args.ckpt_dir,
                              injector=injector)
    print(f"[train] done: final loss {stats['losses'][-1]:.4f}, "
          f"stragglers={stats['straggler_events']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
