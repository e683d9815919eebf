"""Serving launcher: the continuous-batching engine over a (smoke or
full) arch (port of ``repro/launch/serve.py``), on the card unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --smoke --device cpu --requests 12 --max-batch 4

It refuses encdec, as the reference's launcher does, and vlm, whose
prefill needs image embeddings the engine does not take (the
reference's engine fails on it).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.registry import get_api
from repro_torch.serve.lm import (SERVED_FAMILIES, Request, ServeConfig,
                                  ServeEngine)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family not in SERVED_FAMILIES:
        raise SystemExit(f"serve launcher targets the decoder-only text "
                         f"families {SERVED_FAMILIES}; {args.arch} is "
                         f"{cfg.family!r} (run it through get_api(cfg))")
    dev = resolve_device(args.device)
    params = get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    engine = ServeEngine(cfg, params,
                         ServeConfig(max_batch=args.max_batch,
                                     cache_len=args.cache_len), device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        engine.submit(Request(rid=i,
                              prompt=rng.integers(0, cfg.vocab_size,
                                                  plen).astype(np.int32),
                              max_new_tokens=args.max_new))
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    total_toks = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {total_toks} tokens in {dt:.2f}s "
          f"({total_toks/dt:.1f} tok/s with continuous batching, {dev.type})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
