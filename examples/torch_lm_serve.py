"""Continuous-batching LM serving demo of the PyTorch port (port of
examples/lm_serve.py): a smoke-scale arch of a text-only family
(dense, moe, ssm, hybrid) with mixed prompt lengths; requests enter and
leave slots while decode proceeds, each attention layer's decode through
kernel K5 (its plain version on the CPU).

  PYTHONPATH=src python examples/torch_lm_serve.py --arch granite-20b [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.registry import get_api
from repro_torch.serve.lm import (SERVED_FAMILIES, Request, ServeConfig,
                                  ServeEngine)

#: the architectures whose family the engine serves (vlm and encdec need
#: image embeddings or frames besides the tokens)
SERVED_ARCHS = [a for a in ARCH_IDS
                if get_smoke_config(a).family in SERVED_FAMILIES]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b", choices=SERVED_ARCHS)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = get_api(cfg).init(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    engine = ServeEngine(cfg, params, ServeConfig(max_batch=4, cache_len=96),
                         device=dev)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 32))
        engine.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                         plen).astype(np.int32),
                              max_new_tokens=int(rng.integers(8, 24))))
    t0 = time.perf_counter()
    steps = 0
    while engine.queue or engine.active.any() or steps == 0:
        n_active = engine.step()
        steps += 1
        if steps % 8 == 0:
            print(f"step {steps}: {n_active} active slots, "
                  f"{len(engine.queue)} queued, {len(engine.finished)} done")
        if steps > 500:
            break
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in engine.finished)
    print(f"\n[lm-serve] {len(engine.finished)}/{args.requests} requests, "
          f"{toks} tokens, {steps} engine steps, {toks/dt:.1f} tok/s "
          f"({dev.type})")


if __name__ == "__main__":
    main()
