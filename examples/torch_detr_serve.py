"""End-to-end driver of the PyTorch port: batched DETR serving with DEFA
(port of examples/detr_serve.py, without its --sustained mode, which
waits for the port of benchmarks/serve_sustained.py).

Streams batches of synthetic images through the conv backbone +
deformable encoder (+ optional DETR-style decoder) with the DEFA stack
enabled, and reports throughput, the realized pruning ratios and AP per
batch.

  PYTHONPATH=src python examples/torch_detr_serve.py --batches 4 --batch 8 [--device cpu]
  PYTHONPATH=src python examples/torch_detr_serve.py --decoder   # N_q learned
      queries cross-attend ONE shared value cache through the
      DetrServeEngine micro-batcher (one CUDA graph per bucket on the card)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.detector import detector_apply
from repro_torch.data import fold_in
from repro_torch.data.detection import eval_detection_ap, synth_detection_batch
from repro_torch.msda import available_backends, make_plan
from repro_torch.serve import DetrRequest, DetrServeEngine
from repro_torch.train.detr import (train_toy_decoder_detector,
                                    train_toy_detector, with_attn)

DEFA_KW = dict(pap_mode="topk", pap_keep=6,
               fwp_mode="compact", fwp_k=1.0, fwp_capacity=0.6,
               range_narrow=(8.0, 6.0, 4.0, 3.0),
               act_bits=12, weight_bits=12)
SEED = 42


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_encoder_head(args) -> None:
    cfg, params = train_toy_detector(device=args.device)
    serve_cfg = with_attn(cfg, **DEFA_KW)
    dev = params["stem"]["w"].device

    plan = make_plan(serve_cfg.encoder.attn, serve_cfg.level_shapes,
                     backend=args.backend, device=dev)
    print(f"[serve] {plan.describe()}")

    def fwd(img):
        with torch.no_grad():
            return detector_apply(params, serve_cfg, img, collect_stats=True,
                                  backend=args.backend)

    img, _, _, _ = synth_detection_batch(fold_in(SEED, 0), args.batch,
                                         cfg.img_size, cfg.level_shapes,
                                         device=dev)
    fwd(img)                                          # warm-up: kernels build
    _sync(dev)

    total = 0
    t0 = time.perf_counter()
    aps = []
    for i in range(args.batches):
        img, _, _, gt = synth_detection_batch(fold_in(SEED, i), args.batch,
                                              cfg.img_size, cfg.level_shapes,
                                              device=dev)
        cls, box, aux = fwd(img)
        _sync(dev)
        total += args.batch
        aps.append(eval_detection_ap(cls, box, gt))
        keep = [float(b["pap_keep_frac"]) for b in aux["blocks"]]
        fwp = [float(b["fwp_keep_frac"]) for b in aux["blocks"][:-1]]
        print(f"batch {i}: PAP kept {np.mean(keep):.1%} of sampling points, "
              f"FWP kept {np.mean(fwp):.1%} of pixels, AP={aps[-1]:.3f}")
    dt = time.perf_counter() - t0
    print(f"\n[serve] {total} images in {dt:.2f}s = {total/dt:.2f} img/s "
          f"({dev.type}), mean AP {np.mean(aps):.3f}")


def serve_decoder_head(args) -> None:
    """Decoder-head serving through the DetrServeEngine micro-batcher:
    the value table is projected + FWP-compacted ONCE per forward and all
    decoder layers sample the shared cache."""
    cfg, params = train_toy_decoder_detector(device=args.device)
    serve_cfg = with_attn(cfg, **DEFA_KW)

    engine = DetrServeEngine(serve_cfg, params, max_batch=args.batch,
                             backend=args.backend, device=args.device)
    print(f"[serve/decoder] {engine.describe()}")

    rid = 0
    gts = []
    for i in range(args.batches):
        img, _, _, gt = synth_detection_batch(fold_in(SEED, i), args.batch,
                                              cfg.img_size, cfg.level_shapes,
                                              device="cpu")
        gts.append(gt)
        for b in range(args.batch):
            engine.submit(DetrRequest(rid=rid, image=img[b].numpy()))
            rid += 1
    engine.step()                                     # first batch untimed
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    engine.close()

    # per-batch AP from the completed requests (submit order == rid order;
    # eval_detection_ap softmaxes its logits input, so feed log(probs))
    by_rid = {r.rid: r for r in done}
    aps = []
    for i, gt in enumerate(gts):
        reqs = [by_rid[i * args.batch + b] for b in range(args.batch)]
        logp = np.log(np.clip(np.stack([r.cls_probs for r in reqs]),
                              1e-9, None))
        aps.append(eval_detection_ap(logp,
                                     np.stack([r.boxes for r in reqs]), gt))
    timed = len(done) - args.batch
    print(f"[serve/decoder] {len(done)} requests ({timed} timed) in "
          f"{dt:.2f}s = {timed/max(dt, 1e-9):.2f} img/s, "
          f"mean AP {np.mean(aps):.3f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--backend", default=None,
                    choices=available_backends() + ["auto"],
                    help="MSDA backend override (default: plan from config)")
    ap.add_argument("--decoder", action="store_true",
                    help="serve the decoder-head detector (shared "
                         "value cache, build-once sample-everywhere)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.decoder:
        serve_decoder_head(args)
    else:
        serve_encoder_head(args)


if __name__ == "__main__":
    main()
