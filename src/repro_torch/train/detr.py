"""Train the deformable-DETR detector on synthetic boxes (port of the
training loops of benchmarks/detr_toy.py: value-and-grad of the detection
loss, then an AdamW update).

    PYTHONPATH=src python -m repro_torch.train.detr --device cpu --img 64 \
        --blocks 2 --layers 2 --queries 30 --steps 3

Routing: the decoder's cross-attention trains through ``cuda_decode``
(kernel K2, forward and backward), the encoder through ``torch_gather``,
which :func:`train_config` sets as the encoder's own backend: the raster
kernels K1 and K3 have no backward, in the reference as in the port. On
CPU tensors every kernel wrapper takes its plain version. There is no
checkpointing yet."""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.bridge import resolve_device
from repro_torch.core.detector import (DetectorConfig, decoder_detection_loss,
                                       detection_loss, init_detector)
from repro_torch.data.detection import synth_detection_batch
from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_unflatten)

#: The encoder's backend while training: differentiable.
TRAIN_ENCODER_BACKEND = "torch_gather"


def train_config(name: str = "deformable-detr-defa", img_size: int = 512, *,
                 n_blocks: Optional[int] = None, n_layers: Optional[int] = None,
                 n_queries: Optional[int] = None) -> DetectorConfig:
    """A family config (``configs/detr_family.py``) as the trainer runs
    it: float32 compute and table, the 5-conv backbone at width 32, 4
    classes, the decoder head (6 layers of 300 queries unless cut), and
    ``torch_gather`` as the encoder's own backend."""
    from repro_torch.configs.detr_family import CONFIGS, with_dtype
    from repro_torch.msda.decoder import MSDADecoderConfig
    enc = with_dtype(CONFIGS[name].encoder, torch.float32)
    enc = dataclasses.replace(
        enc, n_blocks=n_blocks or enc.n_blocks,
        attn=dataclasses.replace(enc.attn, backend=TRAIN_ENCODER_BACKEND))
    dec = MSDADecoderConfig()
    dec = dataclasses.replace(dec, n_layers=n_layers or dec.n_layers,
                              n_queries=n_queries or dec.n_queries)
    return DetectorConfig(encoder=enc, img_size=img_size, n_classes=4,
                          backbone_width=32, decoder=dec)


def loss_and_grads(params: Any, cfg: DetectorConfig, batch, *,
                   backend: Optional[str] = None):
    """Value and gradient of the detector's loss on ``batch``, the tuple
    :func:`synth_detection_batch` returns: :func:`decoder_detection_loss`
    for the decoder head, :func:`detection_loss` for the dense head.
    Returns (loss, {"cls_loss", "box_loss"}, grads shaped like params);
    a leaf the loss does not reach gets zeros, as ``jax.grad`` gives."""
    img, tgt_cls, tgt_box, gt = batch
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, live)
    with torch.enable_grad():
        if cfg.decoder is None:
            loss, extras = detection_loss(tree, cfg, img, tgt_cls, tgt_box,
                                          backend=backend)
        else:
            loss, extras = decoder_detection_loss(
                tree, cfg, img, gt["cls"], gt["box"], gt["active"],
                backend=backend)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in extras.items()},
            tree_unflatten(params, grads))


def train_step(params: Any, opt: dict, batch, cfg: DetectorConfig,
               opt_cfg: OptConfig, *, backend: Optional[str] = None):
    """One step: :func:`loss_and_grads`, then :func:`adamw_update`.
    Returns (params, opt, metrics {loss, cls_loss, box_loss, grad_norm,
    lr}, grads); metrics are 0-dim tensors on the params' device."""
    loss, extras, grads = loss_and_grads(params, cfg, batch, backend=backend)
    params, opt, metrics = adamw_update(params, grads, opt, opt_cfg)
    return params, opt, {"loss": loss, **extras, **metrics}, grads


def train_detector(cfg: DetectorConfig, steps: int, batch: int,
                   gen: Optional[torch.Generator] = None, device="cuda",
                   backend: Optional[str] = "cuda_decode",
                   opt_cfg: Optional[OptConfig] = None,
                   log: Callable[[str], None] = print):
    """Train from random weights drawn from ``gen`` (default seed 0) for
    ``steps`` steps, a fresh synthetic batch each step. Returns (params,
    history of per-step metric dicts, with wall ms)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0) if gen is None else gen
    params = init_detector(cfg, gen, dev)
    opt = adamw_init(params)
    opt_cfg = opt_cfg or OptConfig(lr=2e-3, warmup_steps=10, total_steps=steps,
                                   weight_decay=0.0)
    history = []
    for i in range(steps):
        data = synth_detection_batch(gen, batch, cfg.img_size, cfg.level_shapes,
                                     cfg.n_classes, device=dev)
        t0 = time.perf_counter()
        params, opt, metrics, _ = train_step(params, opt, data, cfg, opt_cfg,
                                             backend=backend)
        row = {k: float(v) for k, v in metrics.items()}
        row.update(step=i, wall_ms=(time.perf_counter() - t0) * 1e3)
        history.append(row)
        log(json.dumps(row))
    return params, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--blocks", type=int, default=None,
                    help="encoder blocks (default: the config's 6)")
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers (default 6)")
    ap.add_argument("--queries", type=int, default=None,
                    help="decoder queries (default 300)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = train_config("deformable-detr-defa", args.img, n_blocks=args.blocks,
                       n_layers=args.layers, n_queries=args.queries)
    train_detector(cfg, args.steps, args.batch,
                   torch.Generator().manual_seed(args.seed), args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
