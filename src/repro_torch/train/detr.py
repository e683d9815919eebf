"""Train and evaluate the deformable-DETR detector on synthetic boxes
(port of benchmarks/detr_toy.py: value-and-grad of the detection loss,
then an AdamW update, through the fault-tolerant loop; the toy configs,
their cached trainers and the AP evaluation).

    PYTHONPATH=src python -m repro_torch.train.detr --device cpu --img 64 \
        --blocks 2 --layers 2 --queries 30 --steps 3 [--ckpt-dir DIR \
        --ckpt-every 1 --fail-at 2]

Routing: the decoder's cross-attention trains through ``cuda_decode``
(kernel K2, forward and backward), the encoder through ``torch_gather``,
which :func:`train_config` sets as the encoder's own backend: the raster
kernels K1 and K3 have no backward, in the reference as in the port. On
CPU tensors every kernel wrapper takes its plain version.

Training runs through :func:`repro_torch.train.loop.train_loop` on a
:class:`~repro_torch.train.step.TrainState`: with a ``ckpt_dir`` it
checkpoints every ``ckpt_every`` steps and resumes from the newest
checkpoint, and each step's batch is drawn from a generator keyed by
(seed, step), so a restarted run sees the batches an uninterrupted one
sees. The trained toy detectors are cached as checkpoint-store
directories under ``results/`` (the reference caches a pickle)."""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.checkpoint.store import (latest_step, load_checkpoint,
                                          restore_into, save_checkpoint)
from repro_torch.core.detector import (DetectorConfig, decoder_detection_loss,
                                       decoder_loss_device,
                                       decoder_loss_given_owner,
                                       detection_loss, detector_apply,
                                       detector_logical_axes, hungarian_owners,
                                       init_detector, matcher_kind)
from repro_torch.core.encoder import EncoderConfig
from repro_torch.core.msdeform_attn import MSDeformAttnConfig
from repro_torch.data import fold_in
from repro_torch.data.detection import eval_detection_ap, synth_detection_batch
from repro_torch.msda.decoder import MSDADecoderConfig
from repro_torch.models.registry import ModelAPI
from repro_torch.optim.adamw import OptConfig, adamw_update
from repro_torch.train.loop import (FailureInjector, TrainLoopConfig,
                                    train_loop)
from repro_torch.train.step import (LossSplit, build_train_step,
                                    make_train_state, value_and_grad)

#: The encoder's backend while training: differentiable.
TRAIN_ENCODER_BACKEND = "torch_gather"
#: checkpoint-store directories of the trained toy detectors
CKPT = "results/toy_detector_torch"
CKPT_DEC = "results/toy_decoder_detector_torch"


def train_config(name: str = "deformable-detr-defa", img_size: int = 512, *,
                 n_blocks: Optional[int] = None, n_layers: Optional[int] = None,
                 n_queries: Optional[int] = None) -> DetectorConfig:
    """A family config (``configs/detr_family.py``) as the trainer runs
    it: float32 compute and table, the 5-conv backbone at width 32, 4
    classes, the decoder head (6 layers of 300 queries unless cut), and
    ``torch_gather`` as the encoder's own backend."""
    from repro_torch.configs.detr_family import CONFIGS, with_dtype
    enc = with_dtype(CONFIGS[name].encoder, torch.float32)
    enc = dataclasses.replace(
        enc, n_blocks=n_blocks or enc.n_blocks,
        attn=dataclasses.replace(enc.attn, backend=TRAIN_ENCODER_BACKEND))
    dec = MSDADecoderConfig()
    dec = dataclasses.replace(dec, n_layers=n_layers or dec.n_layers,
                              n_queries=n_queries or dec.n_queries)
    return DetectorConfig(encoder=enc, img_size=img_size, n_classes=4,
                          backbone_width=32, decoder=dec)


def toy_config(**attn_kw) -> DetectorConfig:
    """The reference's toy detector: d_model 64, 4 heads, 4 levels x 4
    points, 2 encoder blocks (d_ffn 128), 64 px, 4 classes, backbone 24."""
    attn = MSDeformAttnConfig(d_model=64, n_heads=4, n_levels=4, n_points=4,
                              **attn_kw)
    return DetectorConfig(
        encoder=EncoderConfig(attn=attn, n_blocks=2, d_ffn=128),
        img_size=64, n_classes=4, backbone_width=24)


def toy_decoder_config(n_layers: int = 3, n_queries: int = 24,
                       **attn_kw) -> DetectorConfig:
    """Toy detector with the DETR-style decoder head (shared ValueCache)."""
    cfg = toy_config(**attn_kw)
    return dataclasses.replace(
        cfg, decoder=MSDADecoderConfig(n_layers=n_layers,
                                       n_queries=n_queries, d_ffn=128))


def with_attn(cfg: DetectorConfig, **attn_kw) -> DetectorConfig:
    attn = dataclasses.replace(cfg.encoder.attn, **attn_kw)
    enc = dataclasses.replace(cfg.encoder, attn=attn)
    return dataclasses.replace(cfg, encoder=enc)


def _detection_loss(params: Any, cfg: DetectorConfig, batch, backend):
    img, tgt_cls, tgt_box, gt = batch
    if cfg.decoder is None:
        return detection_loss(params, cfg, img, tgt_cls, tgt_box,
                              backend=backend)
    return decoder_detection_loss(params, cfg, img, gt["cls"], gt["box"],
                                  gt["active"], backend=backend)


def loss_and_grads(params: Any, cfg: DetectorConfig, batch, *,
                   backend: Optional[str] = None):
    """Value and gradient of the detector's loss on ``batch``, the tuple
    :func:`synth_detection_batch` returns: :func:`decoder_detection_loss`
    for the decoder head, :func:`detection_loss` for the dense head.
    Returns (loss, {"cls_loss", "box_loss"}, grads shaped like params);
    a leaf the loss does not reach gets zeros, as ``jax.grad`` gives."""
    (loss, extras), grads = value_and_grad(_detection_loss, params, cfg,
                                           batch, backend)
    return loss, extras, grads


def train_step(params: Any, opt: dict, batch, cfg: DetectorConfig,
               opt_cfg: OptConfig, *, backend: Optional[str] = None):
    """One functional step: :func:`loss_and_grads`, then
    :func:`adamw_update` (new tensors, the inputs untouched). The
    trainers run the captured step (``build_train_step`` with
    :func:`detector_api`), which this is the oracle of. Returns (params,
    opt, metrics {loss, cls_loss, box_loss, grad_norm, lr}, grads);
    metrics are 0-dim tensors on the params' device."""
    loss, extras, grads = loss_and_grads(params, cfg, batch, backend=backend)
    params, opt, metrics = adamw_update(params, grads, opt, opt_cfg)
    return params, opt, {"loss": loss, **extras, **metrics}, grads


def _loss_split(cfg: DetectorConfig, batch, backend) -> Optional[LossSplit]:
    """The decoder head's loss split at the Hungarian matcher (the
    reference's ``pure_callback``, ``repro/core/detector.py``); None for
    the dense head and the greedy matcher, which have no host stage."""
    gt = batch[3]
    if cfg.decoder is None or matcher_kind(
            None, gt["box"].shape[1], cfg.decoder.n_queries) != "hungarian":
        return None

    def device(params, cfg, batch):
        img, _, _, gt = batch
        cls_logits, boxes, cost, _ = decoder_loss_device(
            params, cfg, img, gt["box"], gt["active"], backend=backend)
        return (cls_logits, boxes), cost

    def finish(carry, owner, cfg, batch):
        gt = batch[3]
        return decoder_loss_given_owner(*carry, owner, gt["cls"], gt["box"],
                                        gt["active"], cfg.n_classes)
    return LossSplit(device=device, host=hungarian_owners, finish=finish)


def detector_api(backend: Optional[str] = "cuda_decode") -> ModelAPI:
    """The detector as :mod:`repro_torch.train.step` takes a model:
    ``init_detector`` and the detection loss through ``backend``, for
    ``make_train_state(cfg, gen, device=..., api=...)`` and
    ``build_train_step(cfg, opt_cfg, api)``; ``loss_split`` splits the
    decoder head's loss at its host matcher, so that the captured step
    replays two graphs around it. A detector has no cache, so the
    serving entries are None."""
    return ModelAPI(
        init=init_detector,
        loss_fn=lambda params, cfg, batch: _detection_loss(params, cfg, batch,
                                                           backend),
        forward=None, init_cache=None, prefill=None, decode_step=None,
        axes=detector_logical_axes,
        loss_split=lambda cfg, batch: _loss_split(cfg, batch, backend))


def detection_batches(cfg: DetectorConfig, batch: int, seed: int = 0,
                      device="cuda") -> Callable[[int], tuple]:
    """step -> the synthetic batch of that step, drawn from a generator
    keyed by (seed, step): the same batch however often it is asked."""
    dev = resolve_device(device)
    return lambda step: synth_detection_batch(
        fold_in(seed, step), batch, cfg.img_size, cfg.level_shapes,
        cfg.n_classes, device=dev)


def train_detector(cfg: DetectorConfig, steps: int, batch: int,
                   gen: Optional[torch.Generator] = None, device="cuda",
                   backend: Optional[str] = "cuda_decode",
                   opt_cfg: Optional[OptConfig] = None,
                   log: Callable[[str], None] = print, *, seed: int = 0,
                   ckpt_dir: Optional[str] = None,
                   ckpt_every: Optional[int] = None,
                   injector: Optional[FailureInjector] = None,
                   log_every: int = 1):
    """Train from random weights drawn from ``gen`` (default seed 0) for
    ``steps`` steps through :func:`train_loop`, step i on the batch
    :func:`detection_batches` draws for (seed, i), each step the captured
    step of ``build_train_step``. With ``ckpt_dir``, resume from its
    newest checkpoint and write one every ``ckpt_every`` steps (default:
    at the end). Returns (final TrainState, the loop's stats: per-step
    ``history`` rows with every metric and wall ms)."""
    dev = resolve_device(device)
    api = detector_api(backend)
    state = make_train_state(cfg, gen, device=dev, api=api)
    opt_cfg = opt_cfg or OptConfig(lr=2e-3, warmup_steps=10, total_steps=steps,
                                   weight_decay=0.0)
    loop_cfg = TrainLoopConfig(total_steps=steps,
                               ckpt_every=ckpt_every or steps,
                               log_every=log_every)
    return train_loop(state, build_train_step(cfg, opt_cfg, api),
                      detection_batches(cfg, batch, seed, dev), loop_cfg,
                      ckpt_dir=ckpt_dir, injector=injector, log=log)


def train_toy(cfg: DetectorConfig, steps: int, batch: int = 8, seed: int = 0,
              *, backend: Optional[str] = "cuda_decode", device="cuda",
              log: Callable[[str], None] = print):
    """The reference's toy recipe (its jitted ``step_fn``,
    benchmarks/detr_toy.py): weights from ``seed``, step i on the batch
    drawn for (seed, i), AdamW at lr 2e-3 with 10 warmup steps and no
    decay, the encoder through ``torch_gather``. Returns (state, stats)
    as :func:`train_detector` does."""
    return train_detector(with_attn(cfg, backend=TRAIN_ENCODER_BACKEND),
                          steps, batch, torch.Generator().manual_seed(seed),
                          device, backend, log=log, seed=seed, log_every=20)


def _cached_toy(cfg: DetectorConfig, cache: Optional[str], steps: int,
                batch: int, seed: int, backend: str, device, force: bool,
                log: Callable[[str], None]):
    """The toy trained for ``steps`` steps, from ``cache`` when it holds
    exactly that step, else trained by :func:`train_toy` and stored
    there."""
    dev = resolve_device(device)
    if cache is not None and not force and latest_step(cache) == steps:
        _, loaded = load_checkpoint(cache, steps)
        return restore_into(init_detector(cfg, device=dev), loaded)
    state, _ = train_toy(cfg, steps, batch, seed, backend=backend, device=dev,
                         log=log)
    if cache is not None:
        save_checkpoint(cache, steps, state.params)
    return state.params


def train_toy_detector(steps: int = 80, batch: int = 8, seed: int = 0,
                       log=print, force: bool = False, *, device="cuda",
                       cache: Optional[str] = CKPT):
    """The dense-head toy detector trained for 80 steps (cached)."""
    cfg = toy_config()
    return cfg, _cached_toy(cfg, cache, steps, batch, seed, "torch_gather",
                            device, force, log)


def train_toy_decoder_detector(steps: int = 400, batch: int = 8,
                               seed: int = 0, log=print, force: bool = False,
                               *, device="cuda",
                               cache: Optional[str] = CKPT_DEC):
    """The decoder-head toy detector (set-prediction loss, Hungarian
    matching) trained for 400 steps at B 8, lr 2e-3 (cached): the
    decoder's cross-attention through ``cuda_decode`` (K2)."""
    cfg = toy_decoder_config()
    return cfg, _cached_toy(cfg, cache, steps, batch, seed, "cuda_decode",
                            device, force, log)


def eval_ap(cfg: DetectorConfig, params, n_batches: int = 4, batch: int = 8,
            seed: int = 100, *, backend: Optional[str] = None) -> float:
    """Mean :func:`eval_detection_ap` of ``detector_apply`` over
    ``n_batches`` batches drawn for (seed, i), on the params' device."""
    from repro_torch.optim.adamw import tree_leaves
    dev = tree_leaves(params)[0].device
    aps = []
    for i in range(n_batches):
        img, _, _, gt = synth_detection_batch(fold_in(seed, i), batch,
                                              cfg.img_size, cfg.level_shapes,
                                              cfg.n_classes, device=dev)
        with torch.no_grad():
            cl, bx, _ = detector_apply(params, cfg, img, backend=backend)
        aps.append(eval_detection_ap(cl, bx, gt, n_classes=cfg.n_classes))
    return float(np.mean(aps))


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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated node failure at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = train_config("deformable-detr-defa", args.img, n_blocks=args.blocks,
                       n_layers=args.layers, n_queries=args.queries)
    t0 = time.perf_counter()
    state, stats = train_detector(
        cfg, args.steps, args.batch, torch.Generator().manual_seed(args.seed),
        args.device, seed=args.seed, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        injector=FailureInjector(args.fail_at) if args.fail_at else None)
    print(f"[train] done: step {int(state.step)}, final loss "
          f"{stats['losses'][-1]:.4f}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
