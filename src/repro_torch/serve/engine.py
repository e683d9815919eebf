"""Continuous-batching DETR serving over shape buckets (port of
``DetrServeEngine`` from repro/serve/engine.py).

Requests queue per resolution bucket; every :meth:`DetrServeEngine.step`
dispatches the deepest bucket's micro-batch, zero-padded to the static
``max_batch``, through :func:`repro_torch.core.detector.detector_apply`
on the engine's device, and hands the device outputs to the
post-processing stage (a worker thread when pipelined). Every forward
builds ONE shared value cache from the encoder memory and all decoder
layers sample it.

Left for the serving slice: telemetry (``obs/``), the autotuned plan
table, and ahead-of-time capture of each bucket's forward (CUDA graphs).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.bridge import resolve_device, tree_to
from repro_torch.serve.buckets import BucketRouter, derive_buckets
from repro_torch.serve.postproc import (PostprocWorker, StarvationError,
                                        softmax_np, topk_detections)


@dataclasses.dataclass
class DetrRequest:
    rid: int
    image: np.ndarray                     # (3, H, W) float32, H/W <= bucket
    # filled by the engine:
    cls_probs: Optional[np.ndarray] = None    # (Nq, C+1) softmax
    boxes: Optional[np.ndarray] = None        # (Nq, 4) cxcywh
    detections: Optional[dict] = None         # top-k decode (postproc stage)
    done: bool = False
    bucket: Optional[int] = None              # resolution routed to
    error: Optional[str] = None               # admission rejection reason
    callback: Optional[Callable] = None       # invoked on completion
    t_submit: float = 0.0
    t_done: float = 0.0


class DetrServeEngine:
    """Bucketed continuous-batching DETR detection server.

    ``resolutions`` selects the buckets (default: one at
    ``cfg.img_size``); ``params`` are moved to ``device`` — the card
    unless the caller passes ``device="cpu"``. ``submit`` routes (and may
    reject) immediately; ``step`` dispatches one micro-batch."""

    def __init__(self, cfg, params, *, max_batch: int = 8,
                 backend: Optional[str] = None,
                 resolutions: Optional[tuple] = None,
                 pipeline_postproc: bool = True, topk: int = 5,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.max_batch = int(max_batch)
        self.backend = backend
        self.topk = int(topk)
        if resolutions is None:
            resolutions = (cfg.img_size,)
        self.buckets = derive_buckets(cfg, resolutions, backend=backend)
        self.router = BucketRouter(self.buckets)
        self._bucket_by_res = {b.resolution: b for b in self.buckets}
        self.queues: dict = {b.resolution: deque() for b in self.buckets}
        self.finished: list = []
        self.rejected: list = []
        self.batches_dispatched = 0
        self._lock = threading.Lock()
        self._post = PostprocWorker(self._complete,
                                    pipelined=pipeline_postproc)

    def pending(self) -> int:
        """Requests admitted but not yet dispatched to the device."""
        return sum(len(q) for q in self.queues.values())

    # ---- admission ---------------------------------------------------------
    def submit(self, req: DetrRequest) -> bool:
        """Route a request to its bucket queue; returns False (and records
        the reason on ``req.error``) when admission control rejects it."""
        req.t_submit = time.perf_counter()
        bucket, reason = self.router.admit(req.image)
        if bucket is None:
            req.error = reason
            with self._lock:
                self.rejected.append(req)
            return False
        req.bucket = bucket.resolution
        self.queues[bucket.resolution].append(req)
        return True

    # ---- one engine step ---------------------------------------------------
    def forward(self, images: torch.Tensor, resolution: int):
        """One bucket forward on the engine's device (no autograd)."""
        from repro_torch.core.detector import detector_apply
        with torch.inference_mode():
            return detector_apply(self.params,
                                  self._bucket_by_res[resolution].cfg, images,
                                  backend=self.backend)

    def step(self) -> int:
        """Dispatch one micro-batch from the deepest bucket queue (ties
        pick the smaller bucket). Returns the number of requests
        dispatched; completion happens in the post-processing stage."""
        res = max((r for r, q in self.queues.items() if q),
                  key=lambda r: (len(self.queues[r]), -r), default=None)
        if res is None:
            return 0
        q = self.queues[res]
        batch = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        imgs = np.zeros((self.max_batch, 3, res, res), np.float32)
        for i, req in enumerate(batch):
            im = np.asarray(req.image, np.float32)
            imgs[i, :, :im.shape[1], :im.shape[2]] = im     # pad up
        x = torch.from_numpy(imgs).to(self.device)
        cls_logits, boxes, _aux = self.forward(x, res)
        self.batches_dispatched += 1
        self._post.submit((batch, cls_logits, boxes))
        return len(batch)

    def _complete(self, item) -> None:
        batch, cls_logits, boxes = item
        probs = softmax_np(cls_logits.float().cpu().numpy())
        boxes = boxes.float().cpu().numpy()
        for i, req in enumerate(batch):
            req.cls_probs = probs[i]
            req.boxes = boxes[i]
            req.detections = topk_detections(probs[i], boxes[i], self.topk)
            req.t_done = time.perf_counter()
            req.done = True
            if req.callback is not None:
                req.callback(req)
            with self._lock:
                self.finished.append(req)

    def drain(self) -> None:
        """Barrier on the post-processing stage only (no new dispatches)."""
        self._post.drain()

    def run_until_drained(self, max_steps: int = 10000) -> list:
        steps = 0
        while self.pending() and steps < max_steps:
            self.step()
            steps += 1
        self._post.drain()
        if self.pending():
            now = time.perf_counter()
            raise StarvationError({
                "engine": "DetrServeEngine", "steps": steps,
                "queued": {r: len(q) for r, q in self.queues.items() if q},
                "oldest_age_s": {r: round(now - q[0].t_submit, 6)
                                 for r, q in self.queues.items() if q},
                "finished": len(self.finished),
                "rejected": len(self.rejected)})
        return self.finished

    def close(self) -> None:
        """Shut down the post-processing worker (joins its thread)."""
        self._post.close()

    def __enter__(self) -> "DetrServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
