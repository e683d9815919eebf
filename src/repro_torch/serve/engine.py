"""Continuous-batching DETR serving over shape buckets, each prepared
ahead of time (port of ``DetrServeEngine`` from repro/serve/engine.py).

  * **Buckets prepared at start-up.** The reference compiles each
    bucket's forward at construction (``jax.jit(...).lower().compile()``)
    behind a compile-count spy. Here each bucket gets, on the card, a
    static input ``(max_batch, 3, r, r)``, one warm-up forward on a side
    stream (it builds the kernel libraries with ``nvcc`` and fills every
    cached host constant), and one ``torch.cuda.CUDAGraph`` capture of
    :func:`~repro_torch.core.detector.detector_apply`; on the CPU the
    warm-up forward alone. Either way ``msda_compiles_total{bucket}`` is
    bumped once per bucket and never again, so ``compile_count`` equals
    the number of buckets after construction and stays there. A capture
    that fails raises: the card's path has no eager fallback.
  * **Continuous batching.** Requests queue per bucket; every
    :meth:`DetrServeEngine.step` dispatches the deepest bucket's
    micro-batch, zero-padded to ``max_batch``. On the card it stages the
    batch in one of the bucket's two pinned host buffers (one is refilled
    only after its previous copy has left it), copies that buffer into
    the static input without blocking, replays the graph, copies the
    static outputs into tensors of this batch (the next replay rewrites
    the static ones) and records an event.
  * **Pipelined post-processing.** A worker thread (``serve/postproc.py``)
    waits on that event only: its device-to-host copy runs on a stream
    of its own into pinned memory, so it is not queued behind the next
    batch's forward. Top-k decode and per-request callbacks follow.
  * **Telemetry** as in the reference: ``msda_compiles_total{bucket}``,
    ``serve_requests_total{bucket,outcome}``, ``serve_queue_depth``,
    ``serve_postproc_backlog``, ``serve_request_latency_seconds``,
    ``serve_span_seconds{span}`` (spans ``queue``, ``device``,
    ``postproc``, ``callback``) and ``staged_bytes_total{mode}``, a
    ``plan`` event per bucket, all on the engine's ``obs`` bundle.

Every forward builds ONE shared value cache from the encoder memory and
all decoder layers sample it. :meth:`DetrServeEngine.forward` is the
public eager forward (no graph). Left for later slices: the autotuned
plan table and the streaming engine.
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
from repro_torch.obs import Observability
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
    span_queue: Optional[str] = None          # open "queue" span id: the
    #   request context that carries the trace across the worker thread


def pad_batch(dst: np.ndarray, images) -> np.ndarray:
    """Write ``images`` (each (3, h, w), h/w within the bucket) into the
    (max_batch, 3, r, r) array ``dst`` from the top-left corner, zeros
    elsewhere; slots past the batch are zeroed."""
    r = dst.shape[-1]
    for i in range(dst.shape[0]):
        if i >= len(images):
            dst[i] = 0.0
            continue
        im = np.asarray(images[i], np.float32)
        if im.shape[1:] != (r, r):
            dst[i] = 0.0
        dst[i, :, :im.shape[1], :im.shape[2]] = im
    return dst


class _BucketGraph:
    """One bucket's captured forward: the static input, the graph, its
    static outputs, and two pinned host buffers that take turns."""

    def __init__(self, graph: torch.cuda.CUDAGraph, static_in: torch.Tensor,
                 outputs: tuple):
        self.graph = graph
        self.static_in = static_in
        self.outputs = outputs
        self.pinned = [torch.zeros(static_in.shape, dtype=static_in.dtype,
                                   pin_memory=True) for _ in range(2)]
        self.copied: list = [None, None]     # event after each buffer's copy
        self.turn = 0

    def run(self, images):
        """Stage ``images``, replay, and return (cls_logits, boxes, ready):
        copies of the static outputs and the event that follows them."""
        i, self.turn = self.turn, self.turn ^ 1
        if self.copied[i] is not None:
            self.copied[i].synchronize()        # its last copy has left it
        pad_batch(self.pinned[i].numpy(), images)
        self.static_in.copy_(self.pinned[i], non_blocking=True)
        self.copied[i] = torch.cuda.Event()
        self.copied[i].record()
        self.graph.replay()
        outs = tuple(t.clone() for t in self.outputs)
        ready = torch.cuda.Event()
        ready.record()
        return outs + (ready,)


class DetrServeEngine:
    """Bucketed continuous-batching DETR detection server.

    ``resolutions`` selects the buckets (default: one at
    ``cfg.img_size``); ``params`` are moved to ``device`` — the card
    unless the caller passes ``device="cpu"``; the model params are
    resolution-independent, so every bucket serves the same weights.
    ``obs`` is the telemetry bundle (default
    :meth:`~repro_torch.obs.Observability.default`, which logs to
    ``REPRO_OBS_JSONL`` when set). ``submit`` routes (and may reject)
    immediately; ``step`` dispatches one micro-batch and hands the
    outputs to the post-processing stage, a worker thread when
    ``pipeline_postproc`` is set (the default); both modes give the same
    results.

    Construct engines while no other thread works on the card: a capture
    in CUDA's ``global`` mode refuses what another thread does meanwhile.
    """

    def __init__(self, cfg, params, *, max_batch: int = 8,
                 backend: Optional[str] = None,
                 resolutions: Optional[tuple] = None,
                 pipeline_postproc: bool = True, topk: int = 5,
                 obs: Optional[Observability] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.max_batch = int(max_batch)
        self.backend = backend
        self.topk = int(topk)
        # per-engine telemetry: its own registry, so every counter is
        # exact for this engine; Observability.disabled() serves with none
        self.obs = obs if obs is not None else Observability.default()
        m = self.obs.metrics
        self._m_compiles = m.counter(
            "msda_compiles_total",
            "detector forward preparations per bucket (one CUDA-graph "
            "capture on the card; flat after start-up)")
        self._m_requests = m.counter(
            "serve_requests_total", "requests by bucket and outcome")
        self._m_qdepth = m.gauge(
            "serve_queue_depth", "admitted requests waiting per bucket")
        self._m_backlog = m.gauge(
            "serve_postproc_backlog", "batches queued to the postproc worker")
        self._m_latency = m.histogram(
            "serve_request_latency_seconds",
            "submit-to-callback latency per completed request")
        self._m_span = m.histogram(
            "serve_span_seconds", "per-stage latency (label span=)")
        self._m_staged = m.counter(
            "staged_bytes_total",
            "bytes staged to device per the plan's static accounting")
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
        self._closed = False
        self._graphs: dict = {}
        self._pool = None                    # one memory pool for all graphs
        for b in self.buckets:
            self._prepare(b.resolution)
            self.obs.tracer.event("plan", engine="DetrServeEngine",
                                  bucket=b.resolution, plan=b.plan.snapshot())
        self._d2h = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._post = PostprocWorker(self._complete,
                                    pipelined=pipeline_postproc, obs=self.obs)

    # ---- ahead-of-time preparation -----------------------------------------
    def _prepare(self, res: int) -> None:
        """Warm up one bucket and, on the card, capture its forward."""
        static_in = torch.zeros((self.max_batch, 3, res, res),
                                dtype=torch.float32, device=self.device)
        if self.device.type == "cpu":
            self.forward(static_in, res)
        else:
            self._graphs[res] = self._capture(res, static_in)
        self._m_compiles.inc(bucket=str(res))

    def _capture(self, res: int, static_in: torch.Tensor) -> _BucketGraph:
        from repro_torch.core.detector import detector_apply
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # builds the kernels and every cached constant of this shape,
            # so that nothing in the capture copies from the host
            self.forward(static_in, res)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph, pool=self._pool):
            cls_logits, boxes, _aux = detector_apply(
                self.params, self._bucket_by_res[res].cfg, static_in,
                backend=self.backend)
        if self._pool is None:
            self._pool = graph.pool()
        return _BucketGraph(graph, static_in, (cls_logits, boxes))

    @property
    def compile_count(self) -> int:
        """Bucket preparations so far: a view over the
        ``msda_compiles_total`` registry counter."""
        return int(self._m_compiles.total())

    # ---- introspection -----------------------------------------------------
    def describe(self) -> str:
        how = "CUDA graph" if self.device.type == "cuda" else "eager, cpu"
        lines = []
        for b in self.buckets:
            d = b.plan.describe()
            if b.plan.backend == "cuda_decode":
                d += " [persistent decode: table staged once per memory]"
            lines.append(f"bucket {b.resolution}px ({how}): {d}")
        return "\n".join(lines)

    def bucket_table(self) -> list:
        return self.router.table()

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
            self._m_requests.inc(bucket="none", outcome="rejected")
            with self._lock:
                self.rejected.append(req)
            return False
        res = bucket.resolution
        req.bucket = res
        # the "queue" span opens here and step() closes it at dispatch;
        # its id rides on the request across the worker thread
        req.span_queue = self.obs.tracer.start("queue", rid=req.rid,
                                               t=req.t_submit, bucket=res)
        self._m_requests.inc(bucket=str(res), outcome="admitted")
        self.queues[res].append(req)
        self._m_qdepth.set(len(self.queues[res]), bucket=str(res))
        return True

    # ---- one engine step ---------------------------------------------------
    def forward(self, images: torch.Tensor, resolution: int):
        """One bucket forward on the engine's device, eager (no graph, no
        autograd)."""
        from repro_torch.core.detector import detector_apply
        with torch.inference_mode():
            return detector_apply(self.params,
                                  self._bucket_by_res[resolution].cfg, images,
                                  backend=self.backend)

    def dispatch(self, images, resolution: int):
        """Run at most ``max_batch`` images (each (3, h, w) within the
        bucket) through the bucket's prepared forward: on the card a
        replay of its graph, on the CPU the eager forward. Returns
        (cls_logits, boxes, ready): tensors of this batch alone and, on
        the card, the event that follows them (None on the CPU). Only
        the first ``len(images)`` rows are requests; the rest are
        padding."""
        if len(images) > self.max_batch:
            raise ValueError(f"{len(images)} images for a batch of "
                             f"{self.max_batch}")
        if self.device.type == "cuda":
            with torch.inference_mode():
                return self._graphs[resolution].run(images)
        imgs = pad_batch(np.empty((self.max_batch, 3, resolution, resolution),
                                  np.float32), images)
        cls_logits, boxes, _aux = self.forward(torch.from_numpy(imgs),
                                               resolution)
        return cls_logits, boxes, None

    def step(self) -> int:
        """Dispatch one micro-batch from the deepest bucket queue (ties
        pick the smaller bucket). Returns the number of requests
        dispatched; completion happens in the post-processing stage."""
        if self._closed:
            raise RuntimeError("DetrServeEngine is closed")
        res = max((r for r, q in self.queues.items() if q),
                  key=lambda r: (len(self.queues[r]), -r), default=None)
        if res is None:
            return 0
        q = self.queues[res]
        batch = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        tr = self.obs.tracer
        self._m_qdepth.set(len(q), bucket=str(res))
        for req in batch:
            if req.span_queue:
                sp = tr.end(req.span_queue)
                req.span_queue = None
                self._m_span.observe(sp.duration_s, span="queue")
        # the "device" span opens at dispatch; the postproc stage closes
        # it once the outputs are on the host
        dev_span = tr.start("device", bucket=res, n=len(batch))
        cls_logits, boxes, ready = self.dispatch([r.image for r in batch], res)
        self.batches_dispatched += 1
        self._m_staged.inc(self._bucket_by_res[res].plan.cache_table_bytes,
                           mode="build")
        self._post.submit((batch, cls_logits, boxes, ready, dev_span))
        self._m_backlog.set(self._post.backlog)
        return len(batch)

    def _to_host(self, outputs, ready):
        """numpy copies of the batch's outputs. On the card the copy waits
        on ``ready`` alone, on a stream of its own, into pinned memory."""
        if ready is None:
            return [t.float().numpy() for t in outputs]
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(ready)
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in outputs]
            for h, t in zip(host, outputs):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._d2h)
        done.synchronize()
        return [h.float().numpy().copy() for h in host]

    def _complete(self, item) -> None:
        batch, cls_logits, boxes, ready, dev_span = item
        tr = self.obs.tracer
        logits, boxes = self._to_host((cls_logits, boxes), ready)
        probs = softmax_np(logits)
        if dev_span:
            sp = tr.end(dev_span)    # after the copy: transfer included
            self._m_span.observe(sp.duration_s, span="device")
        post_span = tr.start("postproc", n=len(batch))
        for i, req in enumerate(batch):
            req.cls_probs = probs[i]
            req.boxes = boxes[i]
            req.detections = topk_detections(probs[i], boxes[i], self.topk)
            req.t_done = time.perf_counter()
            req.done = True
            if req.callback is not None:
                with tr.span("callback", rid=req.rid):
                    req.callback(req)
            self._m_latency.observe(req.t_done - req.t_submit,
                                    bucket=str(req.bucket))
            self._m_requests.inc(bucket=str(req.bucket), outcome="completed")
            with self._lock:
                self.finished.append(req)
        if post_span:
            sp = tr.end(post_span)
            self._m_span.observe(sp.duration_s, span="postproc")

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
        self.obs.flush_metrics()
        return self.finished

    def close(self) -> None:
        """Shut down the post-processing worker (joins its thread), free
        the graphs, flush a final metrics snapshot into the JSONL log
        (when one is attached) and close it. Idempotent; ``step`` raises
        afterwards."""
        if self._closed:
            return
        self._closed = True
        self._post.close()
        self._graphs.clear()
        self.obs.flush_metrics()
        self.obs.close()

    def __enter__(self) -> "DetrServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
