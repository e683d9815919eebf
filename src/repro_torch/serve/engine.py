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
public eager forward (no graph).

:class:`StreamingDetrEngine` serves video sessions over persistent,
incrementally updated value caches (``repro_torch/stream/``); its
decoder forward is eager. Both engines apply their device's measured
plan table (:func:`repro_torch.msda.autotune.ensure_applied`) before
they plan. Left for a later slice: a CUDA graph per streaming engine.
"""
from __future__ import annotations

import dataclasses
import os
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
        from repro_torch.msda.autotune import ensure_applied
        self.device = resolve_device(device)
        ensure_applied(self.device)   # load-only: the device's measured
        #   plan table, so the buckets below plan on its budgets
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
        self.buckets = derive_buckets(cfg, resolutions, backend=backend,
                                      device=self.device)
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


# --------------------------------------------------------------------------
# Streaming DETR detection: temporal value-cache reuse across video frames
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StreamSession:
    """One live video stream occupying a batch slot of the engine.

    Each entry of ``results`` carries the frame's detections and the
    manager's frame accounting under ``"stream"``, which is BATCH-scoped
    (``stream["scope"] == "batch"``): all sessions advance in one batched
    update."""
    sid: int
    slot: int
    queue: deque = dataclasses.field(default_factory=deque)
    results: list = dataclasses.field(default_factory=list)
    frames_done: int = 0
    t_queue: deque = dataclasses.field(default_factory=deque)  # submit
    #   times (perf_counter) parallel to ``queue``: starvation ages


class StreamingDetrEngine:
    """Streaming detection over persistent, incrementally updated caches
    (port of the reference's ``StreamingDetrEngine``).

    Up to ``max_sessions`` video sessions each occupy one batch slot of
    ONE batched :class:`~repro_torch.stream.TemporalCacheManager`, which
    holds every slot's persistent value cache, diff reference, EMA
    scores and hysteresis keep state. Per :meth:`step`, each session's
    next frame memory is stacked into the static batch (idle slots
    replay their last memory: zero dirty tiles), the manager applies one
    incremental update (or a partial restage, or a full rebuild), the
    6-layer decoder and its heads run against the manager's cache
    (``cuda_decode``: K2 samples the staged table the update rewrote in
    place), and the sampled frequencies feed back into the EMA.

    Sessions join and leave slots between steps; admission builds only
    the joining slot's rows. Sessions submit encoder MEMORIES (N_in, D):
    the backbone and encoder run upstream, per frame. ``params`` holds
    ``decoder``, ``cls_head`` and ``box_head``; they are moved to
    ``device``, the card unless the caller passes ``device="cpu"``. The
    decoder forward is eager."""

    def __init__(self, attn_cfg, decoder_cfg, params: dict,
                 level_shapes, *, max_sessions: int = 2,
                 backend: Optional[str] = None, stream_cfg=None,
                 update_fwp: bool = True,
                 obs: Optional[Observability] = None, device="cuda"):
        from repro_torch.msda import backend_info, make_plan
        from repro_torch.msda.autotune import ensure_applied
        from repro_torch.stream import (TemporalCacheManager,
                                        resolve_stream_config,
                                        stream_update_cap)
        self.device = resolve_device(device)
        ensure_applied(self.device)   # load-only: budgets for the plan
        #   below, the measured stream crossover for the default config
        self.attn_cfg = attn_cfg
        self.dec_cfg = decoder_cfg
        self.params = tree_to(params, self.device)
        self.max_sessions = int(max_sessions)
        self._update_fwp = bool(update_fwp) and attn_cfg.fwp_mode != "off"
        scfg = resolve_stream_config(stream_cfg, device=self.device)
        if backend is not None and backend != "auto" \
                and backend_info(backend).raster_only:
            backend = "auto"             # the decoder's own fallback
        plan = make_plan(attn_cfg, level_shapes, backend=backend,
                         n_queries=decoder_cfg.n_queries,
                         n_consumers=decoder_cfg.n_layers,
                         device=self.device)
        self.plan = dataclasses.replace(
            plan, stream_update_rows=stream_update_cap(plan,
                                                       scfg.update_frac))
        # engine and manager share ONE bundle: the manager's counters and
        # the engine's spans land in the same registry and log
        self.obs = obs if obs is not None else Observability.default()
        self._m_span = self.obs.metrics.histogram(
            "stream_span_seconds", "per-stage frame latency (label span=)")
        self._m_frame_latency = self.obs.metrics.histogram(
            "stream_frame_latency_seconds", "full step latency per frame")
        self.obs.tracer.event("plan", engine="StreamingDetrEngine",
                              plan=self.plan.snapshot())
        self.mgr = TemporalCacheManager(
            self.plan, self.params["decoder"]["value"], scfg,
            batch=self.max_sessions, obs=self.obs)
        self.sessions: dict = {}
        self._free_slots = list(range(self.max_sessions))
        self._next_sid = 0
        self._last_memory: Optional[torch.Tensor] = None  # (B, N_in, D) on
        #   the device: idle slots replay their row
        self._slot_centroid: dict = {}   # slot -> mean predicted (cx, cy)
        #   of its last frame: what reorder_sessions() sorts by

    def describe(self) -> str:
        r = self.mgr
        return (self.plan.describe()
                + f" [streaming: {self.max_sessions} sessions, "
                f"tile_rows={r.scfg.tile_rows}, "
                f"update<={r.update_rows}/{r.n_slots} rows/frame]")

    def capacity_estimate(self, budget_bytes: Optional[int] = None) -> dict:
        """Sessions per device: how many streams' persistent value tables
        fit a budget, per table dtype. Each session costs its full table
        (rows x lanes x itemsize, + the int8 scale row, + the pix2slot
        indirection when compact), as in the reference.

        The budget takes the reference's precedence: the caller's
        (``budget_source: "caller"``), then the ``REPRO_MSDA_VMEM_BUDGET``
        pin (``"static"``), then an applied autotune entry's measured L2
        knee (``"measured"``). Where the reference would fall back to its
        TPU staging constant, which has no H100 counterpart, the budget is
        the device's free memory (``torch.cuda.mem_get_info``,
        ``"device_free"``), or the host's available memory for a CPU
        engine (``"host_free"``)."""
        from repro_torch.msda.plan import (staging_budget_source,
                                           window_staging_budget)
        source = "caller"
        if budget_bytes is None and (
                os.environ.get("REPRO_MSDA_VMEM_BUDGET")
                or staging_budget_source(self.device) == "measured"):
            budget_bytes = window_staging_budget(self.device)
            source = staging_budget_source(self.device)
        if budget_bytes is None:
            if self.device.type == "cuda":
                budget_bytes = int(torch.cuda.mem_get_info(self.device)[0])
                source = "device_free"
            else:
                budget_bytes = int(os.sysconf("SC_AVPHYS_PAGES")
                                   * os.sysconf("SC_PAGE_SIZE"))
                source = "host_free"
        per_dtype = {}
        for d in ("float32", "int8"):
            p = dataclasses.replace(self.plan, table_dtype=d)
            per = p.table_bytes_for_rows(self.mgr._n_rows,
                                         with_indirection=self.mgr._compact)
            per_dtype[d] = {"bytes_per_session": per,
                            "sessions": budget_bytes // per}
        return {"budget_bytes": budget_bytes,
                "budget_source": source,
                "table_dtype": self.plan.table_dtype,
                "rows_per_session": self.mgr._n_rows,
                "per_dtype": per_dtype}

    # ---- session lifecycle -------------------------------------------------
    def open_session(self) -> int:
        if not self._free_slots:
            raise RuntimeError(
                f"all {self.max_sessions} streaming slots are busy")
        slot = self._free_slots.pop(0)
        sid = self._next_sid
        self._next_sid += 1
        self.sessions[sid] = StreamSession(sid=sid, slot=slot)
        # warm-start the slot and schedule its own build on the next step
        self.mgr.reset_slot(slot)
        return sid

    def close_session(self, sid: int) -> StreamSession:
        sess = self.sessions.pop(sid)
        self._free_slots.append(sess.slot)
        self._slot_centroid.pop(sess.slot, None)
        return sess

    def submit_frame(self, sid: int, memory: np.ndarray) -> None:
        """Queue one frame's encoder memory (N_in, D) for session sid."""
        sess = self.sessions[sid]
        sess.queue.append(np.asarray(memory))
        sess.t_queue.append(time.perf_counter())

    # ---- forward -------------------------------------------------------------
    def forward(self, memory: torch.Tensor, cache):
        """The decoder stack and heads against ``cache`` (no autograd):
        (cls_logits, boxes, summed sampling frequencies or None)."""
        from repro_torch.core import nn
        from repro_torch.msda.decoder import decoder_apply
        with torch.inference_mode():
            hs, refs, dstate = decoder_apply(
                self.params["decoder"], self.dec_cfg, self.plan, memory,
                collect_stats=self._update_fwp, cache=cache)
            cls_logits = nn.linear(self.params["cls_head"], hs)
            raw = nn.linear(self.params["box_head"], hs)
            cxy = torch.sigmoid(raw[..., :2] + nn.inverse_sigmoid(refs))
            boxes = torch.cat([cxy, torch.sigmoid(raw[..., 2:])], dim=-1)
            freq = None
            if self._update_fwp:
                freq = sum(s["freq"] for s in dstate.collected_stats())
        return cls_logits, boxes, freq

    def _frame_memory(self, pending: dict) -> torch.Tensor:
        """The (max_sessions, N_in, D) batch: each pending session's next
        frame (one copy of its memory to the device), idle slots their
        last memory (zeros before the first step)."""
        if self._last_memory is None:
            memory = torch.zeros((self.max_sessions, self.plan.n_in,
                                  self.attn_cfg.d_model),
                                 dtype=self.attn_cfg.dtype, device=self.device)
        else:
            memory = self._last_memory.clone()
        for slot, sess in pending.items():
            frame = torch.from_numpy(np.asarray(sess.queue.popleft(),
                                                np.float32))
            sess.t_queue.popleft()
            memory[slot].copy_(frame)
        return memory

    # ---- one engine step ---------------------------------------------------
    def step(self) -> int:
        """Ingest one pending frame per session; returns frames served."""
        pending = {s.slot: s for s in self.sessions.values() if s.queue}
        if not pending:
            return 0
        t_step0 = time.perf_counter()
        tr = self.obs.tracer
        with tr.span("frame_in", n=len(pending)):
            memory = self._frame_memory(pending)
        self._last_memory = memory
        cache, fstats = self.mgr.step(memory)
        dec_span = tr.start("decode", n=len(pending))
        cls_logits, boxes, freq = self.forward(memory, cache)
        if freq is not None:
            self.mgr.observe(freq)
        probs = torch.softmax(cls_logits, dim=-1).cpu().numpy()
        boxes = boxes.cpu().numpy()
        if dec_span:
            sp = tr.end(dec_span)    # after the copy: compute included
            self._m_span.observe(sp.duration_s, span="decode")
        self._m_frame_latency.observe(time.perf_counter() - t_step0)
        for slot, sess in pending.items():
            sess.results.append({
                "frame": sess.frames_done,
                "cls_probs": probs[slot], "boxes": boxes[slot],
                "stream": fstats,
            })
            sess.frames_done += 1
            # the session's reference-point cluster: mean predicted box
            # center, normalized to [0, 1]^2
            self._slot_centroid[slot] = boxes[slot][:, :2].mean(axis=0)
        return len(pending)

    # ---- cache-local session placement -------------------------------------
    def reorder_sessions(self, method: Optional[str] = None) -> dict:
        """Move sessions whose reference points cluster onto ADJACENT
        batch slots, sorted by the session centroid (mean predicted box
        center of its last frame) through
        :func:`repro_torch.msda.ordering.query_sort_keys`; ``method``
        defaults to the plan's ``query_order``, else raster. Free slots
        are fixed points; each session's state moves with it
        (``permute_slots``), so its next detections are unchanged.
        Returns {sid: slot} after the move."""
        from repro_torch.msda import ordering
        if method is None:
            method = self.plan.query_order \
                if self.plan.query_order != "none" else "raster"
        sessions = sorted(self.sessions.values(), key=lambda s: s.sid)
        placed = [s for s in sessions if s.slot in self._slot_centroid]
        if len(placed) > 1:
            cents = torch.from_numpy(np.stack(
                [self._slot_centroid[s.slot] for s in placed]).astype(
                    np.float32))
            keys = ordering.query_sort_keys(
                cents[None], self.plan.level_shapes, method)[0].numpy()
            order = np.argsort(keys, kind="stable")
            slots_sorted = sorted(s.slot for s in placed)
            perm = list(range(self.max_sessions))
            for i, j in enumerate(order):
                # key-sorted session i lands in the i-th occupied slot;
                # gather semantics: new slot takes the state at perm[slot]
                perm[slots_sorted[i]] = placed[int(j)].slot
            self.mgr.permute_slots(tuple(perm))
            if self._last_memory is not None:
                self._last_memory = self._last_memory[
                    torch.tensor(perm, device=self.device)]
            old_cent = dict(self._slot_centroid)
            old_by_slot = {s.slot: s for s in placed}
            self._slot_centroid = {
                new: old_cent[old] for new, old in enumerate(perm)
                if old in old_cent}
            for new, old in enumerate(perm):
                if old in old_by_slot:
                    old_by_slot[old].slot = new
        return {s.sid: s.slot for s in self.sessions.values()}

    def run_until_drained(self, max_steps: int = 10000) -> None:
        steps = 0
        while any(s.queue for s in self.sessions.values()) \
                and steps < max_steps:
            if self.step() == 0:
                break
            steps += 1
        queued = {s.sid: len(s.queue)
                  for s in self.sessions.values() if s.queue}
        if queued:
            now = time.perf_counter()
            raise StarvationError({
                "engine": "StreamingDetrEngine", "steps": steps,
                "queued": queued,
                "oldest_age_s": {s.sid: round(now - s.t_queue[0], 6)
                                 for s in self.sessions.values()
                                 if s.t_queue},
                "frames_done": sum(s.frames_done
                                   for s in self.sessions.values())})
        self.obs.flush_metrics()

    def report(self) -> dict:
        """The manager's cumulative rebuild-vs-incremental accounting."""
        return self.mgr.report()
