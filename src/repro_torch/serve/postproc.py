"""Pipelined host-side post-processing + serving-loop starvation reports
(port of repro/serve/postproc.py; the telemetry hooks wait for the
serving slice).

:class:`PostprocWorker` overlaps the host decode of step N (device ->
host copy, softmax, top-k, callbacks) with the dispatch of step N+1: a
daemon thread takes (requests, device tensors) from a queue. With
``pipelined=False`` the same function runs in line, so both modes give
identical results."""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np


class StarvationError(RuntimeError):
    """``run_until_drained`` hit its step limit with work still queued;
    ``report`` carries the snapshot (queue depths, steps, completions)."""

    def __init__(self, report: dict):
        self.report = dict(report)
        self.report.setdefault("wall_time", time.time())
        self.report.setdefault("t_monotonic", time.perf_counter())
        msg = ("serving loop starved (work still queued at max_steps): "
               + ", ".join(f"{k}={v}"
                           for k, v in sorted(self.report.items())))
        ages = self.report.get("oldest_age_s") or {}
        if ages:
            worst = max(ages, key=lambda k: ages[k])
            msg += (f"; most-starved request (queue {worst}) has waited "
                    f"{ages[worst]:.3f}s")
        super().__init__(msg)


def softmax_np(x: np.ndarray) -> np.ndarray:
    """Float32 softmax over the last axis (host-side)."""
    x = np.asarray(x, np.float32)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def topk_detections(cls_probs: np.ndarray, boxes: np.ndarray, k: int) -> dict:
    """Top-k box emission from one request's (Nq, C+1) probs + (Nq, 4)
    boxes. Score is each query's best FOREGROUND class probability (the
    last column is background); ties resolve to the lower query index."""
    fg = cls_probs[:, :-1]
    labels = fg.argmax(axis=-1).astype(np.int32)
    scores = fg.max(axis=-1).astype(np.float32)
    k = min(int(k), scores.shape[0])
    order = np.argsort(-scores, kind="stable")[:k]
    return {"scores": scores[order], "labels": labels[order],
            "boxes": np.asarray(boxes)[order],
            "query": order.astype(np.int32)}


_STOP = object()


class PostprocWorker:
    """Background post-processing stage fed by a queue.

    Exceptions raised by ``process`` are re-raised from :meth:`drain` /
    :meth:`submit` on the caller's thread. :meth:`close` (idempotent; also
    the context-manager exit) processes what was submitted, stops and
    joins the thread; a later ``submit`` raises."""

    def __init__(self, process: Callable, *, pipelined: bool = True,
                 name: str = "serve-postproc"):
        self._process = process
        self.pipelined = bool(pipelined)
        self._exc: Optional[BaseException] = None
        self._stopped = False
        self._q: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        if self.pipelined:
            self._thread = threading.Thread(target=self._loop, name=name,
                                            daemon=True)
            self._thread.start()

    def submit(self, item) -> None:
        if self._stopped:
            raise RuntimeError("PostprocWorker is closed; submit after "
                               "close() would enqueue into a dead queue")
        if self._exc is not None:
            raise self._exc
        if self.pipelined:
            self._q.put(item)
        else:
            self._process(item)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                if self._exc is None:
                    self._process(item)
            except BaseException as e:          # noqa: BLE001 - re-raised
                self._exc = e
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every submitted item is processed; re-raise any
        worker exception on the calling thread."""
        if self.pipelined:
            self._q.join()
        if self._exc is not None:
            raise self._exc

    def close(self) -> None:
        """Stop accepting work and join the thread (idempotent)."""
        self._stopped = True
        if self._thread is not None and self._thread.is_alive():
            self._q.put(_STOP)
            self._thread.join(timeout=30.0)
        self._thread = None

    def __enter__(self) -> "PostprocWorker":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
