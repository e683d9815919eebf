"""CUDA graphs of the port's compiled paths (the counterpart of the
reference's ``jax.jit``): the streaming paths (repro/stream/temporal.py
and the streaming engine's decoder forward) and the train steps
(repro/train/step.py ``build_train_step`` under ``jax.jit``).

A path is a *body*: a function of no arguments that reads and writes
only tensors that keep their address from call to call (a manager's
tables, a train step's standing state and static batch) and returns its
outputs. :meth:`CapturedGraphs.run` keys each body as the reference's
jit retraces: by path name and a key of shapes and static arguments.

  * On the card, the first call of a key runs the body eagerly on a side
    stream (the warm-up: it builds the kernels and every cached host
    constant, and its effect is the call's own), then captures it into
    a ``torch.cuda.CUDAGraph``. Capture records without executing, so
    the warm-up's writes are the only ones this call makes. Every later
    call replays the graph and returns its static outputs, which the
    next replay rewrites. A capture that fails raises: there is no
    eager fallback.
  * On the CPU, or with ``capture=False`` (the eager oracle a caller asks
    for by name), every call runs the body eagerly.

:meth:`CapturedGraphs.run_split` is a path with a host stage in the
middle, as the reference's ``jax.pure_callback`` splits its program:
``first()`` on the device, then ``host(carry)`` once the device has
finished it, then ``second(carry)``. On the card these are two graphs
under one key, replayed in order with the host's work between them;
the host stage is never captured.

All graphs share one memory pool. A body's outputs stay referenced for
as long as its graph lives, so no graph's capture reuses another's
outputs, and replays run on one stream, so their temporaries never
overlap in time. :meth:`CapturedGraphs.clear` drops every graph (a plan
swap, a table that moved); the next call of each key captures again.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import torch


class CapturedGraphs:
    """The captured paths of one owner (a streaming manager and its
    engine, a train step)."""

    def __init__(self, device: torch.device, *, capture: bool = True,
                 on_prepare: Optional[Callable[[str], None]] = None):
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self._on_prepare = on_prepare   # called with the path name at the
        #   first call of each key (the reference's trace-time spy)
        self._graphs: dict = {}         # (fn, *key) -> (graph, outputs) or
        #   (graph A, carry, graph B, outputs)
        self._seen: set = set()
        self._pool = None
        self._side = None
        self.capturing = False          # a body is being recorded
        self.captures = 0               # graphs captured so far
        self.host_ms: dict = {}         # run_split's last host stage:
        #   "wait" (the device finishing the first stage), "host"

    def run(self, fn: str, key: tuple, body: Callable):
        """``body()``'s outputs: a replay of the key's graph, else the
        body run eagerly (and, on the card, then captured)."""
        k = self._first_call(fn, key)
        entry = self._graphs.get(k)
        if entry is not None:
            entry[0].replay()
            return entry[1]
        if not self.capture:
            return self._call(body)
        out = self._warm_up(lambda: self._call(body))
        graph, static = self._capture(body)
        self._graphs[k] = (graph, static)
        return out

    def run_split(self, fn: str, key: tuple, first: Callable,
                  host: Callable, second: Callable):
        """``second(carry)``'s outputs, ``carry = first()``, with
        ``host(carry)`` run on the host once the device has finished
        ``first``: on the card two graphs replayed in order around the
        host stage, captured as :meth:`run` captures one."""
        k = self._first_call(fn, key)
        entry = self._graphs.get(k)
        if entry is not None:
            graph_a, carry, graph_b, static = entry
            graph_a.replay()
            self._host(host, carry)
            graph_b.replay()
            return static
        def eager():
            carry = self._host(host, self._call(first))
            return self._call(lambda: second(carry))
        if not self.capture:
            return eager()
        out = self._warm_up(eager)
        graph_a, carry = self._capture(first)
        graph_b, static = self._capture(lambda: second(carry))
        self._graphs[k] = (graph_a, carry, graph_b, static)
        return out

    def _first_call(self, fn: str, key: tuple) -> tuple:
        k = (fn,) + tuple(key)
        if k not in self._seen and k not in self._graphs:
            self._seen.add(k)
            if self._on_prepare is not None:
                self._on_prepare(fn)
        return k

    def _warm_up(self, run: Callable):
        """``run()`` on a side stream, ordered after the current stream's
        work and before its next."""
        current = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = run()
        current.wait_stream(self._side)
        return out

    def _capture(self, body: Callable):
        graph = torch.cuda.CUDAGraph()
        self.capturing = True
        # no automatic garbage collection while capturing: a collected
        # graph's destructor (say, of an owner dropped in a reference
        # cycle) would call the runtime mid-capture and invalidate it;
        # torch.cuda.graph collects explicitly before the capture begins
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                static = self._call(body)
        finally:
            self.capturing = False
            if enabled:
                gc.enable()
        if self._pool is None:
            self._pool = graph.pool()
        self.captures += 1
        return graph, static

    def _host(self, host: Callable, carry):
        """``host(carry)`` once the current stream's work is done; returns
        ``carry``."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t1 = time.perf_counter()
        host(carry)
        self.host_ms = {"wait": (t1 - t0) * 1e3,
                        "host": (time.perf_counter() - t1) * 1e3}
        return carry

    def _call(self, body: Callable):
        """The one place a body runs (eagerly or under capture)."""
        return body()

    def clear(self) -> None:
        """Drop every graph and forget every key: the next call of each
        key warms up and captures again."""
        if self.capturing:
            raise RuntimeError("a graph cannot be dropped while a body is "
                               "being captured")
        self._graphs.clear()
        self._seen.clear()
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)
