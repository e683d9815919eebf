"""CUDA graphs of the streaming paths (the port's counterpart of the
reference's jitted stream paths, repro/stream/temporal.py and the
streaming engine's decoder forward).

A path is a *body*: a function of no arguments that reads and writes
only tensors that keep their address from call to call (the manager's
tables, diff reference, keep state, frame input) and returns its outputs.
:meth:`StreamGraphs.run` keys each body as the reference's jit retraces:
by path name and a key of batch size and static arguments.

  * On the card, the first call of a key runs the body eagerly on a side
    stream (the warm-up: it builds the kernels and every cached host
    constant, and its effect is the frame's own), then captures it into
    a ``torch.cuda.CUDAGraph``. Capture records without executing, so
    the warm-up's writes are the only ones this call makes. Every later
    call replays the graph and returns its static outputs, which the
    next replay rewrites. A capture that fails raises: there is no
    eager fallback.
  * On the CPU, or with ``capture=False`` (the eager oracle a caller asks
    for by name), every call runs the body eagerly.

All graphs share one memory pool. A body's outputs stay referenced for
as long as its graph lives, so no graph's capture reuses another's
outputs, and replays run on one stream, so their temporaries never
overlap in time. :meth:`StreamGraphs.clear` drops every graph (a plan
swap, a table that moved); the next call of each key captures again.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class StreamGraphs:
    """The captured paths of one streaming manager and its engine."""

    def __init__(self, device: torch.device, *, capture: bool = True,
                 on_prepare: Optional[Callable[[str], None]] = None):
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self._on_prepare = on_prepare   # called with the path name at the
        #   first call of each key (the reference's trace-time spy)
        self._graphs: dict = {}         # (fn, *key) -> (graph, outputs)
        self._seen: set = set()
        self._pool = None
        self._side = None
        self.capturing = False          # a body is being recorded
        self.captures = 0               # graphs captured so far

    def run(self, fn: str, key: tuple, body: Callable):
        """``body()``'s outputs: a replay of the key's graph, else the
        body run eagerly (and, on the card, then captured)."""
        k = (fn,) + tuple(key)
        entry = self._graphs.get(k)
        if entry is not None:
            entry[0].replay()
            return entry[1]
        if k not in self._seen:
            self._seen.add(k)
            if self._on_prepare is not None:
                self._on_prepare(fn)
        if not self.capture:
            return self._call(body)
        current = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = self._call(body)
        current.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        self.capturing = True
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                static = self._call(body)
        finally:
            self.capturing = False
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[k] = (graph, static)
        self.captures += 1
        return out

    def _call(self, body: Callable):
        """The one place a body runs (eagerly or under capture)."""
        return body()

    def clear(self) -> None:
        """Drop every graph and forget every key: the next call of each
        key warms up and captures again."""
        if self.capturing:
            raise RuntimeError("a streaming graph cannot be dropped while "
                               "a body is being captured")
        self._graphs.clear()
        self._seen.clear()
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)
