"""Token-decode (LM) continuous-batching engine (port of
``repro/serve/lm.py``).

A fixed decode batch of ``max_batch`` slots over one ring cache per
layer: a request is admitted into a free slot by a batch-1 prefill
scattered into the batch cache, and every step decodes one token for all
active slots (``decode_step``, whose attention runs through the
flash-decode kernel K5 on the card). The engine runs on ``device`` — the
card unless the caller passes ``device="cpu"`` — and writes its cache in
place.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.bridge import resolve_device, tree_to
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_api
from repro_torch.serve.postproc import StarvationError


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S_prompt,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 4
    cache_len: int = 256
    greedy: bool = True
    temperature: float = 1.0


class ServeEngine:
    """``gen`` draws the sampling noise when ``greedy`` is off (default: a
    CPU generator seeded 0); ``params`` are moved to ``device``."""

    def __init__(self, cfg: ModelConfig, params: Any, serve_cfg: ServeConfig,
                 gen: Optional[torch.Generator] = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = get_api(cfg)
        self.params = tree_to(params, self.device)
        self.scfg = serve_cfg
        self.gen = gen if gen is not None else torch.Generator().manual_seed(0)
        b = serve_cfg.max_batch
        self.cache = self.api.init_cache(cfg, b, serve_cfg.cache_len,
                                         device=self.device)
        self.pos = torch.zeros((b,), dtype=torch.int32, device=self.device)
        self.last_tok = torch.zeros((b,), dtype=torch.int32, device=self.device)
        self.active = np.zeros((b,), bool)
        self.slot_req: list[Optional[Request]] = [None] * b
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []

    # --- slot management ----------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    @torch.inference_mode()
    def _admit(self, slot: int, req: Request):
        cfg, scfg = self.cfg, self.scfg
        cache1 = self.api.init_cache(cfg, 1, scfg.cache_len, device=self.device)
        toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                               device=self.device)[None]
        logits, cache1 = self.api.prefill(self.params, cfg, cache1,
                                          {"tokens": toks})
        # scatter the single-request cache into batch slot `slot`
        # (every stacked cache leaf is (n_layers, B, ...): dim 1 is batch)
        for name, c in self.cache.items():
            c[:, slot] = cache1[name][:, 0]
        first = int(self._next_tokens(logits)[0])
        req.output.append(first)
        self.last_tok[slot] = first
        self.pos[slot] = len(req.prompt)
        self.active[slot] = True
        self.slot_req[slot] = req

    def _next_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy argmax, or a draw from softmax(logits / temperature) by
        the Gumbel-max trick (as ``jax.random.categorical``) with noise
        from ``self.gen``. Returns (B,) int32."""
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self.gen, device=self.gen.device)
        u = torch.clamp(u.to(logits.device), min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.scfg.temperature + gumbel,
                            dim=-1).to(torch.int32)

    # --- one engine step ----------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """Admit waiting requests into free slots, then decode one token for
        every active slot. Returns number of active slots."""
        for slot in range(self.scfg.max_batch):
            if not self.active[slot] and self.queue:
                self._admit(slot, self.queue.popleft())
        if not self.active.any():
            return 0
        logits, self.cache = self.api.decode_step(self.params, self.cfg,
                                                  self.cache, self.last_tok,
                                                  self.pos)
        nxt = self._next_tokens(logits)
        active = torch.as_tensor(self.active, device=self.device)
        self.pos = self.pos + active.to(torch.int32)
        self.last_tok = torch.where(active, nxt, self.last_tok)
        nxt_np = nxt.cpu().numpy()
        for slot in range(self.scfg.max_batch):
            req = self.slot_req[slot]
            if req is None or not self.active[slot]:
                continue
            tok = int(nxt_np[slot])
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.output) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.active[slot] = False
                self.slot_req[slot] = None
        return int(self.active.sum())

    def run_until_drained(self, max_steps: int = 10000) -> list[Request]:
        for _ in range(max_steps):
            self.step()
            if not self.queue and not self.active.any():
                return self.finished
        raise StarvationError({
            "engine": "ServeEngine", "steps": max_steps,
            "queued": len(self.queue), "active": int(self.active.sum()),
            "finished": len(self.finished)})
