"""Token-decode (LM) continuous-batching engine (port of
``repro/serve/lm.py``).

A fixed decode batch of ``max_batch`` slots over one ring cache per
layer: a request is admitted into a free slot by a batch-1 prefill
scattered into the batch cache, and every step decodes one token for all
active slots (``decode_step``, whose attention runs through the
flash-decode kernel K5 on the card). The engine runs on ``device`` — the
card unless the caller passes ``device="cpu"``.

The reference jits the decode step and the prefill
(``repro/serve/lm.py:61-62``). Here the decode step is prepared once, at
construction: one warm-up step and, on the card, one
``torch.cuda.CUDAGraph`` capture of ``decode_step`` at the engine's one
shape (``max_batch``, ``cache_len``); every step then replays it. The
graph reads fixed addresses, so the cache, ``pos`` and ``last_tok`` are
only ever written in place, and the logits are copied out of the graph's
static buffer before the next token is drawn (the Gumbel draw of
sampling stays outside the graph, on ``gen``). ``compile_count`` counts
the preparations: 1, whatever the steps and admissions. A capture that
fails raises; there is no eager fallback on the card.

The prefill stays eager: the reference retraces it for every prompt
length, so a graph per length would hardly ever replay; it runs at the
prompt's exact length (a MoE layer's capacity depends on it).

The engine serves the decoder-only text families (dense, moe, ssm,
hybrid); admission scatters every cache leaf, the SSD states included.
It refuses vlm and encdec at construction: their prefill needs image
embeddings or audio frames besides the tokens, which the reference's
engine does not pass either (its vlm prefill fails, its launcher
refuses encdec). Those families run through ``api.prefill`` and
``api.decode_step``.
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


#: the families whose prefill takes tokens only
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
EXTRA_INPUTS = {"vlm": "image embeddings (batch['img_embeds'])",
                "encdec": "audio frames (batch['frames'])"}


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
        if cfg.family not in SERVED_FAMILIES:
            raise ValueError(
                f"ServeEngine serves the text-only families {SERVED_FAMILIES}; "
                f"{cfg.name} is {cfg.family!r}, whose prefill needs "
                f"{EXTRA_INPUTS.get(cfg.family, 'other inputs')} besides the "
                "tokens: run it through get_api(cfg).prefill / decode_step")
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
        # the same flags on the device, kept in step: no host copy per step
        self._active_t = torch.zeros((b,), dtype=torch.bool, device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * b
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.compile_count = 0
        self._graph = None
        self._logits = None                  # the graph's static output
        self._prepare_decode()

    # --- ahead-of-time preparation -------------------------------------------
    def _decode_eager(self) -> torch.Tensor:
        logits, _ = self.api.decode_step(self.params, self.cfg, self.cache,
                                         self.last_tok, self.pos)
        return logits

    @torch.inference_mode()
    def _prepare_decode(self) -> None:
        """One warm-up decode step (every slot still idle: it writes the
        slot of position 0, which an admission overwrites whole) and, on
        the card, the capture of the step."""
        if self.device.type == "cpu":
            self._decode_eager()
        else:
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._decode_eager()    # builds K5, fills the cached constants
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._logits = self._decode_eager()
            self._graph = graph
        self.compile_count += 1

    def decode_logits(self) -> torch.Tensor:
        """One decode step for every slot from the engine's state (a
        replay of the captured step on the card): the (B, V) float32
        logits, in a tensor of their own. Writes the cache at each slot's
        position; ``pos`` and ``last_tok`` are the caller's to advance."""
        if self._graph is None:
            return self._decode_eager()
        self._graph.replay()
        return self._logits.clone()

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
        self.last_tok[slot] = first            # in place: the graph reads it
        self.pos[slot] = len(req.prompt)
        self.active[slot] = True
        self._active_t[slot] = True
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
        nxt = self._next_tokens(self.decode_logits())
        active = self._active_t
        self.pos.add_(active.to(torch.int32))
        self.last_tok.copy_(torch.where(active, nxt, self.last_tok))
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
                self._active_t[slot] = False
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
