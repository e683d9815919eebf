"""Uniform model API across families (port of ``repro/models/registry.py``,
decoder-only dense family).

The port's ``init`` takes ``(cfg, gen=None, *, device="cuda")`` and its
``init_cache`` ``(cfg, batch, cache_len, device="cuda")``; every other
entry keeps the reference's signature. The reference's ``axes`` (logical
sharding axes for a device mesh) has no counterpart on one card. Families other than ``dense``
raise ``NotImplementedError`` (ROADMAP.md)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import decoder
from repro_torch.models.common import ModelConfig, cross_entropy_loss


class ModelAPI(NamedTuple):
    init: Callable
    loss_fn: Callable              # (params, cfg, batch) -> (loss, metrics)
    forward: Callable              # (params, cfg, batch) -> logits
    init_cache: Callable           # (cfg, batch, cache_len) -> cache
    prefill: Callable              # (params, cfg, cache, batch) -> (logits, cache)
    decode_step: Callable          # (params, cfg, cache, tokens, pos) -> (logits, cache)


# --- decoder-only families ---------------------------------------------------

def _dec_loss(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    logits, aux = decoder.forward(params, cfg, tokens=tokens[:, :-1])
    loss = cross_entropy_loss(logits, tokens[:, 1:])
    total = loss + 0.01 * aux
    return total, {"ce": loss, "moe_aux": aux}


def _dec_forward(params, cfg, batch):
    logits, _ = decoder.forward(params, cfg, tokens=batch["tokens"])
    return logits


def _dec_prefill(params, cfg, cache, batch):
    return decoder.prefill(params, cfg, cache, tokens=batch["tokens"])


_DEC_API = ModelAPI(
    init=decoder.init_decoder, loss_fn=_dec_loss, forward=_dec_forward,
    init_cache=decoder.init_cache, prefill=_dec_prefill,
    decode_step=decoder.decode_step)

_REGISTRY: dict[str, ModelAPI] = {"dense": _DEC_API}


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _REGISTRY:
        decoder.check_family(cfg)          # raises NotImplementedError
    return _REGISTRY[cfg.family]
