"""Uniform model API across families (port of ``repro/models/registry.py``):
dense, moe, ssm and hybrid through the decoder stack, vlm with stub
patch embeddings prepended to the text, and encdec.

The port's ``init`` takes ``(cfg, gen=None, *, device="cuda")`` and its
``init_cache`` ``(cfg, batch, cache_len, device="cuda")``; every other
entry keeps the reference's signature. ``prefill_body`` and
``decode_body`` are ``prefill`` and ``decode_step`` as rank bodies
(generators of ``distributed.collectives``, with the same arguments),
which a serving cell's rank runs under the tensor-parallel context, and
``loss_body`` is ``loss_fn`` as a rank body, which a train cell's rank
runs there (:mod:`repro_torch.train.step`). ``loss_split`` is
``loss_fn`` split around a host computation (the reference's
``pure_callback``), which a captured train step replays as two graphs.
``axes`` gives the params' logical
sharding axes and :func:`rules_overrides` the per-arch rule adjustments
that ``train/step.py``'s sharding rules apply on a device mesh.

A sequence split (``act_sharding.seq_split``, the pure-DP ``--opt``
cells) reaches the bodies through its context: ``loss_body`` computes
the rank's rows of the tokens it is handed and the loss of its data
group (``common.cross_entropy_body``), ``prefill_body`` the rank's rows
of the prompt and the last position's logits. The vlm's bodies refuse
it (its stream starts with image embeddings)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed.collectives import run_local
from repro_torch.models import decoder, encdec
from repro_torch.models.common import (ModelConfig, cross_entropy_body,
                                       cross_entropy_loss)


class ModelAPI(NamedTuple):
    init: Callable
    loss_fn: Callable              # (params, cfg, batch) -> (loss, metrics)
    forward: Callable              # (params, cfg, batch) -> logits
    init_cache: Callable           # (cfg, batch, cache_len) -> cache
    prefill: Callable              # (params, cfg, cache, batch) -> (logits, cache)
    decode_step: Callable          # (params, cfg, cache, tokens, pos) -> (logits, cache)
    axes: Optional[Callable] = None  # cfg -> logical axes tree of the params
    prefill_body: Optional[Callable] = None  # prefill as a rank body
    decode_body: Optional[Callable] = None   # decode_step as a rank body
    loss_body: Optional[Callable] = None     # loss_fn as a rank body
    loss_split: Optional[Callable] = None    # (cfg, batch) -> the loss
    #   split at a host stage (train.step.LossSplit), None: no host stage


# --- decoder-only families ---------------------------------------------------

def _dec_loss(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    logits, aux = decoder.forward(params, cfg, tokens=tokens[:, :-1])
    loss = cross_entropy_loss(logits, tokens[:, 1:])
    total = loss + 0.01 * aux
    return total, {"ce": loss, "moe_aux": aux}


def _dec_loss_body(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    logits, aux = yield from decoder.forward_body(params, cfg,
                                                  tokens=tokens[:, :-1])
    loss = yield from cross_entropy_body(logits, tokens[:, 1:],
                                         cfg.vocab_size)
    return loss + 0.01 * aux, {"ce": loss, "moe_aux": aux}


def _dec_forward(params, cfg, batch):
    logits, _ = decoder.forward(params, cfg, tokens=batch["tokens"])
    return logits


def _dec_prefill_body(params, cfg, cache, batch):
    return decoder.prefill_body(params, cfg, cache, tokens=batch["tokens"])


def _local(body: Callable) -> Callable:
    """``body`` run off any mesh."""
    return lambda *args: run_local(body(*args))


# --- vlm: stub patch embeddings prepended to text ----------------------------

def _vlm_embeds(params, cfg, batch):
    txt = params["embed"][batch["tokens"].long()]
    return torch.cat([batch["img_embeds"].to(txt.dtype), txt], dim=1)


def _vlm_loss(params, cfg: ModelConfig, batch):
    # predict text tokens only; image positions are context
    tokens = batch["tokens"]                       # (B, S_text+1)
    embeds = _vlm_embeds(params, cfg, {"tokens": tokens[:, :-1],
                                       "img_embeds": batch["img_embeds"]})
    logits, aux = decoder.forward(params, cfg, embeds=embeds)
    n_img = batch["img_embeds"].shape[1]
    loss = cross_entropy_loss(logits[:, n_img:], tokens[:, 1:])
    return loss + 0.01 * aux, {"ce": loss, "moe_aux": aux}


def _vlm_loss_body(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    txt = yield from decoder.embed_lookup(params["embed"], cfg, tokens[:, :-1])
    embeds = torch.cat([batch["img_embeds"].to(txt.dtype), txt], dim=1)
    logits, aux = yield from decoder.forward_body(params, cfg, embeds=embeds)
    n_img = batch["img_embeds"].shape[1]
    loss = yield from cross_entropy_body(logits[:, n_img:], tokens[:, 1:],
                                         cfg.vocab_size)
    return loss + 0.01 * aux, {"ce": loss, "moe_aux": aux}


def _vlm_forward(params, cfg, batch):
    logits, _ = decoder.forward(params, cfg,
                                embeds=_vlm_embeds(params, cfg, batch))
    return logits


def _vlm_prefill_body(params, cfg, cache, batch):
    return decoder.prefill_body(params, cfg, cache, tokens=batch["tokens"],
                                prefix=batch["img_embeds"])


# --- enc-dec ------------------------------------------------------------------

def _encdec_loss(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    logits, aux = encdec.forward(params, cfg, batch["frames"], tokens[:, :-1])
    loss = cross_entropy_loss(logits, tokens[:, 1:])
    return loss, {"ce": loss, "moe_aux": aux}


def _encdec_loss_body(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    logits, aux = yield from encdec.forward_body(params, cfg, batch["frames"],
                                                 tokens[:, :-1])
    loss = yield from cross_entropy_body(logits, tokens[:, 1:],
                                         cfg.vocab_size)
    return loss, {"ce": loss, "moe_aux": aux}


def _encdec_forward(params, cfg, batch):
    logits, _ = encdec.forward(params, cfg, batch["frames"], batch["tokens"])
    return logits


def _encdec_prefill_body(params, cfg, cache, batch):
    return encdec.prefill_body(params, cfg, cache, batch["frames"],
                               batch["tokens"])


_DEC_API = ModelAPI(
    init=decoder.init_decoder, loss_fn=_dec_loss, forward=_dec_forward,
    init_cache=decoder.init_cache, prefill=_local(_dec_prefill_body),
    decode_step=decoder.decode_step, axes=decoder.decoder_axes,
    prefill_body=_dec_prefill_body, decode_body=decoder.decode_body,
    loss_body=_dec_loss_body)

_REGISTRY: dict[str, ModelAPI] = {
    "dense": _DEC_API,
    "moe": _DEC_API,
    "ssm": _DEC_API,
    "hybrid": _DEC_API,
    "vlm": _DEC_API._replace(loss_fn=_vlm_loss, forward=_vlm_forward,
                             prefill=_local(_vlm_prefill_body),
                             prefill_body=_vlm_prefill_body,
                             loss_body=_vlm_loss_body),
    "encdec": ModelAPI(
        init=encdec.init_encdec, loss_fn=_encdec_loss, forward=_encdec_forward,
        init_cache=encdec.init_cache, prefill=_local(_encdec_prefill_body),
        decode_step=encdec.decode_step, axes=encdec.encdec_axes,
        prefill_body=_encdec_prefill_body, decode_body=encdec.decode_body,
        loss_body=_encdec_loss_body),
}


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _REGISTRY:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"registry has {sorted(_REGISTRY)}")
    return _REGISTRY[cfg.family]


def rules_overrides(cfg: ModelConfig, model_axis_size: int) -> dict:
    """Per-arch logical-axis adjustments for divisibility on the mesh.

    * kv heads replicate when they don't divide the model axis (MQA/GQA);
    * MoE: shard the expert dim when divisible, else the per-expert ffn dim;
    * heads fall back to unsharded for tiny head counts (smoke configs)."""
    over: dict[str, Any] = {}
    if cfg.n_kv_heads % model_axis_size != 0:
        over["kv_heads"] = None
    if cfg.n_heads % model_axis_size != 0:
        over["heads"] = None
    if cfg.d_ff and cfg.d_ff % model_axis_size != 0:
        over["mlp"] = None
    if cfg.n_experts:
        if cfg.n_experts % model_axis_size == 0:
            over["expert"] = "model"
            over["expert_mlp"] = None
        else:
            over["expert"] = None
            over["expert_mlp"] = "model" if cfg.d_ff % model_axis_size == 0 else None
    if cfg.vocab_size % model_axis_size != 0:
        over["vocab"] = None
    return over
