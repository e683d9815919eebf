"""The decoder stack of the decoder-only LM families (port of
``repro/models/decoder.py``): dense, moe, ssm, hybrid and vlm, the layer
body chosen by ``cfg.family``.

Params and cache keep the reference's stacked layout, the layer index
first, and the reference's ``lax.scan`` over layers becomes a Python loop
over the layer index. ``cfg.remat`` is the reference's
``jax.checkpoint`` of the layer body: when it is set and grad is on,
:func:`forward` runs each layer under ``torch.utils.checkpoint``
(non-reentrant), so backward recomputes what it needs. With
``remat_policy="nothing"`` a layer is one region (only its input is
kept); ``"save_comm"`` makes the mixer and the MLP / MoE each a region
of its own, so their outputs (the reference's tagged ``attn_out``,
``ssd_out``, ``mlp_out`` and ``moe_out``) stay as the boundary between
them and backward recomputes one sublayer at a time. Under ``no_grad``
nothing changes, as ``jax.checkpoint`` changes nothing in inference, so
serving and the captured graphs are untouched. ``comm_barrier`` is an
XLA fusion knob (``optimization_barrier``) with no counterpart in eager
PyTorch and no effect here. The cache is written in place:
:func:`prefill` and :func:`decode_step` return the tensors they were
given (the SSD leaves ``ssm`` and ``conv`` too). The encoder-decoder
family is ``models/encdec.py``.

:func:`prefill_body` and :func:`decode_body` are the serving paths as
rank bodies (generators of ``distributed.collectives``); :func:`prefill`
and :func:`decode_step` run them off any mesh, where they ask for no
collective. Under ``act_sharding.tensor_parallel`` they compute on the
rank's shards (``models/layers.py``): the embedding looks up the rank's
rows of the vocabulary and sums over the model axis
(:func:`embed_lookup`), and the head returns the rank's columns of the
logits, sharded over the vocabulary as the reference's
``constrain_batch_model(x @ head, 2)`` leaves them. :func:`forward_body`
is the training forward as a rank body (see its note on remat)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, init_dense, rms_norm

#: the families this stack serves (``encdec`` is ``models/encdec.py``)
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
_ATTN = ("dense", "vlm", "moe", "hybrid")        # families with attention
_SSD = ("ssm", "hybrid")                         # families with the SSD mixer


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: the decoder stack has no "
                         f"{cfg.family!r} family; it serves {PORTED_FAMILIES}")


# ---------------------------------------------------------------------------
# per-layer window schedule (0 = full attention)
# ---------------------------------------------------------------------------

def window_schedule(cfg: ModelConfig) -> np.ndarray:
    win = np.full((cfg.n_layers,), cfg.attn_window, np.int32)
    if cfg.attn_window and cfg.global_every:
        win[::cfg.global_every] = 0                   # periodic global layers
    for gl in cfg.global_layers:                      # explicit global layers
        win[gl] = 0
    return win


# ---------------------------------------------------------------------------
# layer init / apply
# ---------------------------------------------------------------------------

def _layer_init(cfg: ModelConfig, gen: torch.Generator, lead=(),
                device=None) -> dict:
    d = cfg.d_model
    ones = lambda: torch.ones(tuple(lead) + (d,), dtype=cfg.dtype, device=device)
    p: dict = {"ln1": ones()}
    if cfg.family in _ATTN:
        p["attn"] = L.attn_init(cfg, gen, lead, device)
    if cfg.family in _SSD:
        p["ssd"] = L.ssd_init(cfg, gen, lead, device)
    if cfg.family == "hybrid":
        p["norm_attn"] = ones()
        p["norm_ssm"] = ones()
    if cfg.family == "moe":
        p["ln2"] = ones()
        p["moe"] = L.moe_init(cfg, gen, lead, device)
    elif cfg.family != "ssm":
        p["ln2"] = ones()
        p["mlp"] = L.mlp_init(cfg, gen, lead, device)
    return p


def _layer_axes(cfg: ModelConfig) -> dict:
    ax: dict = {"ln1": (None,)}
    if cfg.family in _ATTN:
        ax["attn"] = L.attn_axes(cfg)
    if cfg.family in _SSD:
        ax["ssd"] = L.ssd_axes(cfg)
    if cfg.family == "hybrid":
        ax["norm_attn"] = (None,)
        ax["norm_ssm"] = (None,)
    if cfg.family in ("dense", "vlm", "hybrid"):
        ax["ln2"] = (None,)
        ax["mlp"] = L.mlp_axes(cfg)
    elif cfg.family == "moe":
        ax["ln2"] = (None,)
        ax["moe"] = L.moe_axes(cfg)
    return ax


def _stack_axes(tree):
    """Prepend the (unsharded) layer-stack axis to every leaf."""
    if isinstance(tree, dict):
        return {k: _stack_axes(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def _hybrid_mix(p, cfg, ya, ym):
    return 0.5 * (rms_norm(p["norm_attn"], ya, cfg.norm_eps)
                  + rms_norm(p["norm_ssm"], ym, cfg.norm_eps))


def _ffn_out_body(p, cfg, x):
    """Rank body step: the MLP or MoE of the second half's norm
    (mlp_out / moe_out, aux)."""
    if cfg.family == "moe":
        h2 = L.piece(cfg, L.prenorm, p["ln2"], cfg, x)
        return (yield from L.moe_body(p["moe"], cfg, h2))
    return (yield from L.mlp_body(p["mlp"], cfg, x, p["ln2"])), None


def _ffn_out(p, cfg, x):
    return C.run_local(_ffn_out_body(p, cfg, x))


def _ffn(p, cfg, x):
    """The second half of a layer: (x + MLP or MoE of its norm, aux)."""
    y, aux = _ffn_out(p, cfg, x)
    return x + y, aux


def _mixer_out(p, cfg, x, positions, window):
    """The first half's sublayer on the norm of x: attn_out, ssd_out or
    the hybrid's mix of both."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    if cfg.family == "ssm":
        return L.ssd_forward(p["ssd"], cfg, h)
    if cfg.family == "hybrid":
        return _hybrid_mix(p, cfg,
                           L.attn_forward(p["attn"], cfg, h, positions, window),
                           L.ssd_forward(p["ssd"], cfg, h))
    return L.attn_forward(p["attn"], cfg, h, positions, window)


def _layer_forward(p: dict, cfg: ModelConfig, x, positions, window):
    x = x + _mixer_out(p, cfg, x, positions, window)
    if cfg.family == "ssm":
        return x, None
    return _ffn(p, cfg, x)


def remat_active(cfg) -> bool:
    """Whether a training forward recomputes its layers in backward."""
    return bool(cfg.remat) and torch.is_grad_enabled()


def remat(fn, *args):
    """``fn(*args)`` as a checkpointed region: only its inputs are kept
    for backward, which runs it again. The layers draw no random numbers,
    so no RNG state is stashed: reading the card's generator state is
    refused while a train step is captured into a CUDA graph."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _layer_remat(p: dict, cfg: ModelConfig, x, positions, window):
    """:func:`_layer_forward` under ``cfg.remat_policy``."""
    if cfg.remat_policy != "save_comm":
        return remat(_layer_forward, p, cfg, x, positions, window)
    x = x + remat(_mixer_out, p, cfg, x, positions, window)
    if cfg.family == "ssm":
        return x, None
    y, aux = remat(_ffn_out, p, cfg, x)
    return x + y, aux


def _mixer_body(p, cfg, x, positions, window):
    """Rank body step of :func:`_mixer_out` (training): the attention on
    the rank's heads (``layers.attn_body``, the norm inside its region);
    the SSD mixer whole, its leaves gathered over the model axis by the
    train step. Under a sequence split both compute the rank's rows
    (``layers.attn_body``, ``layers.ssd_split_body``) and the hybrid
    mixes them there."""
    split = acts.seq_split_context()
    if split is not None and cfg.family in _SSD:
        ym = yield from L.ssd_split_body(p["ssd"], cfg, x, p["ln1"], split)
        if cfg.family == "ssm":
            return ym
        ya = yield from L.attn_body(p["attn"], cfg, x, positions, window,
                                    p["ln1"])
        return L.piece(cfg, _hybrid_mix, p, cfg, ya, ym)
    if cfg.family == "ssm":
        return L.piece(cfg, _ssd_core, p, cfg, x)
    ya = yield from L.attn_body(p["attn"], cfg, x, positions, window, p["ln1"])
    if cfg.family == "hybrid":
        return L.piece(cfg, _hybrid_mix, p, cfg, ya,
                       L.piece(cfg, _ssd_core, p, cfg, x))
    return ya


def _ssd_core(p, cfg, x):
    """The SSD mixer of the first half's norm."""
    return L.ssd_forward(p["ssd"], cfg, rms_norm(p["ln1"], x, cfg.norm_eps))


def _layer_body(p: dict, cfg: ModelConfig, x, positions, window):
    """Rank body step of :func:`_layer_forward`."""
    x = x + (yield from _mixer_body(p, cfg, x, positions, window))
    if cfg.family == "ssm":
        return x, None
    y, aux = yield from _ffn_out_body(p, cfg, x)
    return x + y, aux


def _layer_prefill(p, cfg, x, positions, cache, window):
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    if cfg.family == "ssm":
        y, cache = yield from L.ssd_prefill_body(p["ssd"], cfg, h, cache)
        return x + y, cache
    ya, cache = yield from L.attn_prefill_body(p["attn"], cfg, h, positions,
                                               cache, window)
    if cfg.family == "hybrid":
        ym, cache = yield from L.ssd_prefill_body(p["ssd"], cfg, h, cache)
        ya = _hybrid_mix(p, cfg, ya, ym)
    x = x + ya
    return x + (yield from _ffn_out_body(p, cfg, x))[0], cache


def _layer_decode(p, cfg, x1, cache, pos, window):
    h = rms_norm(p["ln1"], x1, cfg.norm_eps)
    if cfg.family == "ssm":
        y, cache = L.ssd_decode(p["ssd"], cfg, h, cache)
        return x1 + y, cache
    ya, cache = yield from L.attn_decode_body(p["attn"], cfg, h, cache, pos,
                                              window)
    if cfg.family == "hybrid":
        ym, cache = L.ssd_decode(p["ssd"], cfg, h, cache)
        ya = _hybrid_mix(p, cfg, ya, ym)
    x1 = x1 + ya
    return x1 + (yield from _ffn_out_body(p, cfg, x1))[0], cache


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, so writes reach the stack)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_decoder(cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
                 device="cuda") -> dict:
    """Random params on ``device`` from ``gen`` (default: a CPU generator
    seeded 0), drawn on the generator's device; pass a CUDA generator to
    draw a full-width model on the card. Each stacked leaf is drawn at
    once for all layers."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    d = cfg.d_model
    return {
        "embed": init_dense(gen, (cfg.vocab_size, d), d, cfg.dtype, dev),
        "layers": _layer_init(cfg, gen, (cfg.n_layers,), dev),
        "final_norm": torch.ones((d,), dtype=cfg.dtype, device=dev),
        "head": init_dense(gen, (d, cfg.vocab_size), d, cfg.dtype, dev),
    }


def decoder_axes(cfg: ModelConfig) -> dict:
    """Logical sharding axes of :func:`init_decoder`'s params."""
    return {
        "embed": ("vocab", "embed"),
        "layers": _stack_axes(_layer_axes(cfg)),
        "final_norm": (None,),
        "head": ("embed", "vocab"),
    }


def forward(params: dict, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V) in the model dtype,
    moe_aux)."""
    check_family(cfg)
    x = params["embed"][tokens.long()] if embeds is None else embeds
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    auxs = []
    layer = _layer_remat if remat_active(cfg) else _layer_forward
    for i, win in enumerate(window_schedule(cfg)):
        x, a = layer(layer_slice(params["layers"], i), cfg, x, positions, win)
        auxs.append(a)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.stack(auxs).sum() if cfg.family == "moe" else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return x @ params["head"], aux


def head_logits(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Rank body step: ``x @ head``; on the rank's columns of a vocabulary
    split over the model axis, ``x`` enters through the axis's copy."""
    if params["head"].shape[-1] != cfg.vocab_size:
        x = yield from acts.model_copy(x)
    return x @ params["head"]


def forward_body(params: dict, cfg: ModelConfig,
                 tokens: Optional[torch.Tensor] = None,
                 embeds: Optional[torch.Tensor] = None):
    """Rank body of :func:`forward` for training: no cache, each layer's
    window from :func:`window_schedule`, the MoE layers' aux summed.
    Under ``act_sharding.tensor_parallel`` it computes on the rank's
    shards and returns the rank's columns of the logits (the vocabulary
    split as the head's columns), with the Megatron pair of gradients
    around each split product (``models/layers.py``).

    Remat: a region that recomputes a collective in backward cannot be
    a rank body's, so with ``cfg.remat`` (and grad on) only the local
    pieces between collectives are checkpointed (``layers.piece``: each
    norm with what follows it up to the next collective, so the attention
    from the layer's input to its partial output, the MLP likewise, the
    experts' FFN, the SSD mixer, the hybrid's mix). A layer then keeps
    its input and the input of its second half, each once more as the
    copy that enters the rank's region where the model axis splits it.
    Both ``remat_policy`` values map onto that: ``save_comm`` keeps the
    collectives' outputs, as the reference keeps its tagged ones, and
    ``nothing`` keeps them too, since no region may span a collective
    (the reference recomputes the whole layer from its input).

    Under a sequence split (``act_sharding.seq_split``) ``tokens`` are
    the rank's rows of its data group's sequence: positions start at the
    rank's first row and the logits are those of its rows."""
    check_family(cfg)
    x = embeds if embeds is not None else \
        (yield from embed_lookup(params["embed"], cfg, tokens))
    positions = _positions(x)
    auxs = []
    with L.remat_pieces(remat_active(cfg)):
        for i, win in enumerate(window_schedule(cfg)):
            x, a = yield from _layer_body(layer_slice(params["layers"], i),
                                          cfg, x, positions, win)
            auxs.append(a)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.stack(auxs).sum() if cfg.family == "moe" else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return (yield from head_logits(params, cfg, x)), aux


def _positions(x: torch.Tensor) -> torch.Tensor:
    """The int32 positions of ``x``'s rows: from 0, or from the rank's
    first row under a sequence split."""
    split = acts.seq_split_context()
    first = 0 if split is None else split.start
    return torch.arange(first, first + x.shape[1], dtype=torch.int32,
                        device=x.device)


def last_row(x: torch.Tensor):
    """Rank body step: the last position's row (B, 1, D) of the stream;
    under a sequence split it lies on the axis's last rank, so every
    rank takes it from an all-gather of the ranks' last rows."""
    x = x[:, -1:]
    split = acts.seq_split_context()
    if split is not None:
        x = (yield from acts.seq_gather(split, x))[:, -1:]
    return x


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """Stacked (n_layers leading axis) cache: the ring-buffer KV cache of
    the attention families, the SSD states of ssm and hybrid."""
    check_family(cfg)
    dev, lead = resolve_device(device), (cfg.n_layers,)
    cache: dict = {}
    if cfg.family in _ATTN:
        cache.update(L.attn_cache_init(cfg, batch, cache_len, lead, dev))
    if cfg.family in _SSD:
        cache.update(L.ssd_cache_init(cfg, batch, lead, dev))
    return cache


def embed_lookup(table: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor):
    """Rank body step: the rows of ``tokens``. On the rank's rows of a
    vocabulary split over the model axis, a masked lookup (zero rows for
    ids outside them) and the sum over the axis, exact: one rank adds
    each row."""
    ids = tokens.long()
    n = table.shape[0]
    if n == cfg.vocab_size:
        return table[ids]
    tp = acts.tensor_parallel_context()
    ids = ids - tp.index * n
    inside = (ids >= 0) & (ids < n)
    rows = torch.where(inside[..., None], table[ids.clamp(0, n - 1)], 0)
    return (yield C.row_sum(tp.axis, rows))


def prefill_body(params: dict, cfg: ModelConfig, cache: dict,
                 tokens: Optional[torch.Tensor] = None,
                 embeds: Optional[torch.Tensor] = None,
                 prefix: Optional[torch.Tensor] = None):
    """Rank body of :func:`prefill`; ``prefix`` (B, P, D) embeddings go
    before the tokens' (the vlm's image patches). Under a sequence split
    the rank's rows of the prompt (no ``prefix``): every rank writes the
    whole cache and returns the last position's logits (the final norm
    and the head of that one row, :func:`last_row`)."""
    check_family(cfg)
    x = embeds if embeds is not None else \
        (yield from embed_lookup(params["embed"], cfg, tokens))
    if prefix is not None:
        if acts.seq_split_context() is not None:
            raise ValueError(f"{cfg.name}: a sequence split cuts the tokens, "
                             "not a prefix of embeddings")
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    positions = _positions(x)
    for i, win in enumerate(window_schedule(cfg)):
        x, _ = yield from _layer_prefill(layer_slice(params["layers"], i),
                                         cfg, x, positions,
                                         layer_slice(cache, i), win)
    x = rms_norm(params["final_norm"], (yield from last_row(x)), cfg.norm_eps)
    return (yield from head_logits(params, cfg, x))[:, 0].float(), cache


def prefill(params: dict, cfg: ModelConfig, cache: dict,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None):
    """Prefill S tokens into the cache; returns (last-position logits (B,V)
    float32, cache)."""
    return C.run_local(prefill_body(params, cfg, cache, tokens, embeds))


def decode_body(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos):
    """Rank body of :func:`decode_step`."""
    check_family(cfg)
    x = yield from embed_lookup(params["embed"], cfg, tokens[:, None])
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(
        tokens.shape[0]).contiguous()
    for i, win in enumerate(window_schedule(cfg)):
        x, _ = yield from _layer_decode(layer_slice(params["layers"], i), cfg,
                                        x, layer_slice(cache, i), pos, win)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return (yield from head_logits(params, cfg, x))[:, 0].float(), cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos):
    """One decode step. tokens (B,) integer; pos (B,) int32 per-request
    positions (a scalar broadcasts — uniform batch).

    Returns (logits (B,V) float32, cache)."""
    return C.run_local(decode_body(params, cfg, cache, tokens, pos))
