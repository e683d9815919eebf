"""Dry-run cells for the paper's own workload: DETR-family encoders built
on MSDeformAttn (baseline and DEFA-optimized variants); port of
``repro/launch/detr_cells.py``.

serve: batched encoder inference (the paper's Fig. 9 comparison workload);
train: encoder fwd+bwd+AdamW with a denoising proxy objective (the same
sharding and collective structure as full DETR training without hauling
a conv backbone through the dry run); banded: the DEFA encoder with
band-sharded queries and values and a range-narrowing-bounded halo
exchange over the model axis (:func:`build_banded_detr_stack`, the
function over a mesh, and :func:`build_banded_detr_cell`, its cell).

Each cell's program stores the parameters as the rule table
(:func:`_detr_rules`) shards them: the encoder FFN's ``ffn1`` columns and
``ffn2`` rows over the model axis, everything else (the 8 attention
heads among it) whole. The serve and train cells compute on those shards,
as the reference's partitioner does: each rank runs the attention whole
and its slice of the FFN (``core.encoder.encoder_body`` under
``act_sharding.tensor_parallel``: Megatron's copy into the FFN and the
model axis's sum out of it), gathering no parameter. The train cell is
``train.step.train_rank_body`` over a ``ModelAPI`` whose ``loss_body``
is that encoder and the rolled-target MSE, so its gradients cross the
same pair; its encoder samples through ``torch_gather``: the kernels K1
and K3 are forward-only (the reference's ``pallas_call`` has no
autodiff rule either). The banded cell keeps its gather: its model axis
carries bands of tokens, so each rank's FFN needs the whole weights, as
XLA's does. Both bodies run under ``act_sharding.batch_split``, so the
DEFA config's INT12 scales are the whole batch's, as the reference's
partitioner takes them over images split on the data axis."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.detr_family import CONFIGS as DETR_CONFIGS
from repro_torch.core import nn as core_nn
from repro_torch.core.distributed_msdeform import (band_layout,
                                                   msdeform_attn_banded)
from repro_torch.core.encoder import (EncoderConfig, encoder_body,
                                      encoder_logical_axes, init_encoder)
from repro_torch.core.msdeform_attn import MSDeformAttnConfig
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import CommStats, mesh_shape
from repro_torch.distributed.sharding import (AxisRules, P, _BASE, is_spec,
                                              is_logical_axes,
                                              logical_to_spec, tree_map)
from repro_torch.launch.input_specs import (Cell, _batch_spec, _meta,
                                            _train_program, gather_tree,
                                            spmd_program, traced_shapes)
from repro_torch.models.registry import ModelAPI
from repro_torch.optim.adamw import OptConfig, adamw_init
from repro_torch.train.step import TrainState, train_rank_body, zero_spec
from repro_torch.utils.tree import tree_size


def _detr_rules(mesh) -> AxisRules:
    # d_model=256/8 heads: heads (8) don't divide model=16 -> replicate heads;
    # the encoder ffn (1024) and value rows carry the model-axis sharding.
    return AxisRules({**_BASE, "heads": None})


class BandedStack(NamedTuple):
    """The banded serve stack of one DETR config on one mesh."""
    fn: Callable                 # (params, x_flat, pos, refs, stats=None) -> h
    enc_cfg: EncoderConfig
    attn_cfg: MSDeformAttnConfig  # the encoder's, FWP off (banded v1)
    level_shapes: Tuple[Tuple[int, int], ...]
    padded_shapes: Tuple[Tuple[int, int], ...]
    n_pad: int
    param_specs: dict            # PartitionSpecs of the encoder's params
    batch_axes: Tuple[str, ...]  # the axes the batch splits over


def padded_geometry(level_shapes, n_bands: int, ranges):
    """Each level padded to n_bands * rows_per_band rows, and the
    padded pixel count."""
    rows, _ = band_layout(level_shapes, n_bands, ranges)
    padded = tuple((rb * n_bands, w) for (_, w), rb in zip(level_shapes, rows))
    return padded, sum(hp * w for hp, w in padded)


def band_major_refs(padded_shapes, n_bands: int, batch: int,
                    device=None) -> torch.Tensor:
    """(B, N_pad, 2) float32 reference points at the padded grid's pixel
    centres, in band-major order (the banded layer's layout)."""
    refs = []
    for r in range(n_bands):
        for hp, w in padded_shapes:
            rb = hp // n_bands
            ys, xs = np.meshgrid((np.arange(r * rb, (r + 1) * rb) + 0.5) / hp,
                                 (np.arange(w) + 0.5) / w, indexing="ij")
            refs.append(np.stack([xs.reshape(-1), ys.reshape(-1)], 1))
    t = torch.as_tensor(np.concatenate(refs, 0), dtype=torch.float32,
                        device=device)
    return t[None].expand(batch, -1, -1)


def build_banded_detr_stack(name: str, mesh, batch: Optional[int] = None,
                            enc_cfg: Optional[EncoderConfig] = None,
                            level_shapes=None) -> BandedStack:
    """The DEFA encoder with band-sharded queries+values over the mesh's
    "model" axis (one band per rank) and the batch over its data axes.

    ``fn(params, x_flat, pos, refs)`` takes the band-major padded pyramid
    (B, N_pad, D), positions (N_pad, D) and reference points (B, N_pad, 2):
    global tensors on an ``InProcessMesh``, this rank's on a
    ``DeviceMesh``. ``enc_cfg`` replaces the config's encoder (another
    dtype, no INT12) and ``level_shapes`` its pyramid (for one band: a
    pyramid padded for more, to run the same pixels on one card)."""
    acfg = DETR_CONFIGS[name]
    level_shapes = tuple(level_shapes or acfg.level_shapes)
    enc_cfg = enc_cfg or acfg.encoder
    attn_cfg = dataclasses.replace(enc_cfg.attn, fwp_mode="off")  # banded v1
    if attn_cfg.range_narrow is None:
        raise ValueError(f"{name}: the banded encoder needs range narrowing")
    sizes = mesh_shape(mesh)
    n_bands = sizes["model"]
    b = batch or acfg.serve_batch
    padded_shapes, n_pad = padded_geometry(level_shapes, n_bands,
                                           attn_cfg.range_narrow)
    rules = _detr_rules(mesh)
    param_specs = tree_map(lambda a: logical_to_spec(a, rules),
                           encoder_logical_axes(enc_cfg),
                           is_leaf=is_logical_axes)
    b_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_dp = 1
    for a in b_axes:
        n_dp *= sizes[a]
    if b % n_dp:
        b_axes = ()                         # an odd batch stays replicated

    def serve_fn(params, x_flat, pos, refs, stats: Optional[CommStats] = None):
        h = x_flat
        for blk in params["blocks"]:
            q = h + pos[None]
            attn = msdeform_attn_banded(blk["attn"], attn_cfg, q, refs, h,
                                        padded_shapes, mesh,
                                        batch_axes=b_axes, stats=stats)
            h = core_nn.layer_norm(blk["ln1"], h + attn)
            ff = core_nn.linear(blk["ffn2"],
                                torch.relu(core_nn.linear(blk["ffn1"], h)))
            h = core_nn.layer_norm(blk["ln2"], h + ff)
        return h

    return BandedStack(serve_fn, enc_cfg, attn_cfg, level_shapes,
                       padded_shapes, n_pad, param_specs, b_axes)


def _param_specs(enc_cfg: EncoderConfig, mesh) -> dict:
    rules = _detr_rules(mesh)
    return tree_map(lambda a: logical_to_spec(a, rules),
                    encoder_logical_axes(enc_cfg), is_leaf=is_logical_axes)


def _params_sds(enc_cfg: EncoderConfig) -> dict:
    return traced_shapes(lambda: init_encoder(
        enc_cfg, torch.Generator().manual_seed(0), device="cpu"))


def _meta_of(arch: str, kind: str, n: int, b: int, mesh, params_sds) -> dict:
    sizes = mesh_shape(mesh)
    n_params = tree_size(params_sds)
    return {"arch": arch, "shape": f"detr_{kind}_b{b}", "kind": kind,
            "seq_len": n, "global_batch": b, "mesh": dict(sizes),
            "n_chips": math.prod(sizes.values()), "params": n_params,
            "active_params": n_params}


def _loss_body(enc_cfg: EncoderConfig, level_shapes) -> Callable:
    """The train cell's objective as a rank body: the encoder on the
    rank's FFN shard (sampling through ``torch_gather``) and the MSE to
    the pyramid rolled by one token."""
    def loss_body(p, _cfg, batch):
        out, _ = yield from encoder_body(p, enc_cfg, batch["x"], batch["pos"],
                                         batch["refs"], level_shapes,
                                         backend="torch_gather")
        tgt = torch.roll(batch["x"], 1, dims=1).detach()
        return torch.mean(torch.square(out - tgt).float()), {}
    return loss_body


def build_detr_cell(name: str, kind: str, mesh, batch: Optional[int] = None,
                    backend: Optional[str] = None,
                    enc_cfg: Optional[EncoderConfig] = None) -> Cell:
    """serve: ``encoder_body`` on this rank's images and FFN shard;
    train: the rolled-target MSE, its gradient and AdamW on
    ``zero_spec`` moments (``train.step.train_rank_body`` over a
    ``ModelAPI`` with that ``loss_body``; ``Cell.body`` the rank body
    with args (params, opt, x, pos, refs) -> (params, opt, loss), run
    with grad on; ``Cell.fn`` runs it on a ``DeviceMesh``). ``backend`` is the serve encoder's sampling backend (default:
    the config's, ``torch_gather`` for the family's ``impl="jnp"``, as
    the reference's cells sample with ``jnp_gather``; ``"auto"`` plans
    for the card, K1 there). ``enc_cfg`` replaces the config's encoder
    (another dtype or depth)."""
    acfg = DETR_CONFIGS[name]
    enc_cfg = enc_cfg or acfg.encoder
    level_shapes = acfg.level_shapes
    n_in = sum(h * w for h, w in level_shapes)
    d = enc_cfg.d_model
    b = batch or (acfg.train_batch if kind == "train" else acfg.serve_batch)
    dtype = enc_cfg.dtype

    param_specs = _param_specs(enc_cfg, mesh)
    params_sds = _params_sds(enc_cfg)
    bspec = _batch_spec(mesh, b)
    x_sds = _meta((b, n_in, d), dtype)
    x_sh = P(*bspec, None, None)
    pos_sds = _meta((n_in, d), dtype)
    ref_sds = _meta((n_in, 2), torch.float32)
    rep = P(None, None)
    meta = _meta_of(name, kind, n_in, b, mesh, params_sds)

    if kind == "serve":
        def body(ctx, params, x_flat, pos, refs):
            with acts.tensor_parallel(ctx), acts.batch_split(ctx):
                out, _ = yield from encoder_body(params, enc_cfg, x_flat, pos,
                                                 refs, level_shapes,
                                                 backend=backend)
            return out

        return Cell(name=f"{name}/serve", fn=spmd_program(body, mesh),
                    in_specs=(params_sds, x_sds, pos_sds, ref_sds),
                    in_shardings=(param_specs, x_sh, rep, rep),
                    out_shardings=x_sh, meta=meta, body=body)

    assert kind == "train"
    opt_cfg = OptConfig()
    opt_sds = traced_shapes(lambda: adamw_init(params_sds))
    m_specs = tree_map(lambda sp, p: zero_spec(sp, tuple(p.shape), mesh),
                       param_specs, params_sds, is_leaf=is_spec)
    opt_sh = {"m": m_specs, "v": m_specs, "step": P()}

    loss_body = _loss_body(enc_cfg, level_shapes)
    api = ModelAPI(*(None,) * len(ModelAPI._fields))._replace(
        loss_body=loss_body)
    rank_step = train_rank_body(enc_cfg, opt_cfg,
                                TrainState(param_specs, opt_sh, P()), api)

    def body(ctx, params, opt, x_flat, pos, refs):
        new_p, new_opt, _, metrics = yield from rank_step(
            ctx, params, opt, opt["step"], {"x": x_flat, "pos": pos,
                                            "refs": refs})
        return new_p, new_opt, metrics["loss"]

    return Cell(name=f"{name}/train", fn=_train_program(body, mesh),
                in_specs=(params_sds, opt_sds, x_sds, pos_sds, ref_sds),
                in_shardings=(param_specs, opt_sh, x_sh, rep, rep),
                out_shardings=(param_specs, opt_sh, None), meta=meta,
                donate=(0, 1), body=body)


def build_banded_detr_cell(name: str, mesh, batch: Optional[int] = None
                           ) -> Cell:
    """The banded serve stack (:func:`build_banded_detr_stack`) as a cell:
    the rank gathers the parameters, then runs its band of its images."""
    acfg = DETR_CONFIGS[name]
    enc_cfg = acfg.encoder
    b = batch or acfg.serve_batch
    stack = build_banded_detr_stack(name, mesh, batch=b)
    d = enc_cfg.d_model
    dtype = enc_cfg.dtype
    params_sds = _params_sds(enc_cfg)
    param_specs = stack.param_specs
    bspec = _batch_spec(mesh, b)
    x_sh = P(*bspec, "model", None)
    x_sds = _meta((b, stack.n_pad, d), dtype)
    pos_sds = _meta((stack.n_pad, d), dtype)
    ref_sds = _meta((b, stack.n_pad, 2), torch.float32)
    pos_sh = P("model", None)
    meta = _meta_of(name + "-banded", "serve", stack.n_pad, b, mesh,
                    params_sds)

    def gather_params(ctx, params):
        return (yield from gather_tree(params, param_specs, ctx.size))

    def fn(params, x_flat, pos, refs):
        full = C.run_spmd(gather_params(C.rank_context(mesh), params), mesh)
        return stack.fn(full, x_flat, pos, refs)

    return Cell(name=f"{name}-banded/serve", fn=fn,
                in_specs=(params_sds, x_sds, pos_sds, ref_sds),
                in_shardings=(param_specs, x_sh, pos_sh, x_sh),
                out_shardings=x_sh, meta=meta)
