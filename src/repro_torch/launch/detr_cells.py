"""The paper's own workload distributed: the band-sharded DEFA encoder
serve stack (port of the torch-meaningful part of
``repro/launch/detr_cells.py``).

The reference builds AOT-compiled ``Cell``s (sharded input specs for
``jax.jit(...).lower().compile()``) for its dry runs; those wait for the
port of the XLA tools. What has a meaning here is the rule table
(:func:`_detr_rules`) and the banded 6-block serve stack of
``build_banded_detr_cell``: the DEFA encoder with band-sharded queries
and values and a range-narrowing-bounded halo exchange over the model
axis, as a function over a mesh (:func:`build_banded_detr_stack`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.detr_family import CONFIGS as DETR_CONFIGS
from repro_torch.core import nn as core_nn
from repro_torch.core.distributed_msdeform import (band_layout,
                                                   msdeform_attn_banded)
from repro_torch.core.encoder import EncoderConfig, encoder_logical_axes
from repro_torch.core.msdeform_attn import MSDeformAttnConfig
from repro_torch.distributed.collectives import CommStats, mesh_shape
from repro_torch.distributed.sharding import (AxisRules, _BASE, is_logical_axes,
                                              logical_to_spec, tree_map)


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
