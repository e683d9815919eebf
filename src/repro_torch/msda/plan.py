"""MSDAPlan — the static execution plan for one (config, level_shapes)
(port of the subset of repro/msda/plan.py that the serving path needs).

The plan decides, once per shape family:

  * **backend** — ``torch_gather`` | ``cuda_fused`` | ``cuda_windowed``
    | ``cuda_decode``. Requests resolve in the reference's order:
    explicit argument > ``cfg.backend`` > legacy ``cfg.impl`` (``"jnp"``
    -> ``torch_gather``, ``"pallas"`` -> ``cuda_fused``). ``"auto"``
    resolves to ``cuda_fused`` for raster launches and to ``cuda_decode``
    for decode-shaped ones; it never picks ``cuda_windowed``, which is
    asked for by name. The TPU's VMEM and staging gates have no H100
    counterpart; deriving ``auto`` from H100 limits (shared memory, L2)
    is later work. The CUDA backends take their plain PyTorch version
    for tensors on the CPU, so every plan also runs there;
  * **windowed geometry** — ``tile_q`` and the reference's staged-window
    accounting ``window_bytes`` / ``window_bytes_compact``, equal to the
    reference plan's fields;
  * **table dtype** — arg > ``cfg.table_dtype`` > ``REPRO_MSDA_TABLE_DTYPE``
    > ``cfg.dtype``;
  * **lane layout** — kept from the reference because the decode staging
    layout (``head_pack`` heads side by side per row) is defined by it and
    must stay bit-identical to the reference's staged table;
  * **query order** — ``"none"``, ``"raster"`` or ``"zorder"``
    (:func:`repro_torch.msda.ordering.resolve_query_order`);
  * **streaming budget** — ``stream_update_rows``, the rows an
    incremental frame re-projects (``repro_torch/stream/``).

The measured per-tile window of an ordered query set
(``with_measured_tile_window``) and the autotuned plan table wait for
the autotune slice: :func:`tuned_stream_params` returns None until then.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import fwp as fwp_lib
from repro_torch.msda.ordering import resolve_query_order

_LANE_WIDTH = 128
_BLOCK_Q = 128                   # the reference's default query tile

#: Table storage dtypes the cache/kernels understand (canonical names).
_TABLE_DTYPES = ("int8", "float32", "bfloat16", "float16")
_ITEMSIZE = {"int8": 1, "float32": 4, "bfloat16": 2, "float16": 2}
_TORCH_DTYPE_NAMES = {torch.int8: "int8", torch.float32: "float32",
                      torch.bfloat16: "bfloat16", torch.float16: "float16"}


def _dtype_name(choice) -> str:
    if isinstance(choice, torch.dtype):
        if choice not in _TORCH_DTYPE_NAMES:
            raise ValueError(f"unsupported MSDA table dtype {choice}; "
                             f"supported: {_TABLE_DTYPES}")
        return _TORCH_DTYPE_NAMES[choice]
    name = str(choice)
    if name not in _TABLE_DTYPES:
        raise ValueError(f"unsupported MSDA table dtype {name!r}; "
                         f"supported: {_TABLE_DTYPES}")
    return name


def resolve_table_dtype(cfg, override: Optional[str] = None) -> str:
    """Resolve the value-table storage dtype for one config.

    Precedence: explicit ``override`` > ``cfg.table_dtype`` > the
    ``REPRO_MSDA_TABLE_DTYPE`` env var > ``cfg.dtype``. Returns a
    canonical dtype name string."""
    choice = override
    if choice is None:
        choice = getattr(cfg, "table_dtype", None)
    if choice is None:
        choice = os.environ.get("REPRO_MSDA_TABLE_DTYPE") or None
    if choice is None:
        choice = cfg.dtype
    return _dtype_name(choice)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(1, int(n)) - 1).bit_length()


def block_q_for_levels(level_shapes: Sequence[Tuple[int, int]],
                       block_q: int) -> Tuple[int, ...]:
    """Per-query-level tile size: ``min(block_q, next_pow2(nq_l))``, so
    the tiny levels' tiles stay tiny."""
    return tuple(min(block_q, next_pow2(h * w)) for h, w in level_shapes)


def windowed_eligible(cfg) -> bool:
    """The windowed kernel needs a finite sampling radius (range
    narrowing) to bound its fmap window."""
    return cfg.range_narrow is not None


def lane_layout(n_heads: int, head_dim: int) -> Tuple[str, int]:
    """The reference's last-dim layout: ``("native", 1)`` when Dh fills
    128 lanes, ``("pack", g)`` when g = gcd(n_heads, 128 // Dh) heads share
    one lane group, else ``("pad", 1)``."""
    if head_dim % _LANE_WIDTH == 0:
        return "native", 1
    if head_dim < _LANE_WIDTH and _LANE_WIDTH % head_dim == 0:
        g = math.gcd(n_heads, _LANE_WIDTH // head_dim)
        if g > 1:
            return "pack", g
    return "pad", 1


@dataclasses.dataclass(frozen=True)
class MSDAPlan:
    """Static per-(config, level_shapes) execution plan. Hashable."""
    cfg: object                                     # MSDeformAttnConfig
    level_shapes: Tuple[Tuple[int, int], ...]
    backend: str                 # resolved registry name (never "auto")
    lane_layout: str             # "native" | "pad" | "pack"
    head_pack: int               # heads per 128-lane group (1 unless packed)
    n_in: int                    # total flat pixels across levels
    tile_q: int = _BLOCK_Q       # query tile of the windowed kernel
    #   (= max of the per-level tiles; the decode tile when decode-shaped)
    window_bytes: Optional[int] = None          # the reference's dense
    #   staged-window bytes per grid step (max over tile x level pairs)
    window_bytes_compact: Optional[int] = None  # the same for the
    #   FWP-compact table: slot windows + the pix2slot window slices
    n_queries: Optional[int] = None   # decode-shaped launches: learned
    #   query count (None => raster encoder queries, Nq == n_in)
    n_consumers: int = 1         # attention layers sharing one value cache
    stream_update_rows: Optional[int] = None   # streaming: the static
    #   per-frame re-projection budget (table rows an incremental frame
    #   refreshes); None => no streaming consumer
    table_dtype: str = "float32"
    query_order: str = "none"

    @property
    def quantized_table(self) -> bool:
        """True when the table is stored as int8 codes + f32 scale."""
        return self.table_dtype == "int8"

    @property
    def table_itemsize(self) -> int:
        return _ITEMSIZE[self.table_dtype]

    @property
    def decode_shaped(self) -> bool:
        return self.n_queries is not None and self.n_queries != self.n_in

    @property
    def decode_head_pack(self) -> int:
        """Heads per row group of the decode staging layout."""
        return self.head_pack if self.lane_layout == "pack" else 1

    def table_bytes_for_rows(self, n_rows: int, with_indirection: bool) -> int:
        """Bytes of an ``n_rows`` table per (batch, head-group) under the
        reference's lane layout, plus the int32 ``pix2slot`` indirection
        when compacted and one f32 scale row when quantized."""
        lanes = self.cfg.head_dim if self.lane_layout == "native" \
            else _LANE_WIDTH
        b = n_rows * lanes * self.table_itemsize
        if with_indirection:
            b += self.n_in * 4
        if self.quantized_table:
            b += lanes * 4
        return b

    @property
    def cache_table_bytes(self) -> int:
        """Static estimate of the built table, assuming FWP compaction."""
        if self.cfg.fwp_mode == "compact":
            caps = fwp_lib.level_capacities(self.level_shapes,
                                            self.cfg.fwp_capacity)
            return self.table_bytes_for_rows(sum(caps) + 1,
                                             with_indirection=True)
        return self.table_bytes_for_rows(self.n_in, with_indirection=False)

    @property
    def value_table_bytes(self) -> int:
        """The dense n_in-row table per (batch, head-group): what block 1
        of the encoder, which runs unpruned, samples."""
        return self.table_bytes_for_rows(self.n_in, with_indirection=False)

    def snapshot(self) -> dict:
        """Structured twin of :meth:`describe`: every static decision and
        staged-bytes figure as plain JSON-able values, under the keys of
        the reference's ``MSDAPlan.snapshot`` (repro/msda/plan.py:402-456)
        for the fields this plan has. ``decode`` is None unless the plan
        is decode-shaped; ``stream`` is None unless the plan carries a
        streaming budget."""
        snap = {
            "backend": self.backend,
            "tile_q": self.tile_q,
            "lane_layout": self.lane_layout,
            "head_pack": self.head_pack,
            "table_dtype": self.table_dtype,
            "quantized_table": self.quantized_table,
            "value_table_bytes": self.value_table_bytes,
            "window_bytes": self.window_bytes,
            "window_bytes_compact": self.window_bytes_compact,
            "query_order": self.query_order,
            "n_in": self.n_in,
            "level_shapes": [list(s) for s in self.level_shapes],
            "decode": None,
            "stream": None,
        }
        if self.decode_shaped:
            cb = self.cache_table_bytes
            snap["decode"] = {
                "n_queries": self.n_queries,
                "n_consumers": self.n_consumers,
                "cache_table_bytes": cb,
                # staging the cache once vs rebuilding it per consumer layer
                "rebuild_bytes": self.n_consumers * cb,
            }
        if self.stream_update_rows is not None:
            snap["stream"] = {
                "update_rows": self.stream_update_rows,
                # an incremental frame restages at most update_rows rows
                # (no pix2slot restage) against a full per-frame rebuild
                "update_bytes": self.table_bytes_for_rows(
                    self.stream_update_rows, with_indirection=False),
                "rebuild_bytes": self.cache_table_bytes,
            }
        return snap

    def describe(self) -> str:
        """One-line summary: a formatter over :meth:`snapshot`."""
        s = self.snapshot()
        win = ""
        if s["window_bytes"] is not None:
            win = f", win={s['window_bytes'] / 1024:.0f}KB"
            if s["window_bytes_compact"] is not None:
                win += f"(compact {s['window_bytes_compact'] / 1024:.0f}KB)"
        q = ""
        if s["decode"] is not None:
            d = s["decode"]
            q = (f", q=decode({d['n_queries']})x{d['n_consumers']}, "
                 f"cache={d['cache_table_bytes'] / 1024:.0f}KB build-once")
        if s["query_order"] != "none":
            win += f", order={s['query_order']}"
        if s["stream"] is not None:
            st = s["stream"]
            q += (f", stream<={st['update_rows']}rows/frame "
                  f"({st['update_bytes'] / 1024:.0f}KB vs "
                  f"{st['rebuild_bytes'] / 1024:.0f}KB rebuild, "
                  f"{st['rebuild_bytes'] / max(st['update_bytes'], 1):.1f}x)")
        return (f"MSDAPlan(backend={s['backend']}, "
                f"lanes={s['lane_layout']}x{s['head_pack']}, "
                f"tdtype={s['table_dtype']}, "
                f"table={s['value_table_bytes'] / 1024:.0f}KB{win}{q}, "
                f"n_in={s['n_in']})")


_LEGACY_IMPL = {"jnp": "torch_gather", "pallas": "cuda_fused"}


def make_plan(cfg, level_shapes: Sequence[Tuple[int, int]], *,
              backend: Optional[str] = None,
              n_queries: Optional[int] = None,
              n_consumers: int = 1,
              stream_update_rows: Optional[int] = None,
              table_dtype: Optional[str] = None,
              query_order: Optional[str] = None) -> MSDAPlan:
    """Resolve the static plan (see the module docstring for the order).

    ``stream_update_rows``: the streaming consumer's static per-frame
    re-projection budget; accounting and capacity only (``describe()``
    and the ``TemporalCacheManager``'s update cap)."""
    from repro_torch.msda import backends as backend_registry

    level_shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    _, n_in = fwp_lib.level_starts(level_shapes)
    layout, pack = lane_layout(cfg.n_heads, cfg.head_dim)
    decode_shaped = n_queries is not None and n_queries != n_in
    tdtype = resolve_table_dtype(cfg, table_dtype)

    # the reference's windowed accounting (repro/msda/plan.py:616-656):
    # table itemsize, reference lane layout, one f32 scale row when int8
    if decode_shaped:
        tile_q = min(_BLOCK_Q, next_pow2(n_queries))
    else:
        tile_q = max(block_q_for_levels(level_shapes, _BLOCK_Q))
    window_bytes = window_bytes_compact = None
    if windowed_eligible(cfg) and not decode_shaped:
        from repro_torch.kernels.msgs_windowed import window_geometry
        lanes = cfg.head_dim if layout == "native" else _LANE_WIDTH
        t_item = _ITEMSIZE[tdtype]
        scale_extra = lanes * 4 if tdtype == "int8" else 0
        geo = window_geometry(level_shapes,
                              tuple(float(r) for r in cfg.range_narrow),
                              tile_q)
        window_bytes = geo.staged_bytes(lanes, t_item) + scale_extra
        if cfg.fwp_mode == "compact":
            caps = fwp_lib.level_capacities(level_shapes, cfg.fwp_capacity)
            window_bytes_compact = geo.staged_bytes(lanes, t_item,
                                                    caps=caps) + scale_extra

    requested = backend
    if requested is None:
        requested = getattr(cfg, "backend", None)
    if requested is None:
        requested = _LEGACY_IMPL.get(cfg.impl, cfg.impl)
    if requested == "auto":
        requested = "cuda_decode" if decode_shaped else "cuda_fused"

    if requested not in backend_registry.available_backends():
        raise ValueError(
            f"unknown MSDA backend {requested!r}; "
            f"available: {backend_registry.available_backends()}")
    info = backend_registry.backend_info(requested)
    if requested == "cuda_windowed" and not windowed_eligible(cfg):
        raise ValueError(f"{requested} needs cfg.range_narrow set (the "
                         "bound is what makes the fmap window finite)")
    if info.raster_only and decode_shaped:
        raise ValueError(
            f"{requested} needs raster encoder queries (Nq == N_in); "
            f"decode-shaped launches (n_queries={n_queries}) cannot use it")
    if info.decode_only and not decode_shaped:
        raise ValueError(
            f"{requested} is a decode-shaped backend (N_q learned "
            f"queries): pass n_queries != N_in, or plan a raster backend")

    return MSDAPlan(cfg=cfg, level_shapes=level_shapes, backend=requested,
                    lane_layout=layout, head_pack=pack, n_in=n_in,
                    tile_q=tile_q, window_bytes=window_bytes,
                    window_bytes_compact=window_bytes_compact,
                    n_queries=n_queries, n_consumers=n_consumers,
                    stream_update_rows=stream_update_rows,
                    table_dtype=tdtype,
                    query_order=resolve_query_order(cfg, query_order))


def tuned_stream_params() -> Optional[dict]:
    """The measured streaming crossover ({diff_channel_stride,
    update_frac}) of an applied autotune entry, consumed by
    :func:`repro_torch.stream.temporal.resolve_stream_config`. None: the
    port has no autotune table yet, so the defaults stand."""
    return None


def plan_for(cfg, level_shapes: Tuple[Tuple[int, int], ...],
             backend: Optional[str] = None,
             n_queries: Optional[int] = None,
             n_consumers: int = 1) -> MSDAPlan:
    """Memoized make_plan, keyed on the RESOLVED table dtype and query
    order so a changed env var never serves a stale plan."""
    return _plan_for_cached(cfg, tuple(level_shapes), backend, n_queries,
                            n_consumers, resolve_table_dtype(cfg),
                            resolve_query_order(cfg))


@functools.lru_cache(maxsize=256)
def _plan_for_cached(cfg, level_shapes, backend, n_queries, n_consumers,
                     table_dtype: str, query_order: str) -> MSDAPlan:
    return make_plan(cfg, level_shapes, backend=backend, n_queries=n_queries,
                     n_consumers=n_consumers, table_dtype=table_dtype,
                     query_order=query_order)


def level_shapes_for_resolution(resolution: int,
                                strides: Tuple[int, ...] = (4, 8, 16, 32)
                                ) -> Tuple[Tuple[int, int], ...]:
    """The square pyramid level shapes of one serving resolution bucket;
    the resolution must divide every stride."""
    r = int(resolution)
    if r <= 0:
        raise ValueError(f"bucket resolution must be positive, got {r}")
    bad = [s for s in strides if r % s]
    if bad:
        raise ValueError(
            f"bucket resolution {r} is not divisible by pyramid "
            f"stride(s) {bad}; serving buckets must be multiples of "
            f"{max(strides)}")
    return tuple((r // s, r // s) for s in strides)
