"""MSDAPlan — the static execution plan for one (config, level_shapes)
(port of repro/msda/plan.py).

Resolved once per shape family (``plan_for`` memoizes). The plan decides,
ahead of execution:

  * **backend** — ``torch_gather`` | ``cuda_fused`` | ``cuda_windowed``
    | ``cuda_decode``. Requests resolve in the reference's order:
    explicit argument > ``cfg.backend`` > legacy ``cfg.impl`` (``"jnp"``
    -> ``torch_gather``, ``"pallas"`` -> ``cuda_fused``). ``"auto"`` is
    the reference's policy with its backends mapped (``pallas_fused`` ->
    ``cuda_fused``, ``pallas_windowed`` -> ``cuda_windowed``,
    ``pallas_decode`` -> ``cuda_decode``, ``jnp_gather`` ->
    ``torch_gather``): K1 when the table fits the whole-table budget,
    else K3 when the staged windows fit the staging budget, else the
    gather; decode-shaped launches take K2 when the staged table plus one
    layer's operands fit both budgets and no measurement vetoes it. The
    reference's last resort, the gather, exists because its fused kernel
    needs the table in VMEM; K1 gathers from global memory at any table
    size, so a plan for a card takes K1 there and only a plan for the
    CPU takes ``torch_gather``. The CUDA backends take their plain
    PyTorch version for tensors on the CPU, so every plan also runs
    there;
  * **budgets** — a per-(batch, head-group) heuristic on the H100. K1,
    K2 and K3 stage nothing in shared memory: they gather table rows
    from global memory, and the L2 (50 MiB on the H100) is the tier that
    makes a gather cheaper than HBM. The figures held to the budgets
    are the reference's bytes per (batch, head-group), while what stays
    resident in L2 is every head group of every image at once, so
    "fits" does not mean "stays in L2" unless batch x head groups is 1.
    The static defaults are the L2 capacity of the card a plan is for
    (:func:`platform_of`); an applied autotune entry replaces the
    staging budget with the knee K1's gather cost shows over whole
    one-image tables (:mod:`repro_torch.msda.autotune`), with the
    reference's precedence (``REPRO_MSDA_VMEM_BUDGET`` pin > the entry
    applied for the plan's platform > static default);
  * **query tiling** — ``block_q``, the per-level ``block_q_levels``,
    the windowed kernel's ``tile_q`` and the reference's staged-window
    accounting ``window_bytes`` / ``window_bytes_compact``, equal to the
    reference plan's fields; a concrete query set's measured per-tile
    window (:meth:`MSDAPlan.with_measured_tile_window`);
  * **table dtype** — arg > ``cfg.table_dtype`` > ``REPRO_MSDA_TABLE_DTYPE``
    > ``cfg.dtype``;
  * **lane layout** — kept from the reference because the decode staging
    layout (``head_pack`` heads side by side per row) and every bytes
    figure are defined by it;
  * **query order** — ``"none"``, ``"raster"`` or ``"zorder"``
    (:func:`repro_torch.msda.ordering.resolve_query_order`);
  * **streaming budget** — ``stream_update_rows``, the rows an
    incremental frame re-projects (``repro_torch/stream/``).

Each plan is for one device's platform (``device=None``: the card when
one is present, else the CPU): its budgets, the measured entry it reads
and the ``auto`` policy's last resort are that platform's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.bridge import resolve_device
from repro_torch.core import fwp as fwp_lib
from repro_torch.kernels.library import stood_in_card
from repro_torch.msda.ordering import resolve_query_order

#: The static default of both budgets when the plan is for the CPU: the
#: L2 capacity of the card the port targets, the H100 SXM5's 50 MiB, so a
#: CPU plan picks what that card's would. A plan for a card reads the
#: card's own ``torch.cuda.get_device_properties(i).L2_cache_size``
#: instead. The reference's figures are TPU VMEM slabs (8 MiB
#: whole-table, 4 MiB staging); the H100 has no staging slab, and the
#: tier a gathered table must stay in to be read at more than HBM rate is
#: the L2.
DEFAULT_VMEM_BUDGET = 50 * 2**20

#: Static staging budget of the K3 window gate and the K2 decode gate on
#: the CPU (a card: its L2); an applied autotune entry replaces it with
#: the measured L2 knee, and the ``REPRO_MSDA_VMEM_BUDGET`` env var
#: (bytes) pins it.
DEFAULT_WINDOW_STAGING_BUDGET = DEFAULT_VMEM_BUDGET

_LANE_WIDTH = 128
_BLOCK_Q = 128                   # the reference's default query tile

#: Table storage dtypes the cache/kernels understand (canonical names).
_TABLE_DTYPES = ("int8", "float32", "bfloat16", "float16")
_ITEMSIZE = {"int8": 1, "float32": 4, "bfloat16": 2, "float16": 2}
_TORCH_DTYPE_NAMES = {torch.int8: "int8", torch.float32: "float32",
                      torch.bfloat16: "bfloat16", torch.float16: "float16"}

# --------------------------------------------------------------------------
# Platforms: what a plan is for
# --------------------------------------------------------------------------
# Budgets are per card, and one process may plan for the CPU and for a
# card, so every budget and measured entry is looked up by the platform
# of the device a plan is for. ``device=None`` means the card when one is
# present, else the CPU.


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[str, int]:
    props = torch.cuda.get_device_properties(index)
    return "cuda:" + props.name, int(props.L2_cache_size)


def platform_of(device=None) -> Tuple[str, Optional[int]]:
    """(platform key, L2 bytes) of the device a plan is for: ``("cpu",
    None)``, or ``("cuda:" + the card's name, its L2_cache_size)``. A
    ``"cuda"`` device raises without a GPU; ``None`` is the card when one
    is present, else the CPU. Inside a fake trace that stands for a card
    (``kernels.library.card_stand_in``) the CPU is that card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = resolve_device(device)
    if dev.type == "cpu":
        card = stood_in_card()
        if card is not None:
            return "cuda:" + card.name, card.l2_bytes
        return "cpu", None
    return _card(dev.index if dev.index is not None
                 else torch.cuda.current_device())


def platform_key(device="cuda") -> str:
    """``"cpu"``, or ``"cuda:" + torch.cuda.get_device_name()``: budgets
    are per card. ``"cuda"`` raises without a GPU."""
    return platform_of(device)[0]


def static_budget(device=None) -> int:
    """Both budgets' static default for the device a plan is for: a
    card's L2 capacity, :data:`DEFAULT_VMEM_BUDGET` for the CPU."""
    l2 = platform_of(device)[1]
    return l2 if l2 else DEFAULT_VMEM_BUDGET


# --------------------------------------------------------------------------
# Measured plan table (written by repro_torch.msda.autotune, read here)
# --------------------------------------------------------------------------
# plan.py owns the applied calibrations so stream/ and serve/ read them
# through plain accessors without importing autotune (which imports plan).
# One entry per platform: a CPU engine's entry never reaches a plan for a
# card. ``_TUNED_GENERATION`` bumps on every apply or clear, so memo keys
# built on resolved values stay exact even when two tables resolve one
# budget.

_TUNED: Dict[str, dict] = {}
_TUNED_GENERATION = 0


def apply_tuned_plan_table(entry: Optional[dict],
                           platform: Optional[str] = None) -> None:
    """Install one platform's measured entry: ``staging_budget_bytes``,
    the streaming crossover under ``stream`` and the
    ``decode_sweep_beneficial`` verdict. ``platform`` defaults to the
    entry's own ``"platform"``, else to that of ``device=None``. With
    ``entry=None`` it clears ``platform``'s entry, or every platform's
    when none is named. Every plan resolved afterwards for that platform
    sees it; ``plan_for``'s memo is keyed on the platform, the resolved
    budget, its source and the generation, so no stale plan survives."""
    global _TUNED_GENERATION
    if entry is None:
        if platform is None:
            _TUNED.clear()
        else:
            _TUNED.pop(platform, None)
    else:
        platform = platform or entry.get("platform") or platform_key(None)
        _TUNED[platform] = dict(entry)
    _TUNED_GENERATION += 1


def _applied(device) -> Optional[dict]:
    return _TUNED.get(platform_key(device))


def tuned_entry(device=None) -> Optional[dict]:
    """The entry applied for ``device``'s platform (None: static
    formulas)."""
    e = _applied(device)
    return None if e is None else dict(e)


def tuned_entries() -> Dict[str, dict]:
    """Every applied entry, by platform key."""
    return {k: dict(v) for k, v in _TUNED.items()}


def tuned_generation() -> int:
    return _TUNED_GENERATION


def tuned_stream_params(device=None) -> Optional[dict]:
    """The measured streaming crossover ({diff_channel_stride,
    update_frac}) of ``device``'s applied entry, or None; consumed by
    :func:`repro_torch.stream.temporal.resolve_stream_config`."""
    e = _applied(device)
    s = None if e is None else e.get("stream")
    return dict(s) if isinstance(s, dict) else None


def tuned_decode_sweep(device=None) -> Optional[bool]:
    """The measured verdict on whether K2's once-staged sweep beats K1's
    per-layer gather on ``device``'s platform. None: no measurement
    applied (the static assumption, that it does, stands)."""
    e = _applied(device)
    v = None if e is None else e.get("decode_sweep_beneficial")
    return None if v is None else bool(v)


@functools.lru_cache(maxsize=16)
def _parse_budget_env(raw: str) -> int:
    """Parse one observed ``REPRO_MSDA_VMEM_BUDGET`` value (decimal or
    0x hex bytes); cached per distinct string, so a changed env re-parses."""
    try:
        base = 16 if raw.strip().lower().lstrip("+-").startswith("0x") else 10
        value = int(raw, base)
    except ValueError:
        raise ValueError(
            f"REPRO_MSDA_VMEM_BUDGET must be an integer byte count "
            f"(e.g. 4194304), got {raw!r}") from None
    if value <= 0:
        raise ValueError(
            f"REPRO_MSDA_VMEM_BUDGET must be a positive byte count, "
            f"got {value}")
    return value


def _measured_budget(device) -> Optional[int]:
    e = _applied(device)
    b = None if e is None else e.get("staging_budget_bytes")
    return b if isinstance(b, int) and b > 0 else None


def window_staging_budget(device=None) -> int:
    """The staging budget of the K3 window and K2 decode gates for the
    device a plan is for.

    Precedence: the ``REPRO_MSDA_VMEM_BUDGET`` env pin > the measured L2
    knee of the entry applied for the device's platform >
    :func:`static_budget` (the card's L2)."""
    env = os.environ.get("REPRO_MSDA_VMEM_BUDGET")
    if env:
        return _parse_budget_env(env)
    measured = _measured_budget(device)
    return measured if measured is not None else static_budget(device)


def staging_budget_source(device=None) -> str:
    """Provenance of :func:`window_staging_budget`: ``"measured"`` when an
    entry applied for the device's platform supplies it, else
    ``"static"`` (the default, or an env pin: an operator's static
    decision even over a table)."""
    if os.environ.get("REPRO_MSDA_VMEM_BUDGET"):
        return "static"
    return "measured" if _measured_budget(device) is not None else "static"


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


def value_rows(level_shapes: Sequence[Tuple[int, int]]) -> int:
    """Worst-case rows of the table a backend gathers from: block 1 of an
    FWP-compact chain runs unpruned, so the fit is decided against the
    full n_in-row table."""
    _, n_in = fwp_lib.level_starts(level_shapes)
    return n_in


def _table_bytes(n_rows: int, lanes: int, itemsize: int, n_in: int,
                 with_indirection: bool, scale_row: bool = False) -> int:
    """The value-table bytes formula: rows x lanes x itemsize, plus the
    int32 pix2slot indirection when compacted, plus one f32 scale row
    when quantized. One source for ``table_bytes_for_rows``,
    ``cache_table_bytes`` and the ``auto`` decode gate."""
    b = n_rows * lanes * itemsize
    if with_indirection:
        b += n_in * 4
    if scale_row:
        b += lanes * 4
    return b


@dataclasses.dataclass(frozen=True)
class MSDAPlan:
    """Static per-(config, level_shapes) execution plan. Hashable."""
    cfg: object                                     # MSDeformAttnConfig
    level_shapes: Tuple[Tuple[int, int], ...]
    backend: str                 # resolved registry name (never "auto")
    block_q: int                 # the reference's query tile
    lane_layout: str             # "native" | "pad" | "pack"
    head_pack: int               # heads per 128-lane group (1 unless packed)
    vmem_budget_bytes: int       # the whole-table budget K1's gate used
    value_table_bytes: int       # dense n_in-row table per (batch,
    #   head-group) at the table dtype: what the K1 gate holds to the budget
    n_in: int                    # total flat pixels across levels
    block_q_levels: Tuple[int, ...] = ()   # per-level tiles (raster only)
    tile_q: int = _BLOCK_Q       # query tile of the windowed kernel
    #   (= max of the per-level tiles; the decode tile when decode-shaped)
    window_bytes: Optional[int] = None          # the reference's dense
    #   staged-window bytes per grid step (max over tile x level pairs)
    window_bytes_compact: Optional[int] = None  # the same for the
    #   FWP-compact table: slot windows + the pix2slot window slices
    n_queries: Optional[int] = None   # decode-shaped launches: learned
    #   query count (None => raster encoder queries, Nq == n_in)
    n_consumers: int = 1         # attention layers sharing one value cache
    decode_operand_bytes: Optional[int] = None  # one layer's point,
    #   probability and output blocks per (batch, head-group) step: the
    #   part of a decode launch that is per layer
    stream_update_rows: Optional[int] = None   # streaming: the static
    #   per-frame re-projection budget (table rows an incremental frame
    #   refreshes); None => no streaming consumer
    table_dtype: str = "float32"
    query_order: str = "none"
    measured_tilewin: Optional[Tuple[int, int, int, int]] = None
    #   measured per-tile window bytes of a concrete query set
    #   (with_measured_tile_window): unordered max, unordered mean,
    #   ordered max, ordered mean
    staging_budget_bytes: int = DEFAULT_WINDOW_STAGING_BUDGET
    #   the staging budget the windowed and decode gates were held to,
    #   resolved once at make_plan
    budget_source: str = "static"   # "measured" (autotune entry) |
    #   "static" (default or env pin): describe()'s ``budget=`` tag

    @property
    def quantized_table(self) -> bool:
        """True when the table is stored as int8 codes + f32 scale."""
        return self.table_dtype == "int8"

    @property
    def table_itemsize(self) -> int:
        return _ITEMSIZE[self.table_dtype]

    @property
    def fits_vmem(self) -> bool:
        return self.value_table_bytes <= self.vmem_budget_bytes

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
        return _table_bytes(n_rows, lanes, self.table_itemsize, self.n_in,
                            with_indirection, scale_row=self.quantized_table)

    @property
    def cache_table_bytes(self) -> int:
        """Static estimate of the built table, assuming FWP compaction."""
        if self.cfg.fwp_mode == "compact":
            caps = fwp_lib.level_capacities(self.level_shapes,
                                            self.cfg.fwp_capacity)
            return self.table_bytes_for_rows(sum(caps) + 1,
                                             with_indirection=True)
        return self.table_bytes_for_rows(self.n_in, with_indirection=False)

    def with_measured_tile_window(self, ref_points) -> "MSDAPlan":
        """The plan carrying the measured per-tile window bytes of a
        concrete query set (``measured_tilewin``): the reference's span
        formula over ``tile_q`` consecutive queries, once in arrival order
        and once under this plan's order (``raster`` when the plan's is
        ``none``), dense windows. Host-side numpy; without
        ``cfg.range_narrow`` there is no finite window and the plan is
        returned unchanged."""
        if self.cfg.range_narrow is None:
            return self
        from repro_torch.msda import ordering
        lanes = self.cfg.head_dim if self.lane_layout == "native" \
            else _LANE_WIDTH
        order = self.query_order if self.query_order != "none" else "raster"
        kw = dict(level_shapes=self.level_shapes,
                  ranges=tuple(float(r) for r in self.cfg.range_narrow),
                  tile_q=self.tile_q, lanes=lanes,
                  itemsize=self.table_itemsize)
        un = ordering.tile_window_stats(ref_points, order="none", **kw)
        od = ordering.tile_window_stats(ref_points, order=order, **kw)
        return dataclasses.replace(
            self, measured_tilewin=(un["max_bytes"], int(un["mean_bytes"]),
                                    od["max_bytes"], int(od["mean_bytes"])))

    def snapshot(self) -> dict:
        """Structured twin of :meth:`describe` under the reference's keys
        (repro/msda/plan.py:402-456). ``decode`` is None unless the plan is
        decode-shaped; ``stream`` is None unless it carries a streaming
        budget."""
        snap = {
            "backend": self.backend,
            "block_q": self.block_q,
            "block_q_levels": list(self.block_q_levels),
            "tile_q": self.tile_q,
            "lane_layout": self.lane_layout,
            "head_pack": self.head_pack,
            "table_dtype": self.table_dtype,
            "quantized_table": self.quantized_table,
            "value_table_bytes": self.value_table_bytes,
            "vmem_budget_bytes": self.vmem_budget_bytes,
            "fits_vmem": self.fits_vmem,
            "staging_budget_bytes": self.staging_budget_bytes,
            "budget_source": self.budget_source,
            "window_bytes": self.window_bytes,
            "window_bytes_compact": self.window_bytes_compact,
            "query_order": self.query_order,
            "measured_tilewin": (list(self.measured_tilewin)
                                 if self.measured_tilewin is not None
                                 else None),
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
                "decode_operand_bytes": self.decode_operand_bytes,
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
        """One-line summary: a formatter over :meth:`snapshot`, in the
        reference's format (``budget=measured|static(KB)``)."""
        s = self.snapshot()
        win = ""
        if s["window_bytes"] is not None:
            win = f", win={s['window_bytes'] / 1024:.0f}KB"
            if s["window_bytes_compact"] is not None:
                win += f"(compact {s['window_bytes_compact'] / 1024:.0f}KB)"
        if s["query_order"] != "none":
            win += f", order={s['query_order']}"
        if s["measured_tilewin"] is not None:
            umax, umean, omax, omean = s["measured_tilewin"]
            win += (f", tilewin={umax / 1024:.0f}->{omax / 1024:.0f}KB max / "
                    f"{umean / 1024:.0f}->{omean / 1024:.0f}KB mean "
                    f"({umean / max(omean, 1):.1f}x)")
        q = ""
        if s["decode"] is not None:
            d = s["decode"]
            cb = d["cache_table_bytes"]
            q = (f", q=decode({d['n_queries']}), "
                 f"cache={cb / 1024:.0f}KB build-once")
            if d["n_consumers"] > 1:
                q += (f" (vs {d['n_consumers']}-layer rebuild "
                      f"{d['rebuild_bytes'] / 1024:.0f}KB, "
                      f"{float(d['n_consumers']):.1f}x)")
            if s["backend"] == "cuda_decode" \
                    and d["decode_operand_bytes"] is not None:
                ob = d["decode_operand_bytes"]
                q += (f", staged=1x{cb / 1024:.0f}KB table + "
                      f"{d['n_consumers']}x{ob / 1024:.0f}KB operands "
                      f"(vs {d['n_consumers']}x table restage "
                      f"{d['rebuild_bytes'] / 1024:.0f}KB)")
        if s["stream"] is not None:
            st = s["stream"]
            q += (f", stream<={st['update_rows']}rows/frame "
                  f"({st['update_bytes'] / 1024:.0f}KB vs "
                  f"{st['rebuild_bytes'] / 1024:.0f}KB rebuild, "
                  f"{st['rebuild_bytes'] / max(st['update_bytes'], 1):.1f}x)")
        return (f"MSDAPlan(backend={s['backend']}, block_q={s['block_q']}, "
                f"block_q_levels={tuple(s['block_q_levels'])}, "
                f"lanes={s['lane_layout']}x{s['head_pack']}, "
                f"tdtype={s['table_dtype']}, "
                f"table={s['value_table_bytes'] / 1024:.0f}KB/"
                f"{s['vmem_budget_bytes'] / 1024:.0f}KB, "
                f"budget={s['budget_source']}"
                f"({s['staging_budget_bytes'] / 1024:.0f}KB){win}{q}, "
                f"n_in={s['n_in']})")


_LEGACY_IMPL = {"jnp": "torch_gather", "pallas": "cuda_fused"}


def make_plan(cfg, level_shapes: Sequence[Tuple[int, int]], *,
              backend: Optional[str] = None,
              block_q: int = _BLOCK_Q,
              vmem_budget_bytes: Optional[int] = None,
              n_queries: Optional[int] = None,
              n_consumers: int = 1,
              stream_update_rows: Optional[int] = None,
              table_dtype: Optional[str] = None,
              query_order: Optional[str] = None,
              measured_window_bytes: Optional[int] = None,
              staging_budget_bytes: Optional[int] = None,
              budget_source: Optional[str] = None,
              device=None) -> MSDAPlan:
    """Resolve the static plan (the reference's ``make_plan``, backends
    mapped as the module docstring says).

    ``auto``, raster: ``cuda_fused`` when the dense table per (batch,
    head-group) fits ``vmem_budget_bytes``; else ``cuda_windowed`` when
    range narrowing bounds the window and the worst-case staged window
    sum, ``max(window_bytes, window_bytes_compact)`` (block 1 of a compact
    chain stages dense windows), fits the staging budget; else the
    last resort. ``measured_window_bytes`` (a measured per-tile
    figure, e.g. ``tile_window_stats``' ``max_bytes`` of an ordered query
    set) replaces the static worst case when it is tighter.

    ``auto``, decode-shaped (``n_queries`` != N_in): ``cuda_decode`` when
    the worst-case staged table (dense, or compact with pix2slot,
    whichever is larger) plus one layer's operand blocks fit both budgets
    and an applied measurement has not found K2's sweep slower
    (``tuned_decode_sweep() is False``); else ``cuda_fused`` when the
    table fits; else the last resort. ``n_queries`` also clamps
    ``block_q`` to ``next_pow2(n_queries)``.

    The last resort is the reference's gather, ``torch_gather``, for a
    plan for the CPU, and K1 (``cuda_fused``) for a plan for a card: K1
    gathers from global memory at any table size, so no table on the card
    is too big for it.

    ``device`` names the device the plan is for (None: the card when one
    is present, else the CPU): its platform's static budgets (the card's
    L2 capacity) and applied entry are read. ``vmem_budget_bytes``
    defaults to the static budget, ``staging_budget_bytes`` /
    ``budget_source`` to the platform's resolution (env pin > applied
    entry > static default), read once here and recorded on the plan;
    ``plan_for`` passes the values it keyed its memo on. ``stream_update_rows``: the streaming
    consumer's per-frame re-projection budget (accounting and the
    ``TemporalCacheManager``'s update cap). ``n_consumers``: layers
    sharing one cache (accounting)."""
    from repro_torch.msda import backends as backend_registry

    level_shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    platform = platform_key(device)
    if vmem_budget_bytes is None:
        vmem_budget_bytes = static_budget(device)
    if staging_budget_bytes is None:
        staging_budget_bytes = window_staging_budget(device)
    if budget_source is None:
        budget_source = staging_budget_source(device)
    _, n_in = fwp_lib.level_starts(level_shapes)
    layout, pack = lane_layout(cfg.n_heads, cfg.head_dim)
    itemsize = cfg.dtype.itemsize
    qorder = resolve_query_order(cfg, query_order)
    tdtype = resolve_table_dtype(cfg, table_dtype)
    t_item = _ITEMSIZE[tdtype]
    quantized = tdtype == "int8"
    lanes = cfg.head_dim if layout == "native" else _LANE_WIDTH
    scale_extra = lanes * 4 if quantized else 0
    table_bytes = value_rows(level_shapes) * lanes * t_item + scale_extra

    decode_shaped = n_queries is not None and n_queries != n_in
    decode_operand_bytes = None
    cache_bytes = None
    if decode_shaped:
        block_q = min(block_q, next_pow2(n_queries))
        block_q_levels = (block_q,)
        tile_q = block_q
        # the decode gate's worst case: a decoder fed no FWP link stages
        # the dense table, one fed a link the compact table + pix2slot
        cache_bytes = _table_bytes(n_in, lanes, t_item, n_in, False,
                                   scale_row=quantized)
        if cfg.fwp_mode == "compact":
            caps = fwp_lib.level_capacities(level_shapes, cfg.fwp_capacity)
            cache_bytes = max(cache_bytes,
                              _table_bytes(sum(caps) + 1, lanes, t_item,
                                           n_in, True, scale_row=quantized))
        g = pack if layout == "pack" else 1
        # x/y/probs + int32 start/wl/hl per point, and the output tile
        decode_operand_bytes = (block_q * g * cfg.n_lp
                                * (3 * itemsize + 3 * 4)
                                + block_q * g * cfg.head_dim * itemsize)
    else:
        block_q_levels = block_q_for_levels(level_shapes, block_q)
        tile_q = max(block_q_levels)

    # the reference's windowed accounting (raster launches only): table
    # itemsize, reference lane layout, one f32 scale row when int8
    window_bytes = window_bytes_compact = None
    if windowed_eligible(cfg) and not decode_shaped:
        from repro_torch.kernels.msgs_windowed import window_geometry
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
        last_resort = "torch_gather" if platform == "cpu" else "cuda_fused"
        if decode_shaped:
            staged_decode = cache_bytes + decode_operand_bytes
            if staged_decode <= min(vmem_budget_bytes,
                                    staging_budget_bytes) \
                    and tuned_decode_sweep(device) is not False:
                requested = "cuda_decode"
            elif table_bytes <= vmem_budget_bytes:
                requested = "cuda_fused"
            else:
                requested = last_resort
        else:
            staged = None if window_bytes is None \
                else max(window_bytes, window_bytes_compact or 0)
            if staged is not None and measured_window_bytes is not None:
                staged = min(staged, int(measured_window_bytes))
            windowed_fits = staged is not None \
                and staged <= staging_budget_bytes
            if table_bytes <= vmem_budget_bytes:
                requested = "cuda_fused"
            elif windowed_eligible(cfg) and windowed_fits:
                requested = "cuda_windowed"
            else:
                requested = last_resort

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
                    block_q=block_q, lane_layout=layout, head_pack=pack,
                    vmem_budget_bytes=vmem_budget_bytes,
                    value_table_bytes=table_bytes, n_in=n_in,
                    block_q_levels=block_q_levels, tile_q=tile_q,
                    window_bytes=window_bytes,
                    window_bytes_compact=window_bytes_compact,
                    n_queries=n_queries, n_consumers=n_consumers,
                    decode_operand_bytes=decode_operand_bytes,
                    stream_update_rows=stream_update_rows,
                    table_dtype=tdtype, query_order=qorder,
                    staging_budget_bytes=staging_budget_bytes,
                    budget_source=budget_source)


def plan_for(cfg, level_shapes: Tuple[Tuple[int, int], ...],
             backend: Optional[str] = None,
             n_queries: Optional[int] = None,
             n_consumers: int = 1, *, device=None) -> MSDAPlan:
    """Memoized make_plan, keyed as the reference keys it: on the resolved
    staging budget, its source, the tuned-table generation, the table
    dtype and the query order, each then passed into make_plan, so a
    changed env var or an applied or cleared table never serves a stale
    plan; and on the platform of ``device``, the device the plan is for
    (None: the card when one is present, else the CPU)."""
    platform = platform_key(device)
    return _plan_for_cached(cfg, tuple(level_shapes), backend, n_queries,
                            n_consumers, window_staging_budget(device),
                            staging_budget_source(device), tuned_generation(),
                            resolve_table_dtype(cfg),
                            resolve_query_order(cfg), platform, device)


@functools.lru_cache(maxsize=256)
def _plan_for_cached(cfg, level_shapes, backend, n_queries, n_consumers,
                     staging_budget: int, budget_source: str,
                     _tuned_gen: int, table_dtype: str,
                     query_order: str, _platform: str, device) -> MSDAPlan:
    return make_plan(cfg, level_shapes, backend=backend, n_queries=n_queries,
                     n_consumers=n_consumers, table_dtype=table_dtype,
                     query_order=query_order,
                     staging_budget_bytes=staging_budget,
                     budget_source=budget_source, device=device)


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
