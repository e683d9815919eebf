"""TemporalCacheManager — frame-to-frame value-cache reuse for streaming
(port of repro/stream/temporal.py).

The value cache is persistent state across the frames of a video:

  * **tile diff** — each frame is diffed against ``x_ref`` (the memory as
    of each tile's last re-projection) per row-aligned tile
    (:mod:`repro_torch.stream.tiles`); only tiles whose max-abs delta
    clears ``delta_threshold`` are re-projected.
  * **static update capacity** — an incremental frame re-projects
    ``update_rows`` table rows (the dirty slots first, then clean
    fillers) and writes them in place into the table and its decode
    staging through the pix2slot geometry. A frame with more dirty slots
    than the budget rebuilds the table. The decision is one host read
    per frame (the dirty count), as the reference's is.
  * **streaming FWP** — the sampled frequencies feed an EMA and the keep
    decision runs with hysteresis, so ``keep_idx`` churn stays bounded.
    A keep transition confined to some levels restages only those
    levels' contiguous slot ranges (mode ``partial``); a full rebuild
    happens only when every level's keep set moved.
  * **frozen quant scale** — row updates fake-quant against the scale
    of the last full build, and an int8 table's rows are quantized
    against its frozen per-channel scale.

The reference's two jitted paths (incremental frame and rebuild) are
eager torch here. The tables (value table, staged table, scales,
geometry, diff reference) are allocated once per manager layout and
every path writes into them in place, so their addresses do not change
from frame to frame. ``msda_traces_total{fn}`` counts the first call of
each path per batch shape: where the reference traces, the port would
capture.

Accounting: every frame records its mode (``rebuild`` | ``partial`` |
``incremental``), the staged bytes it moved and what a full rebuild
would have staged. With ``delta_threshold=0`` and ``update_frac=1`` the
incremental path re-projects every slot and reproduces a rebuild.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import host_constant
from repro_torch.core import fwp as fwp_lib
from repro_torch.core.pap import topk_stable
from repro_torch.msda import plan as plan_lib
from repro_torch.msda.cache import (MSDAValueCache, build_value_cache,
                                    cache_act_scale, update_value_cache_rows)
from repro_torch.msda.pipeline import MSDAPipelineState
from repro_torch.obs import Observability
from repro_torch.stream.tiles import (TileGeometry, changed_tiles,
                                      tile_geometry, tile_index)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static knobs of the temporal-reuse subsystem."""
    tile_rows: int = 2            # rows per diff tile (per level, row-aligned)
    delta_threshold: float = 1e-5  # max-abs feature drift a stale row may carry
    #   (0 => every tile changed every frame: the parity mode)
    update_frac: float = 0.25     # static per-frame re-projection budget as a
    #   fraction of the table's updatable rows (overridden by
    #   plan.stream_update_rows when the plan carries one)
    ema_alpha: float = 0.25       # streaming frequency EMA coefficient
    hyst_enter: float = 1.25      # k_enter = fwp_k * hyst_enter
    hyst_exit: float = 0.75       # k_exit  = fwp_k * hyst_exit
    diff_channel_stride: int = 1  # the diff probes every s-th feature
    #   channel (1 = exact); the re-projection always reads every channel,
    #   so a probed diff can only delay a change confined to unprobed
    #   channels, never corrupt a row it updates


def resolve_stream_config(scfg: Optional[StreamConfig] = None, *,
                          device=None) -> StreamConfig:
    """An explicit config wins; else the defaults, overlaid with the
    measured crossover (``diff_channel_stride``, ``update_frac``) of the
    autotune entry applied for ``device``'s platform
    (:func:`repro_torch.msda.plan.tuned_stream_params`, applied by
    :func:`repro_torch.msda.autotune.ensure_applied` or
    ``plan_autotune``)."""
    if scfg is not None:
        return scfg
    tuned = plan_lib.tuned_stream_params(device)
    if not tuned:
        return StreamConfig()
    return dataclasses.replace(
        StreamConfig(),
        diff_channel_stride=int(tuned["diff_channel_stride"]),
        update_frac=float(tuned["update_frac"]))


def plan_slot_count(plan) -> int:
    """Updatable table rows of a plan's cache: the compact capacity slots
    (the zero sentinel excluded), else every pixel row."""
    cfg = plan.cfg
    if cfg.fwp_mode == "compact":
        return sum(fwp_lib.level_capacities(plan.level_shapes,
                                            cfg.fwp_capacity))
    return plan.n_in


def stream_update_cap(plan, update_frac: float) -> int:
    """The static incremental budget: rows re-projected per frame."""
    n_slots = plan_slot_count(plan)
    return max(1, min(n_slots, int(round(update_frac * n_slots))))


@host_constant
def _slot_ranges(bounds: Tuple[Tuple[int, int], ...], batch: int,
                 device: torch.device) -> torch.Tensor:
    """(batch, U) int64: the concatenated slot ranges ``[lo, hi)``."""
    idx = np.concatenate([np.arange(lo, hi) for lo, hi in bounds])
    return torch.from_numpy(np.broadcast_to(idx, (batch, idx.size)).copy()) \
        .to(device)


@host_constant
def _index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def _layout(cache: MSDAValueCache) -> tuple:
    """(shape, dtype) of every tensor of a cache: equal layouts can take
    each other's values in place."""
    st = cache.staged
    ts = (cache.v, cache.pix2slot, cache.keep_idx, cache.scale,
          None if st is None else st.v, None if st is None else st.scale)
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in ts)


def _fwp_rows(f: fwp_lib.FWPState, sel) -> fwp_lib.FWPState:
    """The rows ``sel`` (an index or slice of the batch axis) of a state."""
    take = lambda t: None if t is None else t[sel]
    return fwp_lib.FWPState(keep_mask=take(f.keep_mask),
                            keep_idx=take(f.keep_idx),
                            pix2slot=take(f.pix2slot), freq=take(f.freq))


def _set_row(t: Optional[torch.Tensor], slot: int, row) -> Optional[torch.Tensor]:
    """A copy of ``t`` with batch row ``slot`` replaced by ``row``."""
    if t is None:
        return None
    out = t.clone()
    out[slot] = row
    return out


class TemporalCacheManager:
    """Persistent, incrementally updated MSDAValueCache for one stream.

    ``batch`` is the number of concurrent sessions sharing the manager
    (the streaming engine maps sessions onto batch slots); every slot has
    its own diff reference, EMA scores and keep geometry rows. The
    manager runs on the device of ``value_params``."""

    def __init__(self, plan, value_params: dict,
                 scfg: Optional[StreamConfig] = None, *, batch: int = 1,
                 obs: Optional[Observability] = None):
        self.device = value_params["value_w"].device
        scfg = resolve_stream_config(scfg, device=self.device)
        if scfg.diff_channel_stride < 1:
            raise ValueError("diff_channel_stride must be >= 1")
        self.params = value_params
        self.scfg = scfg
        self.batch = int(batch)
        # a standalone manager gets its own enabled registry; the
        # streaming engine passes its bundle in, so manager counters and
        # engine spans share one registry and one event log
        self.obs = obs if obs is not None else Observability.default(
            capacity=1024)
        m = self.obs.metrics
        self._m_traces = m.counter(
            "msda_traces_total",
            "first call of each streaming path per batch shape (where the "
            "reference traces): flat after warm-up under session churn")
        self._m_frames = m.counter(
            "stream_frames_total", "frames by update mode")
        self._m_rebuilds = m.counter(
            "stream_rebuilds_total", "full rebuilds by reason")
        self._m_staged = m.counter(
            "staged_bytes_total", "bytes actually staged, by update mode")
        self._m_dirty = m.gauge(
            "stream_dirty_slots", "dirty slot count of the last frame")
        self._m_span = m.histogram(
            "stream_span_seconds", "per-stage frame latency (label span=)")

        # ---- mutable stream state ------------------------------------------
        self.cache: Optional[MSDAValueCache] = None
        self.x_ref: Optional[torch.Tensor] = None   # the probed diff
        #   reference (B, N_in, ceil(D/stride)) of each tile's last
        #   re-projected memory
        self.ema: Optional[torch.Tensor] = None
        self.fwp: Optional[fwp_lib.FWPState] = None
        self.act_scale: Optional[torch.Tensor] = None
        self._cache_fwp: Optional[fwp_lib.FWPState] = None  # geometry the
        #   current cache was built with
        self._cache_plan = None                     # plan of the current
        #   cache: ``step`` detects a mid-stream swap (``mgr.plan = p``)
        self._geometry_stale = True                 # first frame: full build
        self._pending_admit: set = set()            # slots whose own build
        #   runs on the next frame (reset_slot)
        self.frame_index = 0
        self.rebuild_frames = 0
        self.partial_frames = 0
        self.staged_bytes_total = 0
        self.rebuild_bytes_total = 0
        self.last_stats: Optional[dict] = None

        self._reconfigure(plan)

    @contextlib.contextmanager
    def _timed_span(self, name: str, **attrs):
        """Trace span + ``stream_span_seconds{span=name}`` histogram."""
        t0 = time.perf_counter()
        with self.obs.tracer.span(name, **attrs):
            yield
        self._m_span.observe(time.perf_counter() - t0, span=name)

    @property
    def trace_counts(self) -> dict:
        """``msda_traces_total`` by path: moves only on the first call of
        a path at a new batch shape (or after a plan swap)."""
        return {k: int(self._m_traces.value(fn=k))
                for k in ("build", "frame", "restage")}

    def _trace(self, fn: str, *key) -> None:
        if (fn,) + key not in self._seen:
            self._seen.add((fn,) + key)
            self._m_traces.inc(fn=fn)

    def _reconfigure(self, plan) -> None:
        """(Re-)derive every plan-dependent static. Called at construction
        and when ``step`` sees the plan swapped mid-stream; the next frame
        after a swap rebuilds (reason ``plan-change``)."""
        cfg = plan.cfg
        if cfg.fwp_mode not in ("off", "mask", "compact"):
            raise ValueError(f"unknown fwp_mode {cfg.fwp_mode!r}")
        self.plan = plan
        self.geo: TileGeometry = tile_geometry(plan.level_shapes,
                                               self.scfg.tile_rows)
        self._compact = cfg.fwp_mode == "compact"
        self.n_slots = plan_slot_count(plan)
        if self._compact:
            caps = fwp_lib.level_capacities(plan.level_shapes,
                                            cfg.fwp_capacity)
            self._n_rows = self.n_slots + 1            # + zero sentinel
            self._slot_windows = tuple(
                min(int(c), self._n_rows - 1) for c in caps)
            self._slot_offs = tuple(
                int(o) for o in np.concatenate([[0], np.cumsum(caps)]))
        else:
            self._n_rows = plan.n_in
            self._slot_windows: Tuple[int, ...] = ()
            self._slot_offs = ()
        self._full_bytes = plan.table_bytes_for_rows(
            self._n_rows, with_indirection=self._compact)
        self.update_rows = plan.stream_update_rows \
            if plan.stream_update_rows is not None \
            else stream_update_cap(plan, self.scfg.update_frac)
        self.update_rows = max(1, min(self.update_rows, self.n_slots))
        self._incr_bytes = plan.table_bytes_for_rows(
            self.update_rows, with_indirection=False)
        starts, _ = fwp_lib.level_starts(plan.level_shapes)
        self._pix_starts = tuple(int(s) for s in starts)
        self._seen: set = set()

    # ---- device paths -------------------------------------------------------
    def _build(self, x_flat: torch.Tensor,
               fwp: Optional[fwp_lib.FWPState]) -> MSDAValueCache:
        self._trace("build", x_flat.shape[0], fwp is None)
        return build_value_cache(self.params, self.plan, x_flat,
                                 MSDAPipelineState(fwp=fwp))

    def _probe(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scfg.diff_channel_stride
        return x if s == 1 else x[..., ::s]

    def _diff(self, x_new: torch.Tensor, keep_idx: Optional[torch.Tensor]):
        """(changed (B, n_tiles), slot_dirty (B, n_slots), the pair
        [max dirty slots over the batch, tiles changed] as one tensor)."""
        self._trace("frame", x_new.shape[0])
        changed = changed_tiles(self.geo, self._probe(x_new), self.x_ref,
                                self.scfg.delta_threshold)
        t_of_p = tile_index(self.geo, x_new.device)
        if keep_idx is not None:                     # compact: slot -> tile
            slot_tile = t_of_p[keep_idx.long()]
        else:                                        # dense: slot == pixel
            slot_tile = t_of_p.expand(x_new.shape[0], self.n_slots)
        slot_dirty = torch.gather(changed, 1, slot_tile)
        counts = torch.stack([slot_dirty.sum(dim=1).max(), changed.sum()])
        return changed, slot_dirty, counts

    def _update(self, x_new, keep_mask, changed, slot_dirty) -> None:
        """Re-project ``update_rows`` slots per batch row (dirty first,
        then the lowest-numbered clean fillers, as ``lax.top_k`` orders
        ties) into the table and its staging, in place; refresh the diff
        reference of the changed tiles."""
        _, idx_u = topk_stable(slot_dirty.to(torch.float32), self.update_rows)
        idx_u, _ = torch.sort(idx_u, dim=1)
        update_value_cache_rows(self.params, self.plan, self.cache, x_new,
                                idx_u, act_scale=self.act_scale,
                                keep_mask=keep_mask)
        t_of_p = tile_index(self.geo, x_new.device)
        pix_changed = torch.gather(changed, 1,
                                   t_of_p.expand(x_new.shape[0], -1))
        self.x_ref.copy_(torch.where(pix_changed[..., None],
                                     self._probe(x_new), self.x_ref))

    def _persist(self, built: MSDAValueCache) -> None:
        """Take a full build's values into the manager's tables. The
        first build (or one of another layout) becomes the tables: owned
        copies, since a build's geometry is the FWP state's own tensors;
        later builds are copied into them in place."""
        if self.cache is None or _layout(self.cache) != _layout(built):
            own = lambda t: None if t is None else t.clone()
            p2s = own(built.pix2slot)
            staged = built.staged
            if staged is not None:
                staged = dataclasses.replace(staged, v=staged.v.clone(),
                                             remap=p2s, scale=own(staged.scale))
            self.cache = built._replace(v=built.v.clone(), pix2slot=p2s,
                                        keep_idx=own(built.keep_idx),
                                        scale=own(built.scale), staged=staged)
            return
        c = self.cache
        for dst, src in ((c.v, built.v), (c.pix2slot, built.pix2slot),
                         (c.keep_idx, built.keep_idx), (c.scale, built.scale)):
            if dst is not None:
                dst.copy_(src)
        if c.staged is not None:
            c.staged.v.copy_(built.staged.v)
            if c.staged.scale is not None:
                c.staged.scale.copy_(built.staged.scale)

    def _warm_fwp(self, batch: int) -> Optional[fwp_lib.FWPState]:
        """Warm-start keep state for fresh sessions: keep everything the
        capacity admits (k = 0), raster-first."""
        cfg = self.plan.cfg
        if cfg.fwp_mode == "off":
            return None
        ones = torch.ones((batch, self.plan.n_in), dtype=torch.float32,
                          device=self.device)
        return fwp_lib.build_fwp_state(ones, self.plan.level_shapes, k=0.0,
                                       mode=cfg.fwp_mode,
                                       capacity=cfg.fwp_capacity)

    def _full_build(self, x_new: torch.Tensor) -> None:
        cfg = self.plan.cfg
        if cfg.fwp_mode != "off" and self.fwp is None:
            self.fwp = self._warm_fwp(x_new.shape[0])
            self.ema = torch.ones((x_new.shape[0], self.plan.n_in),
                                  dtype=torch.float32, device=self.device)
        self._persist(self._build(x_new, self.fwp))
        self.act_scale = cache_act_scale(self.cache, cfg)
        probe = self._probe(x_new)
        if self.x_ref is None or self.x_ref.shape != probe.shape:
            self.x_ref = probe.clone(memory_format=torch.contiguous_format)
        else:
            self.x_ref.copy_(probe)
        self._cache_fwp = self.fwp
        self._cache_plan = self.plan
        self._geometry_stale = False
        self._pending_admit.clear()    # a full build covers every slot

    def _transition_levels(self) -> Optional[Tuple[int, ...]]:
        """The levels whose keep geometry changed against the cache's, or
        None when a partial restage does not apply (not compact, nothing
        to compare, nothing changed, or every level changed). One host
        read."""
        new, old = self.fwp, self._cache_fwp
        if not self._compact or new is None or old is None \
                or new.keep_idx is None or old.keep_idx is None:
            return None
        moved = []
        for li, (h, w) in enumerate(self.plan.level_shapes):
            s0, s1 = self._slot_offs[li], self._slot_offs[li + 1]
            p0 = self._pix_starts[li]
            moved.append(
                (new.keep_idx[:, s0:s1] != old.keep_idx[:, s0:s1]).any()
                | (new.pix2slot[:, p0:p0 + h * w]
                   != old.pix2slot[:, p0:p0 + h * w]).any())
        changed = [li for li, m in enumerate(torch.stack(moved).tolist()) if m]
        if not changed or len(changed) == len(self.plan.level_shapes):
            return None
        return tuple(changed)

    def _partial_restage(self, x_new: torch.Tensor,
                         levels: Tuple[int, ...]) -> int:
        """Restage only the changed levels' contiguous slot ranges: the
        rows are re-projected from this frame through the NEW keep
        geometry under the frozen scales, the geometry (``keep_idx``,
        ``pix2slot``, which is also the staging's ``remap``) is copied in
        whole, and the diff reference of those levels' pixels is
        refreshed. Returns the staged-bytes delta: the restaged rows plus
        the changed levels' share of the pix2slot indirection."""
        b = x_new.shape[0]
        bounds = tuple((self._slot_offs[l], self._slot_offs[l + 1])
                       for l in levels)
        slot_idx = _slot_ranges(bounds, b, x_new.device)
        self._trace("restage", b)
        update_value_cache_rows(self.params, self.plan,
                                self.cache._replace(keep_idx=self.fwp.keep_idx),
                                x_new, slot_idx, act_scale=self.act_scale)
        self.cache.keep_idx.copy_(self.fwp.keep_idx)
        self.cache.pix2slot.copy_(self.fwp.pix2slot)
        probe = self._probe(x_new)
        pix_restaged = 0
        for l in levels:
            h, w = self.plan.level_shapes[l]
            p0 = self._pix_starts[l]
            self.x_ref[:, p0:p0 + h * w].copy_(probe[:, p0:p0 + h * w])
            pix_restaged += h * w
        self._cache_fwp = self.fwp
        self._geometry_stale = False
        return self.plan.table_bytes_for_rows(
            slot_idx.shape[1], with_indirection=False) + pix_restaged * 4

    # ---- host-side orchestration ------------------------------------------
    @torch.no_grad()
    def permute_slots(self, perm) -> None:
        """Reorder the batch (session) slots of every per-slot array.

        ``perm`` has gather semantics: new slot ``i`` takes the state held
        at slot ``perm[i]``. A pure state permutation: the tables are
        permuted in place, no value changes and no rebuild is triggered;
        stepping afterwards equals stepping the unpermuted manager with
        permuted frame rows."""
        p = [int(i) for i in np.asarray(perm).reshape(-1)]
        if sorted(p) != list(range(self.batch)):
            raise ValueError(
                f"permute_slots needs a permutation of range({self.batch}), "
                f"got {p}")
        pj = _index(tuple(p), self.device)
        take = lambda t: None if t is None else t[pj]
        if self.cache is not None:
            c = self.cache
            tables = [c.v, c.pix2slot, c.keep_idx, c.scale, self.x_ref]
            if c.staged is not None:          # its remap is c.pix2slot
                tables += [c.staged.v, c.staged.scale]
            for t in tables:
                if t is not None:
                    t.copy_(t[pj])
        self.ema = take(self.ema)
        if self.act_scale is not None and self.act_scale.dim() > 0 \
                and self.act_scale.shape[0] == self.batch:
            self.act_scale = take(self.act_scale)
        for name in ("fwp", "_cache_fwp"):
            st = getattr(self, name)
            if st is not None:
                setattr(self, name, _fwp_rows(st, pj))
        if self._pending_admit:
            inv = {old: new for new, old in enumerate(p)}
            self._pending_admit = {inv[s] for s in self._pending_admit}

    @torch.no_grad()
    def step(self, x_new, force_full: bool = False
             ) -> Tuple[MSDAValueCache, dict]:
        """Ingest one frame's memory (B, N_in, D); returns (cache, frame
        stats).

        An incremental frame writes the changed rows into the persistent
        table and its decode staging; a keep transition confined to some
        levels restages those levels (mode ``partial``); a full rebuild
        happens on the first frame, on whole-geometry keep transitions,
        on ``force_full``, after a plan swap, or when the dirty-slot
        count exceeds the static update budget."""
        x_new = torch.as_tensor(x_new, device=self.device)
        if x_new.dim() != 3 or x_new.shape[1] != self.plan.n_in:
            raise ValueError(f"frame memory {tuple(x_new.shape)}; expected "
                             f"(B, {self.plan.n_in}, D)")
        n_dirty = tiles_hit = 0
        plan_change = self.cache is not None \
            and self.plan is not self._cache_plan
        if plan_change:
            # table dtype, act_bits, backend ...: the table's codes live on
            # the old plan's grid, so reconfigure and rebuild
            old = self._cache_plan
            self._reconfigure(self.plan)
            if (self.plan.level_shapes != old.level_shapes
                    or self.plan.cfg.fwp_mode != old.cfg.fwp_mode
                    or self.plan.cfg.fwp_capacity != old.cfg.fwp_capacity):
                # the keep rows were derived under the OLD geometry
                self.fwp = self.ema = None
        keep_transition = self._geometry_stale and self.cache is not None \
            and not plan_change
        restaged_levels: Tuple[int, ...] = ()
        partial_bytes = 0
        if keep_transition and not force_full:
            # each level's slots are one contiguous range of the compact
            # table: a transition that moved only some levels restages
            # those ranges, and the unchanged levels' drift then flows
            # through the ordinary incremental diff below
            partial = self._transition_levels()
            if partial:
                restaged_levels = partial
                with self._timed_span("scatter", kind="partial-restage",
                                      levels=partial):
                    partial_bytes = self._partial_restage(x_new, partial)
        admitted: Tuple[int, ...] = ()
        admit_bytes = 0
        if self._pending_admit and self.cache is not None \
                and not self._geometry_stale and not force_full \
                and not plan_change:
            # per-slot admission: rebuild ONLY the joining slots' rows from
            # their own frames; the rest of the batch proceeds below
            admitted = tuple(sorted(self._pending_admit))
            self._pending_admit.clear()
            with self._timed_span("scatter", kind="admission",
                                  slots=admitted):
                admit_bytes = self._admit_slots(x_new, admitted)
        if self.cache is None or self._geometry_stale or force_full \
                or plan_change:
            mode, reason = "rebuild", (
                "first-frame" if self.cache is None else
                "plan-change" if plan_change else
                "keep-transition" if keep_transition else "forced")
            with self._timed_span("rebuild", reason=reason):
                self._full_build(x_new)
            staged_bytes = self._full_bytes
        else:
            keep_idx = self.cache.keep_idx if self._compact else None
            keep_mask = self.fwp.keep_mask \
                if self.plan.cfg.fwp_mode == "mask" else None
            with self._timed_span("diff"):
                changed, slot_dirty, counts = self._diff(x_new, keep_idx)
                n_dirty, tiles_hit = (int(c) for c in counts.tolist())
            if n_dirty > self.update_rows:
                # dirt exceeds the static budget: rebuild wholesale
                mode, reason = "rebuild", "dirty>budget"
                with self._timed_span("rebuild", reason=reason):
                    self._full_build(x_new)
                staged_bytes = partial_bytes + admit_bytes \
                    + self._full_bytes
            else:
                mode = "partial" if restaged_levels else "incremental"
                reason = "keep-transition" if restaged_levels else ""
                with self._timed_span("scatter", kind="incremental"):
                    self._update(x_new, keep_mask, changed, slot_dirty)
                staged_bytes = partial_bytes + admit_bytes \
                    + self._incr_bytes
        self.frame_index += 1
        self.rebuild_frames += mode == "rebuild"
        self.partial_frames += mode == "partial"
        self.staged_bytes_total += staged_bytes
        self.rebuild_bytes_total += self._full_bytes
        self.last_stats = {
            # scope: the whole BATCH (all sessions advance together)
            "scope": "batch",
            "frame": self.frame_index - 1, "mode": mode, "reason": reason,
            "staged_bytes": staged_bytes,
            "rebuild_bytes": self._full_bytes,
            "n_dirty": n_dirty, "tiles_changed": tiles_hit,
            "keep_transition": bool(keep_transition),
            "restaged_levels": restaged_levels,
            "admitted_slots": admitted,
            "update_rows": self.update_rows,
        }
        self._m_frames.inc(mode=mode)
        self._m_staged.inc(staged_bytes, mode=mode)
        if mode == "rebuild":
            self._m_rebuilds.inc(reason=reason)
        self._m_dirty.set(n_dirty)
        return self.cache, self.last_stats

    @torch.no_grad()
    def observe(self, freq) -> bool:
        """Feed back one frame's sampling frequencies (B, N_in): update
        the EMA and re-derive the keep decision with hysteresis. Returns
        True when the keep GEOMETRY differs from the cache's (the next
        ``step`` then restages or rebuilds). No-op when FWP is off."""
        cfg = self.plan.cfg
        if cfg.fwp_mode == "off":
            return False
        freq = torch.as_tensor(freq, dtype=torch.float32, device=self.device)
        self.ema = freq if self.ema is None \
            else fwp_lib.ema_update(self.ema, freq, self.scfg.ema_alpha)
        k = float(cfg.fwp_k)
        self.fwp = fwp_lib.build_fwp_state_hysteresis(
            self.ema, self.plan.level_shapes,
            k_enter=k * self.scfg.hyst_enter, k_exit=k * self.scfg.hyst_exit,
            mode=cfg.fwp_mode, capacity=cfg.fwp_capacity, prev=self.fwp)
        stale = self._fwp_geometry_differs(self.fwp, self._cache_fwp)
        self._geometry_stale = stale
        return stale

    @staticmethod
    def _fwp_geometry_differs(a: Optional[fwp_lib.FWPState],
                              b: Optional[fwp_lib.FWPState]) -> bool:
        if a is None or b is None:
            return a is not b
        if a.keep_idx is not None:
            return bool(((a.keep_idx != b.keep_idx).any()
                         | (a.pix2slot != b.pix2slot).any()).item())
        return bool((a.keep_mask != b.keep_mask).any().item())

    def _admit_slots(self, x_new: torch.Tensor, slots: Tuple[int, ...]) -> int:
        """Per-slot admission: build each admitted slot's rows from its
        OWN frame (a batch-1 build) and copy them into that slot's rows
        of the tables, the diff reference and the cache-geometry record.
        Every other slot is untouched. Returns the admitted slots' share
        of a full build's staged bytes."""
        probe = self._probe(x_new)
        for slot in slots:
            fwp1 = None if self.fwp is None \
                else _fwp_rows(self.fwp, slice(slot, slot + 1))
            built = self._build(x_new[slot:slot + 1], fwp1)
            c = self.cache
            pairs = [(c.v, built.v), (c.pix2slot, built.pix2slot),
                     (c.keep_idx, built.keep_idx), (c.scale, built.scale)]
            if c.staged is not None:          # its remap is c.pix2slot
                pairs += [(c.staged.v, built.staged.v),
                          (c.staged.scale, built.staged.scale)]
            for dst, src in pairs:
                if dst is not None:
                    dst[slot].copy_(src[0])
            self.x_ref[slot].copy_(probe[slot])
            if self._cache_fwp is not None:
                g, f = self._cache_fwp, self.fwp
                self._cache_fwp = fwp_lib.FWPState(
                    keep_mask=_set_row(g.keep_mask, slot, f.keep_mask[slot]),
                    keep_idx=None if g.keep_idx is None
                    else _set_row(g.keep_idx, slot, f.keep_idx[slot]),
                    pix2slot=None if g.pix2slot is None
                    else _set_row(g.pix2slot, slot, f.pix2slot[slot]),
                    freq=_set_row(g.freq, slot, f.freq[slot]))
        # per (batch, head-group) accounting: k admitted slots cost their
        # k/batch share of a full build
        return (self._full_bytes * len(slots) + self.batch - 1) \
            // self.batch

    @torch.no_grad()
    def reset_slot(self, slot: int) -> None:
        """Reset one batch slot for a newly admitted session: warm-start
        its EMA and keep rows and schedule a per-slot build on the next
        frame. Before the first frame, and under frozen per-tensor
        activation quantization (the admitted build would re-derive the
        shared grid), flag a full rebuild instead."""
        if self.cache is None or self.act_scale is not None:
            self._geometry_stale = True
        else:
            self._pending_admit.add(slot)
        if self.ema is None:
            return
        self.ema = _set_row(self.ema, slot, 1.0)
        warm = self._warm_fwp(1)
        f = self.fwp
        self.fwp = fwp_lib.FWPState(
            keep_mask=_set_row(f.keep_mask, slot, warm.keep_mask[0]),
            keep_idx=None if f.keep_idx is None
            else _set_row(f.keep_idx, slot, warm.keep_idx[0]),
            pix2slot=None if f.pix2slot is None
            else _set_row(f.pix2slot, slot, warm.pix2slot[0]),
            freq=_set_row(f.freq, slot, 1.0))

    def pipeline_state(self) -> MSDAPipelineState:
        """The chain state a consumer threads through its layers: the
        streaming FWP link plus this frame's accounting."""
        return MSDAPipelineState(fwp=self.fwp).with_stream(self.last_stats)

    def report(self) -> dict:
        """Cumulative rebuild-vs-incremental accounting."""
        staged = max(self.staged_bytes_total, 1)
        return {
            "frames": self.frame_index,
            "table_dtype": self.plan.table_dtype,
            "rebuild_frames": self.rebuild_frames,
            "partial_frames": self.partial_frames,
            "incremental_frames": self.frame_index - self.rebuild_frames
            - self.partial_frames,
            "update_rows": self.update_rows,
            "n_slots": self.n_slots,
            "staged_bytes_total": self.staged_bytes_total,
            "rebuild_bytes_total": self.rebuild_bytes_total,
            "bytes_ratio": self.rebuild_bytes_total / staged,
            "full_bytes_per_frame": self._full_bytes,
            "incremental_bytes_per_frame": self._incr_bytes,
        }
