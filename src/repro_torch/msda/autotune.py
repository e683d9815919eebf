"""plan_autotune — the measured plan table behind ``backend="auto"``
(port of repro/msda/autotune.py).

Three planner inputs are guesses until measured on the device that runs
them: the staging budget of the windowed and decode gates, whether K2's
once-staged decode sweep beats K1's per-layer gather, and the streaming
diff-vs-reprojection crossover behind ``StreamConfig.diff_channel_stride``
/ ``update_frac``. :func:`plan_autotune` times all three:

  (a) **staging budget** — the L2 knee. K1 (``cuda_fused``) gathers a
      fixed set of random bilinear samples from one-level value tables
      of increasing size; the cost per gathered byte is flat while the
      table stays resident in L2 and rises once it spills to HBM. On the
      card the probed sizes straddle its L2 (``L2_cache_size`` x 1/8 ...
      4); the budget is the largest probed size within ``KNEE_TOL`` of
      the best cost, clamped to ``BUDGET_CLAMP``. On the CPU the probe
      runs K1's plain version over the reference's 1-32 MiB. The probed
      size is a whole table (all heads of one image, one level), while
      the planner's gates hold the reference's bytes per (batch,
      head-group) to the budget: the two agree only for one image and one
      head group, so the budget is a heuristic there, not a promise that
      a plan's tables stay in L2.
  (b) **decode sweep** — an N-layer decode-shaped stack sampling one
      built cache through ``cuda_decode`` (K2, the table staged once)
      against ``cuda_fused`` (K1 per layer); the verdict
      (``decode_sweep_beneficial``) vetoes ``auto``'s decode gate only on
      a decisive loss (``DECODE_VETO_TOL``). On the card at the served
      512 px decoder's shape (d_model 256, 8 heads, 300 queries, 6
      layers, B 2); on the CPU at the reference's ``CALIB_LEVELS`` shape.
  (c) **streaming crossover** — the tile diff per channel stride and the
      budgeted re-projection per update fraction against the full
      rebuild; the reference's rule picks (stride, frac). On the card at
      the 512 px stream shape, on the CPU at ``STREAM_CALIB_LEVELS``.

The selection rules (:func:`knee_budget`, :func:`decode_verdict`,
:func:`stream_crossover`) are pure functions of the timings; their
thresholds (``KNEE_TOL``, ``DECODE_VETO_TOL``, ``DIFF_FRAC``,
``CROSSOVER_FRAC``) are the reference's, not yet checked on a card. On the card
each timed function is captured in one CUDA graph and its replays timed
with CUDA events (the device work, as the served graphs run it); on the
CPU the host clock times it. A warm-up call precedes every timing.

Winners persist in a per-platform JSON table,
``results/autotune_torch.json`` (``REPRO_TORCH_MSDA_AUTOTUNE_TABLE``
overrides the path), keyed by ``"cpu"`` or ``"cuda:" + the card's name``:
budgets are per card, and an entry applies only to plans for its own
platform. The reference's ``results/autotune.json`` is never read or
written. On the card the CLI persists only to a path given with
``--table``: no card entry is committed until a benchmark measures the
picks it moves. A corrupt, partial or wrong-schema table falls back to
the static formulas with a warning. The applied entry lives in
:mod:`repro_torch.msda.plan`; tuning changes which backend and budget
are chosen, never the numbers (``--check``).

CLI::

    PYTHONPATH=src python -m repro_torch.msda.autotune --table T.json
    PYTHONPATH=src python -m repro_torch.msda.autotune --force --table T.json
    PYTHONPATH=src python -m repro_torch.msda.autotune --device cpu \\
        --no-measure --check                                       # CI
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.msda import plan as plan_lib
from repro_torch.msda.plan import platform_key

SCHEMA_VERSION = 1

#: the reference's dry-run pyramid: the CPU calibration shape.
CALIB_LEVELS: Tuple[Tuple[int, int], ...] = ((16, 20), (8, 10), (4, 5),
                                             (2, 3))

#: the served bucket the card calibrates the decode sweep and the
#: streaming crossover at (d_model 256, 8 heads, 300 queries, 6 layers).
CARD_RESOLUTION = 512
CARD_DECODE = {"batch": 2, "n_queries": 300, "n_layers": 6}
CPU_DECODE = {"batch": 1, "n_queries": 64, "n_layers": 3}

#: cost per gathered byte within this factor of the best probed size
#: still counts as resident in the fast tier.
KNEE_TOL = 1.5

#: the card's probed table sizes as fractions of its L2 (``L2_cache_size``)
#: and the clamp of the measured budget, restated for Hopper: 4-256 MiB
#: holds the probed range around a 50 MiB L2.
L2_PROBE_FRACTIONS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0,
                      1.25, 1.5, 2.0, 4.0)
BUDGET_CLAMP = (4 * 2**20, 256 * 2**20)

#: the CPU probe: the reference's sizes and clamp.
CPU_PROBE_MB = (1, 2, 4, 8, 16, 32)
CPU_BUDGET_CLAMP = (1 * 2**20, 64 * 2**20)

#: the staging probe's geometry: the served heads (8 x Dh 32, float32,
#: so one pixel row is 1 KiB), 4 points per (query, head) on one level of
#: 512-pixel rows, and a fixed query count per device.
PROBE_HEADS, PROBE_HEAD_DIM, PROBE_POINTS, PROBE_WIDTH = 8, 32, 4, 512
PROBE_QUERIES = {"cuda": 16384, "cpu": 1024}

#: streaming crossover: the diff may cost at most DIFF_FRAC of a rebuild,
#: an incremental frame (diff + budgeted re-projection) at most
#: CROSSOVER_FRAC of it.
DIFF_FRAC = 0.25
CROSSOVER_FRAC = 0.6

#: the CPU streaming calibration shape (the reference's).
STREAM_CALIB_LEVELS: Tuple[Tuple[int, int], ...] = ((32, 40), (16, 20),
                                                    (8, 10), (4, 5))
STREAM_CALIB_D_MODEL = 256

#: the decode sweep is vetoed only when it is slower than per-layer
#: gathering by more than this factor, not on noise-level parity.
DECODE_VETO_TOL = 0.85


def default_table_path() -> str:
    """``results/autotune_torch.json`` at the repository root, overridable
    with the ``REPRO_TORCH_MSDA_AUTOTUNE_TABLE`` env var."""
    env = os.environ.get("REPRO_TORCH_MSDA_AUTOTUNE_TABLE")
    if env:
        return env
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))
    return os.path.join(root, "results", "autotune_torch.json")


def _default_cfg():
    from repro_torch.core.msdeform_attn import MSDeformAttnConfig
    return MSDeformAttnConfig(d_model=64, n_heads=4,
                              range_narrow=(6.0, 4.0, 3.0, 2.0))


def calibration_shape(device) -> Tuple[object, Tuple[Tuple[int, int], ...],
                                       dict]:
    """(attention config, level shapes, decode shape) the device
    calibrates and checks at: the served 512 px decoder's on the card
    (the deformable-DETR-DEFA geometry, float32, no pruning), the
    reference's toy shape on the CPU."""
    from repro_torch.core.msdeform_attn import MSDeformAttnConfig
    if resolve_device(device).type == "cpu":
        return _default_cfg(), CALIB_LEVELS, dict(CPU_DECODE)
    cfg = MSDeformAttnConfig(d_model=256, n_heads=8,
                             range_narrow=(16.0, 12.0, 8.0, 4.0))
    return (cfg, plan_lib.level_shapes_for_resolution(CARD_RESOLUTION),
            dict(CARD_DECODE))


# --------------------------------------------------------------------------
# Table persistence
# --------------------------------------------------------------------------

def load_table(path: Optional[str] = None) -> Optional[dict]:
    """Read the plan table; a missing file returns None silently, an
    unreadable or mis-shaped one None with a warning (the caller falls
    back to the static formulas)."""
    path = path or default_table_path()
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            table = json.load(f)
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        warnings.warn(f"autotune table {path!r} is unreadable ({e}); "
                      "falling back to static plan formulas",
                      RuntimeWarning, stacklevel=2)
        return None
    if not isinstance(table, dict) \
            or table.get("schema") != SCHEMA_VERSION \
            or not isinstance(table.get("platforms"), dict):
        warnings.warn(
            f"autotune table {path!r} has an unexpected shape/schema "
            f"(want schema={SCHEMA_VERSION} with a 'platforms' dict); "
            "falling back to static plan formulas",
            RuntimeWarning, stacklevel=2)
        return None
    return table


def valid_entry(entry) -> bool:
    """Structural check of one platform entry: a partial one fails closed
    to the static formulas."""
    return (isinstance(entry, dict)
            and isinstance(entry.get("staging_budget_bytes"), int)
            and entry["staging_budget_bytes"] > 0
            and isinstance(entry.get("decode_sweep_beneficial"), bool)
            and isinstance(entry.get("stream"), dict)
            and isinstance(entry["stream"].get("diff_channel_stride"), int)
            and entry["stream"]["diff_channel_stride"] >= 1
            and isinstance(entry["stream"].get("update_frac"), (int, float))
            and 0.0 < float(entry["stream"]["update_frac"]) <= 1.0)


def save_entry(entry: dict, path: Optional[str] = None,
               platform: Optional[str] = None) -> str:
    """Merge one platform's entry into the table on disk; other
    platforms' entries survive."""
    path = path or default_table_path()
    platform = platform or platform_key()
    table = load_table(path) or {"schema": SCHEMA_VERSION, "platforms": {}}
    table["platforms"][platform] = entry
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def _prepared(fn: Callable[[], object], device: torch.device
              ) -> Callable[[], object]:
    """``fn`` ready to time. On the card: one warm-up call on a side
    stream (it builds the kernels and fills the host-constant caches),
    then ``fn`` captured in one CUDA graph, whose replay is returned. On
    the CPU: ``fn`` itself."""
    if device.type != "cuda":
        return fn
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _time(run: Callable[[], object], device: torch.device,
          iters: int = 5) -> float:
    """Median seconds per call after one warm-up call: CUDA events around
    each call on the card, the host clock on the CPU."""
    run()
    ts = []
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(max(1, iters)):
            start.record()
            run()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# --------------------------------------------------------------------------
# Selection rules: pure functions of the timings
# --------------------------------------------------------------------------

def knee_budget(cost_per_byte: Dict[int, float],
                clamp: Tuple[int, int]) -> int:
    """The largest probed size (bytes) whose cost per byte is within
    ``KNEE_TOL`` of the best, clamped to ``clamp``."""
    best = min(cost_per_byte.values())
    fitting = [s for s, c in cost_per_byte.items() if c <= KNEE_TOL * best]
    return int(min(max(max(fitting), clamp[0]), clamp[1]))


def decode_verdict(decode_s: float, fused_s: float) -> Tuple[bool, float]:
    """(beneficial, speedup = fused / decode): only a decisive measured
    loss (speedup below ``DECODE_VETO_TOL``) vetoes the sweep."""
    speedup = float(fused_s / max(decode_s, 1e-12))
    return bool(speedup >= DECODE_VETO_TOL), speedup


def stream_crossover(diff_s: Dict[int, float], update_s: Dict[float, float],
                     rebuild_s: float) -> Tuple[int, float]:
    """The smallest stride whose diff stays under ``DIFF_FRAC`` of the
    rebuild (else the largest probed), then the largest update fraction
    whose incremental frame (diff + update) undercuts ``CROSSOVER_FRAC``
    of the rebuild (else the smallest probed)."""
    stride = max(diff_s)
    for s in sorted(diff_s):
        if diff_s[s] <= DIFF_FRAC * rebuild_s:
            stride = s
            break
    frac = min(update_s)
    for f in sorted(update_s, reverse=True):
        if diff_s[stride] + update_s[f] <= CROSSOVER_FRAC * rebuild_s:
            frac = f
            break
    return int(stride), float(frac)


# --------------------------------------------------------------------------
# The three calibrations
# --------------------------------------------------------------------------

def probe_sizes(device) -> Tuple[Tuple[int, ...], Tuple[int, int],
                                 Optional[int]]:
    """(probed table sizes in bytes, budget clamp, L2 bytes or None):
    whole MiB straddling the card's L2, or the reference's CPU sizes."""
    l2 = plan_lib.platform_of(device)[1]
    if l2 is None:
        return (tuple(mb * 2**20 for mb in CPU_PROBE_MB), CPU_BUDGET_CLAMP,
                None)
    lo, hi = BUDGET_CLAMP
    sizes = sorted({min(max(round(f * l2 / 2**20) * 2**20, lo), hi)
                    for f in L2_PROBE_FRACTIONS})
    return tuple(sizes), BUDGET_CLAMP, l2


def _probe_operands(n_bytes: int, nq: int, gen: torch.Generator,
                    device: torch.device):
    """A one-level table of ``n_bytes`` (rows of 512 pixels x 1 KiB) and
    ``nq`` queries' random points over it."""
    h, dh, k, wl = PROBE_HEADS, PROBE_HEAD_DIM, PROBE_POINTS, PROBE_WIDTH
    hl = max(2, n_bytes // (wl * h * dh * 4))
    v = torch.randn((1, hl * wl, h, dh), generator=gen).to(device)
    shape = (1, nq, h, k)
    x = torch.rand(shape, generator=gen) * (wl - 1)
    y = torch.rand(shape, generator=gen) * (hl - 1)
    probs = torch.rand(shape, generator=gen)
    ints = [torch.full(shape, c, dtype=torch.int32) for c in (0, wl, hl)]
    pts = [t.to(device).contiguous() for t in (x, y, *ints, probs)]
    return v, pts, hl * wl * h * dh * 4


def measure_staging_budget(device="cuda", iters: int = 5
                           ) -> Tuple[int, dict]:
    """(a) The staging budget by L2 knee: K1 on a fixed sample set over
    tables of each probed size. Returns (budget_bytes, detail)."""
    from repro_torch.kernels import msgs_fused
    dev = resolve_device(device)
    sizes, clamp, l2 = probe_sizes(dev)
    nq = PROBE_QUERIES[dev.type]
    gathered = nq * PROBE_HEADS * PROBE_POINTS * 4 * PROBE_HEAD_DIM * 4
    gen = torch.Generator().manual_seed(0)
    per_byte, call_s, table_bytes = {}, {}, {}
    with torch.no_grad():
        for size in sizes:
            v, pts, nbytes = _probe_operands(size, nq, gen, dev)
            run = _prepared(lambda: msgs_fused.msgs_fused(v, *pts), dev)
            t = _time(run, dev, iters=iters)
            del run, v, pts
            call_s[size], table_bytes[size] = t, nbytes
            per_byte[size] = t / gathered
    budget = knee_budget(per_byte, clamp)
    mib = lambda s: str(s // 2**20)                       # noqa: E731
    detail = {"probe": "cuda_fused (K1) random bilinear gather",
              "sizes_mb": [s // 2**20 for s in sizes],
              "table_bytes": {mib(s): table_bytes[s] for s in sizes},
              "n_queries": nq, "bytes_gathered": gathered,
              "us_per_call": {mib(s): call_s[s] * 1e6 for s in sizes},
              "ns_per_byte": {mib(s): per_byte[s] * 1e9 for s in sizes},
              "knee_tol": KNEE_TOL, "clamp_bytes": list(clamp),
              "l2_bytes": l2, "budget_bytes": budget}
    return budget, detail


def measure_decode_sweep(cfg=None, level_shapes: Optional[Sequence] = None,
                         device="cuda", *, batch: Optional[int] = None,
                         n_queries: Optional[int] = None,
                         n_layers: Optional[int] = None, iters: int = 3,
                         repeats: int = 3) -> Tuple[bool, float, dict]:
    """(b) Does K2's once-staged sweep beat K1's per-layer gather here?

    Times an ``n_layers`` stack sampling one built cache through
    ``cuda_decode`` and through ``cuda_fused``; each backend's cost is the
    minimum over ``repeats`` interleaved rounds (noise only inflates a
    timing). Returns (beneficial, speedup = fused / decode, detail)."""
    from repro_torch import msda
    from repro_torch.core.msdeform_attn import init_msdeform_attn

    dev = resolve_device(device)
    d_cfg, d_levels, shape = calibration_shape(dev)
    cfg = cfg or d_cfg
    level_shapes = tuple(tuple(s) for s in (level_shapes or d_levels))
    b = batch or shape["batch"]
    nq = n_queries or shape["n_queries"]
    n_layers = n_layers or shape["n_layers"]
    gen = torch.Generator().manual_seed(11)
    params = init_msdeform_attn(cfg, gen, device=dev)
    n_in = sum(h * w for h, w in level_shapes)
    memory = torch.randn((b, n_in, cfg.d_model), generator=gen).to(dev)
    q = torch.randn((b, nq, cfg.d_model), generator=gen).to(dev)
    refs = (0.1 + 0.8 * torch.rand((b, nq, 2), generator=gen)).to(dev)

    names = [n for n in msda.candidate_backends(decode_shaped=True)
             if n in ("cuda_decode", "cuda_fused")]
    if names != ["cuda_decode", "cuda_fused"]:
        raise RuntimeError(f"decode sweep candidates {names}")

    runs = {}
    with torch.no_grad():
        for name in names:
            plan = msda.make_plan(cfg, level_shapes, backend=name,
                                  n_queries=nq, n_consumers=n_layers,
                                  device=dev)

            def stack(plan=plan):
                cache = msda.build_value_cache(params, plan, memory)
                out = q
                for _ in range(n_layers):
                    o, _st = msda.msda_attention_cached(
                        params, plan, out, refs, cache, update_fwp=False)
                    out = out + o
                return out

            runs[name] = _prepared(stack, dev)
        times = {name: float("inf") for name in names}
        for _ in range(max(1, repeats)):
            for name in names:
                times[name] = min(times[name],
                                  _time(runs[name], dev, iters=iters))
    beneficial, speedup = decode_verdict(times["cuda_decode"],
                                         times["cuda_fused"])
    detail = {"n_layers": n_layers, "n_queries": nq, "batch": b,
              "d_model": cfg.d_model, "n_heads": cfg.n_heads,
              "level_shapes": [list(s) for s in level_shapes],
              "decode_s": times["cuda_decode"],
              "fused_s": times["cuda_fused"], "speedup": speedup,
              "repeats": max(1, repeats), "veto_tol": DECODE_VETO_TOL}
    return beneficial, speedup, detail


def measure_stream_crossover(device="cuda", *,
                             d_model: int = STREAM_CALIB_D_MODEL,
                             level_shapes: Optional[Sequence] = None,
                             batch: Optional[int] = None,
                             strides: Sequence[int] = (1, 2, 4),
                             fracs: Sequence[float] = (0.5, 0.25, 0.125),
                             tile_rows: int = 2, iters: int = 5
                             ) -> Tuple[int, float, dict]:
    """(c) The streaming crossover: the tile diff per probed channel
    stride, the (B, U, D) re-projection per update fraction and the full
    rebuild projection, at the 512 px stream shape on the card (B 2, the
    served sessions) and ``STREAM_CALIB_LEVELS`` on the CPU. Returns
    (stride, frac, detail)."""
    from repro_torch.stream.tiles import changed_tiles, tile_geometry

    dev = resolve_device(device)
    if level_shapes is None:
        level_shapes = STREAM_CALIB_LEVELS if dev.type == "cpu" else \
            plan_lib.level_shapes_for_resolution(CARD_RESOLUTION)
    level_shapes = tuple(tuple(s) for s in level_shapes)
    b = batch or (1 if dev.type == "cpu" else CARD_DECODE["batch"])
    n_in = sum(h * w for h, w in level_shapes)
    geo = tile_geometry(level_shapes, tile_rows)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, n_in, d_model), generator=gen)
    ref = (x + 1e-3 * torch.randn((b, n_in, d_model), generator=gen)).to(dev)
    x = x.to(dev)
    w = (torch.randn((d_model, d_model), generator=gen)
         / d_model ** 0.5).to(dev)

    def timed(fn):
        return _time(_prepared(fn, dev), dev, iters=iters)

    with torch.no_grad():
        diff_t = {int(s): timed(lambda s=int(s): changed_tiles(
            geo, x[..., ::s], ref[..., ::s], 1e-5)) for s in strides}
        rebuild_t = timed(lambda: x @ w)
        update_t = {}
        for f in fracs:
            u = max(1, int(round(float(f) * n_in)))
            update_t[float(f)] = timed(lambda u=u: x[:, :u] @ w)
    stride, frac = stream_crossover(diff_t, update_t, rebuild_t)
    detail = {"level_shapes": [list(s) for s in level_shapes],
              "d_model": d_model, "batch": b, "tile_rows": tile_rows,
              "diff_s": {str(k): v for k, v in diff_t.items()},
              "update_s": {str(k): v for k, v in update_t.items()},
              "rebuild_s": rebuild_t, "diff_frac": DIFF_FRAC,
              "crossover_frac": CROSSOVER_FRAC,
              "diff_channel_stride": stride, "update_frac": frac}
    return stride, frac, detail


# --------------------------------------------------------------------------
# The autotune pass
# --------------------------------------------------------------------------

def plan_autotune(cfg=None, level_shapes: Optional[Sequence] = None, *,
                  device="cuda", measure: Optional[bool] = None,
                  force: bool = False, cache_path: Optional[str] = None,
                  persist: bool = True, iters: int = 5,
                  warn_missing: bool = True) -> Optional[dict]:
    """Resolve (load or measure) ``device``'s entry and apply it.

    ``measure``: None measures only when no usable entry exists; False
    never measures (the static formulas stand, with a warning unless
    ``warn_missing`` is off); True with ``force`` re-measures over an
    existing entry. A measurement asked for runs on ``device`` and raises
    if a probe fails to build or launch. The entry applies to plans for
    ``device``'s platform only. Returns the applied entry, or None on the
    static fallback."""
    path = cache_path or default_table_path()
    plat = platform_key(device)
    entry = None
    table = load_table(path)
    if table is not None:
        entry = table.get("platforms", {}).get(plat)
        if entry is not None and not valid_entry(entry):
            warnings.warn(
                f"autotune entry for platform {plat!r} in {path!r} is "
                "partial/invalid; falling back to "
                + ("re-measurement" if measure is not False
                   else "static plan formulas"),
                RuntimeWarning, stacklevel=2)
            entry = None

    if entry is not None and not force:
        plan_lib.apply_tuned_plan_table(entry, plat)
        return entry

    if measure is False:
        if warn_missing:
            warnings.warn(
                f"no usable autotune entry for platform {plat!r} "
                f"({path}) and measurement is disabled; static plan "
                "formulas stay in effect", RuntimeWarning, stacklevel=2)
        plan_lib.apply_tuned_plan_table(None, plat)
        return None

    dev = resolve_device(device)
    budget, budget_detail = measure_staging_budget(dev, iters=iters)
    beneficial, speedup, decode_detail = measure_decode_sweep(
        cfg, level_shapes, dev, iters=max(2, iters - 2))
    stride, frac, stream_detail = measure_stream_crossover(dev, iters=iters)
    entry = {
        "provenance": "measured",
        "platform": plat,
        "staging_budget_bytes": int(budget),
        "decode_sweep_beneficial": bool(beneficial),
        "decode_persistent_speedup": float(speedup),
        "stream": {"diff_channel_stride": int(stride),
                   "update_frac": float(frac)},
        "calibration": {"staging_budget": budget_detail,
                        "decode_sweep": decode_detail,
                        "stream_crossover": stream_detail},
    }
    if persist:
        try:
            save_entry(entry, path, plat)
        except OSError as e:
            warnings.warn(f"could not persist autotune table to {path!r} "
                          f"({e}); the measured entry applies to this "
                          "process only", RuntimeWarning, stacklevel=2)
    plan_lib.apply_tuned_plan_table(entry, plat)
    return entry


#: platforms whose persisted entry ensure_applied has loaded (or found
#: missing) in this process
_ENSURE_TRIED: set = set()


def ensure_applied(device="cuda", cache_path: Optional[str] = None
                   ) -> Optional[dict]:
    """Load-only start-up hook of the serve engines: apply the persisted
    entry of ``device``'s platform, once per platform and process, when
    none is applied for that platform. Never measures and never raises: a
    missing or broken table leaves the static formulas (``budget_source``
    reads ``static``)."""
    try:
        plat = platform_key(device)
        applied = plan_lib.tuned_entry(device)
        if applied is not None or plat in _ENSURE_TRIED:
            return applied
        _ENSURE_TRIED.add(plat)
        return plan_autotune(device=device, measure=False,
                             cache_path=cache_path, warn_missing=False)
    except Exception:                     # noqa: BLE001 - serving shield
        return None


@contextlib.contextmanager
def plan_table_scope():
    """A block that starts with no entry applied for any platform and no
    table loaded by :func:`ensure_applied`; on exit the entries and the
    load record found before are restored. Engines built inside plan on
    what they load there, and nothing they apply outlives the block."""
    saved, tried = plan_lib.tuned_entries(), set(_ENSURE_TRIED)
    plan_lib.apply_tuned_plan_table(None)
    _ENSURE_TRIED.clear()
    try:
        yield
    finally:
        plan_lib.apply_tuned_plan_table(None)
        for plat, entry in saved.items():
            plan_lib.apply_tuned_plan_table(entry, plat)
        _ENSURE_TRIED.clear()
        _ENSURE_TRIED.update(tried)


# --------------------------------------------------------------------------
# The check (the CI leg: --no-measure --check)
# --------------------------------------------------------------------------

def tuned_vs_static(cfg, level_shapes, device, *, batch: int = 1,
                    n_queries: int = 64, n_layers: int = 6) -> dict:
    """Tuning changes the choice, never the numbers: the encoder's
    (raster ``msda_attention``) and the decoder's (an ``n_layers`` stack
    on one cache) ``auto`` picks under the applied entry, against the
    same backends planned with no entry applied. Returns, per role, the
    backend, both budgets with their sources and whether the outputs are
    bitwise equal."""
    from repro_torch import msda
    from repro_torch.core import nn
    from repro_torch.core.msdeform_attn import init_msdeform_attn

    dev = resolve_device(device)
    plat = platform_key(dev)
    level_shapes = tuple(tuple(s) for s in level_shapes)
    entry = plan_lib.tuned_entry(dev)
    gen = torch.Generator().manual_seed(5)
    params = init_msdeform_attn(cfg, gen, device=dev)
    n_in = sum(h * w for h, w in level_shapes)
    d = cfg.d_model
    q = torch.randn((batch, n_in, d), generator=gen).to(dev)
    x = torch.randn((batch, n_in, d), generator=gen).to(dev)
    qd = torch.randn((batch, n_queries, d), generator=gen).to(dev)
    rd = (0.1 + 0.8 * torch.rand((batch, n_queries, 2), generator=gen)
          ).to(dev)
    refs = nn.reference_points_for_levels(level_shapes, dev)[None].expand(
        batch, n_in, 2)

    def encoder(plan):
        return msda.msda_attention(params, plan, q, refs, x)[0]

    def decoder(plan):
        cache = msda.build_value_cache(params, plan, x)
        out = qd
        for _ in range(n_layers):
            o, _st = msda.msda_attention_cached(params, plan, out, rd, cache,
                                                update_fwp=False)
            out = out + o
        return out

    roles = {"encoder": (encoder, {}),
             "decoder": (decoder, {"n_queries": n_queries,
                                   "n_consumers": n_layers})}
    out = {}
    with torch.no_grad():
        tuned = {r: msda.make_plan(cfg, level_shapes, backend="auto",
                                   device=dev, **kw)
                 for r, (_, kw) in roles.items()}
        got = {r: fn(tuned[r]) for r, (fn, _) in roles.items()}
        try:
            plan_lib.apply_tuned_plan_table(None, plat)
            for r, (fn, kw) in roles.items():
                static = msda.make_plan(cfg, level_shapes,
                                        backend=tuned[r].backend,
                                        device=dev, **kw)
                want = fn(static)
                out[r] = {"backend": tuned[r].backend,
                          "budget": {tuned[r].budget_source:
                                     tuned[r].staging_budget_bytes,
                                     static.budget_source:
                                     static.staging_budget_bytes},
                          "bitwise": bool(torch.equal(got[r], want))}
        finally:
            plan_lib.apply_tuned_plan_table(entry, plat)
    return out


def _check(cfg, level_shapes, device, **shape) -> int:
    """Assert the applied entry reaches the planner (``budget=measured``)
    and that the tuned ``auto`` picks are bitwise the same backends
    planned statically. Returns the CLI exit code."""
    plat = platform_key(device)
    if plan_lib.tuned_entry(device) is None:
        print("[autotune --check] FAIL: no tuned entry applied "
              f"for platform {plat!r}")
        return 2
    plan = plan_lib.plan_for(cfg, tuple(level_shapes), "auto",
                             shape.get("n_queries", 64),
                             shape.get("n_layers", 6), device=device)
    desc = plan.describe()
    if "budget=measured" not in desc:
        print("[autotune --check] FAIL: plan provenance is not measured: "
              + desc)
        return 2
    print(f"[autotune --check] provenance ok: {desc}")
    res = tuned_vs_static(cfg, level_shapes, device, **shape)
    for role, r in res.items():
        if not r["bitwise"]:
            print(f"[autotune --check] FAIL: {role} auto->{r['backend']} "
                  "tuned output differs from the same backend planned "
                  "statically: tuning must change the choice, never the "
                  "numbers")
            return 2
        print(f"[autotune --check] bit-identity ok: {role} auto->"
              f"{r['backend']} tuned == static (budgets {r['budget']})")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device to calibrate and plan for: cuda (the "
                    "default; raises without a GPU) or cpu")
    ap.add_argument("--no-measure", action="store_true",
                    help="never time the device: committed-table or "
                    "static fallback (the CI leg)")
    ap.add_argument("--force", action="store_true",
                    help="re-measure even when a table entry exists")
    ap.add_argument("--table", default=None,
                    help="plan-table path (default "
                    "results/autotune_torch.json); on the card a "
                    "measured entry is persisted only to a path given here")
    ap.add_argument("--check", action="store_true",
                    help="assert budget=measured provenance and "
                    "tuned-vs-static bit-identity; exit non-zero on failure")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, levels, shape = calibration_shape(dev)
    # no card entry goes into the committed table until a benchmark
    # measures the picks it moves
    persist = dev.type == "cpu" or args.table is not None
    entry = plan_autotune(cfg, levels, device=dev,
                          measure=False if args.no_measure else None,
                          force=args.force, cache_path=args.table,
                          persist=persist)
    plat = platform_key(dev)
    if entry is None:
        print(f"[autotune] platform {plat!r}: no entry applied — static "
              "plan formulas in effect")
        return 2 if args.check else 0
    src = "measured" if args.force else \
        ("loaded (no-measure)" if args.no_measure else "loaded")
    if not persist:
        src += "; a measured entry is not persisted without --table"
    print(f"[autotune] platform {plat!r} ({src}): "
          f"staging_budget={entry['staging_budget_bytes']} B, "
          f"decode_sweep_beneficial={entry['decode_sweep_beneficial']} "
          f"(speedup {entry.get('decode_persistent_speedup', 0):.2f}x), "
          f"stream stride={entry['stream']['diff_channel_stride']} "
          f"frac={entry['stream']['update_frac']}")
    if args.check:
        return _check(cfg, levels, dev, **shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
