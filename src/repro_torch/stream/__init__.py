"""repro_torch.stream — temporal feature-map reuse for streaming video
(port of repro/stream/).

A :class:`TemporalCacheManager` diffs each frame's multi-scale memory
against its diff reference at row-aligned tile granularity, re-projects
only the changed tiles' slots into the persistent value cache and its
decode staging (written in place), and runs the FWP keep decision as a
streaming EMA with hysteresis. ``serve.engine.StreamingDetrEngine`` maps
concurrent video sessions onto the manager's batch slots.
"""
from repro_torch.stream.synthetic import drifting_scene
from repro_torch.stream.temporal import (StreamConfig, TemporalCacheManager,
                                         plan_slot_count,
                                         resolve_stream_config,
                                         stream_update_cap)
from repro_torch.stream.tiles import TileGeometry, changed_tiles, tile_geometry

__all__ = [
    "StreamConfig", "TemporalCacheManager", "plan_slot_count",
    "resolve_stream_config", "stream_update_cap",
    "TileGeometry", "changed_tiles", "tile_geometry", "drifting_scene",
]
