"""repro_torch.msda — the layered MSDeformAttn subsystem of the port.

  * :mod:`~repro_torch.msda.plan` — static :class:`MSDAPlan` (backend,
    table dtype, the reference's lane layout for decode staging);
  * :mod:`~repro_torch.msda.cache` — :class:`MSDAValueCache`, built once
    per memory and sampled by every consumer;
  * :mod:`~repro_torch.msda.backends` — the registry: ``torch_gather``,
    ``cuda_fused`` (kernel K1), ``cuda_windowed`` (kernel K3) and
    ``cuda_decode`` (kernel K2);
  * :mod:`~repro_torch.msda.ordering` — cache-local query ordering
    (``raster`` / ``zorder``), a permutation that leaves outputs bitwise
    unchanged;
  * :mod:`~repro_torch.msda.pipeline` / :mod:`~repro_torch.msda.attention`
    / :mod:`~repro_torch.msda.decoder` — planned execution threading an
    explicit :class:`MSDAPipelineState` across blocks and layers.
"""
from repro_torch.msda.attention import msda_attention, msda_attention_cached
from repro_torch.msda.backends import (BackendInfo, available_backends,
                                       backend_info, cuda_windowed,
                                       get_backend, register_backend)
from repro_torch.msda.cache import MSDAValueCache, build_value_cache
from repro_torch.msda.decoder import (MSDADecoderConfig, decoder_apply,
                                      init_decoder)
from repro_torch.msda.ordering import (QUERY_ORDERS, invert_queries,
                                       permute_queries, query_permutation,
                                       query_sort_keys, resolve_query_order,
                                       tile_window_stats)
from repro_torch.msda.pipeline import MSDAPipelineState
from repro_torch.msda.plan import (MSDAPlan, block_q_for_levels,
                                   level_shapes_for_resolution, make_plan,
                                   plan_for, resolve_table_dtype,
                                   tuned_stream_params, windowed_eligible)

__all__ = [
    "BackendInfo", "MSDADecoderConfig", "MSDAPipelineState", "MSDAPlan",
    "MSDAValueCache", "QUERY_ORDERS", "available_backends", "backend_info",
    "block_q_for_levels", "build_value_cache", "cuda_windowed",
    "decoder_apply", "get_backend", "init_decoder", "invert_queries",
    "level_shapes_for_resolution", "make_plan", "msda_attention",
    "msda_attention_cached", "permute_queries", "plan_for",
    "query_permutation", "query_sort_keys", "register_backend",
    "resolve_query_order", "resolve_table_dtype", "tile_window_stats",
    "tuned_stream_params", "windowed_eligible",
]
