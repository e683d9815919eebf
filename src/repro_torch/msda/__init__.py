"""repro_torch.msda — the layered MSDeformAttn subsystem of the port.

  * :mod:`~repro_torch.msda.plan` — static :class:`MSDAPlan` (backend
    by the reference's ``auto`` policy on H100 budgets, table dtype, the
    reference's lane layout for decode staging);
  * :mod:`~repro_torch.msda.autotune` — the measured plan table
    (``results/autotune_torch.json``): the L2 knee, the decode-sweep
    verdict and the streaming crossover, per card;
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
from repro_torch.msda.autotune import ensure_applied, plan_autotune
from repro_torch.msda.backends import (BackendInfo, available_backends,
                                       backend_info, candidate_backends,
                                       cuda_windowed, get_backend,
                                       register_backend)
from repro_torch.msda.cache import (MSDAValueCache, build_value_cache,
                                    project_values)
from repro_torch.msda.decoder import (MSDADecoderConfig, decoder_apply,
                                      init_decoder)
from repro_torch.msda.ordering import (QUERY_ORDERS, invert_queries,
                                       permute_queries, query_permutation,
                                       query_sort_keys, resolve_query_order,
                                       tile_window_stats)
from repro_torch.msda.pipeline import MSDAPipelineState
from repro_torch.msda.plan import (DEFAULT_VMEM_BUDGET,
                                   DEFAULT_WINDOW_STAGING_BUDGET, MSDAPlan,
                                   apply_tuned_plan_table, block_q_for_levels,
                                   lane_layout, level_shapes_for_resolution,
                                   make_plan, next_pow2, plan_for,
                                   resolve_table_dtype, staging_budget_source,
                                   tuned_decode_sweep, tuned_entry,
                                   tuned_generation, tuned_stream_params,
                                   window_staging_budget, windowed_eligible)
from repro_torch.msda.sampling import (SamplingPoints, corner_data,
                                       flat_gather_heads, generate_points,
                                       level_meta, select_points)

__all__ = [
    "msda_attention", "msda_attention_cached", "project_values",
    "ensure_applied", "plan_autotune",
    "BackendInfo", "available_backends", "backend_info",
    "candidate_backends", "cuda_windowed", "get_backend", "register_backend",
    "MSDAValueCache", "build_value_cache",
    "MSDADecoderConfig", "decoder_apply", "init_decoder",
    "MSDAPipelineState",
    "QUERY_ORDERS", "invert_queries", "permute_queries",
    "query_permutation", "query_sort_keys", "resolve_query_order",
    "tile_window_stats",
    "DEFAULT_VMEM_BUDGET", "DEFAULT_WINDOW_STAGING_BUDGET", "MSDAPlan",
    "apply_tuned_plan_table", "block_q_for_levels", "lane_layout",
    "level_shapes_for_resolution", "make_plan", "next_pow2", "plan_for",
    "resolve_table_dtype", "staging_budget_source", "tuned_decode_sweep",
    "tuned_entry", "tuned_generation", "tuned_stream_params",
    "window_staging_budget", "windowed_eligible",
    "SamplingPoints", "corner_data", "flat_gather_heads",
    "generate_points", "level_meta", "select_points",
]
