"""Cross-layer MSDA pipeline state (port of repro/msda/pipeline.py).

Block k counts how often MSGS touched each fmap pixel and block k+1
prunes its value projection with the result (FWP). The state carries
that chain link, the per-block stats (one aligned entry per executed
block, ``None`` when the block did not collect), the shared value cache
of a build-once-sample-everywhere consumer (the decoder) and, for a
streaming session, the frame's temporal-reuse accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.fwp import FWPState
from repro_torch.msda.cache import MSDAValueCache


@dataclasses.dataclass(frozen=True)
class MSDAPipelineState:
    """State produced by block k, consumed by block k+1."""
    fwp: Optional[FWPState] = None       # mask/keep-list for the NEXT block
    block_index: int = 0                 # how many blocks have executed
    block_stats: Tuple[Optional[dict], ...] = ()
    cache: Optional[MSDAValueCache] = None
    stream: Optional[dict] = None        # the frame's temporal-reuse
    #   accounting (mode, staged/rebuild bytes, dirty counts), attached by
    #   the TemporalCacheManager and carried by advance()

    @classmethod
    def initial(cls) -> "MSDAPipelineState":
        return cls()

    def advance(self, fwp: Optional[FWPState],
                stats: Optional[dict]) -> "MSDAPipelineState":
        """State after one block: new FWP chain link, stats appended."""
        return MSDAPipelineState(
            fwp=fwp, block_index=self.block_index + 1,
            block_stats=self.block_stats + (stats,), cache=self.cache,
            stream=self.stream)

    def with_cache(self, cache: Optional[MSDAValueCache]) -> "MSDAPipelineState":
        return dataclasses.replace(self, cache=cache)

    def with_stream(self, stream: Optional[dict]) -> "MSDAPipelineState":
        """Attach (or clear) the frame's temporal-reuse accounting."""
        return dataclasses.replace(self, stream=stream)

    def collected_stats(self) -> Tuple[dict, ...]:
        """Only the blocks that actually collected (drops the Nones)."""
        return tuple(s for s in self.block_stats if s is not None)
