"""The streaming paths' graph set: :class:`repro_torch.utils.graphs.CapturedGraphs`,
which the train steps share (``StreamGraphs`` is its streaming name)."""
from repro_torch.utils.graphs import CapturedGraphs as StreamGraphs  # noqa: F401
