"""Small tree helpers of the port (``repro_torch.utils.tree``)."""
from repro_torch.utils.tree import (  # noqa: F401
    tree_size,
    tree_bytes,
    tree_map_with_path_str,
    flatten_dict,
    unflatten_dict,
)
