"""Checkpoint store of the port (``repro_torch.checkpoint.store``)."""
from repro_torch.checkpoint.store import (  # noqa: F401
    save_checkpoint, load_checkpoint, latest_step, restore_into,
    AsyncCheckpointer,
)
