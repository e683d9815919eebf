"""Training loops of the port (the deformable-DETR detector)."""
