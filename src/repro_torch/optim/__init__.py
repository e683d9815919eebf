"""Optimisers of the port (AdamW on parameter trees)."""
