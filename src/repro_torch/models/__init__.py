"""The LM substrate of the port (dense decoder family): config and
primitives (``common``), attention and MLP (``layers``), the stacked
decoder (``decoder``) and the family API (``registry``)."""
