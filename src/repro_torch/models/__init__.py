"""The LM substrate of the port (every family of the reference): config
and primitives (``common``), attention, MLP, MoE and the SSD mixer
(``layers``), the stacked decoder (``decoder``), the encoder-decoder
(``encdec``) and the family API (``registry``)."""
