"""Model layers, paged attention and the decoder stack (port of
``repro.models``)."""
