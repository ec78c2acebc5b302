"""Step builders (port of ``repro.train``; serving steps only so far)."""
