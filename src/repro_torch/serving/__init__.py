"""Paged serving engine, page-pool accounting and engine construction
(port of ``repro.serving``)."""
