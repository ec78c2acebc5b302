"""Roofline of the port: the dry run's counting pass and its terms over
the H100's peaks (``analysis``), re-derived from saved tallies
(``reanalyze``) and rendered as tables (``report``)."""
