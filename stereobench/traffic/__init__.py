"""Traffic drivers, one a ``kind`` of mix (``traffic/<mix>.json``)."""
