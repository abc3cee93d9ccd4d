"""What the traced run records: the port's stage ranges and hand-kernel
launch log (``stages``, frozen from the port's stage split), its host
synchronisations (``syncs``, frozen from ``chip_smoke.py``) and the
profiler's events as plain records (``events``)."""
