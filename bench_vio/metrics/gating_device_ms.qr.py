"""Device ms per batched frame of the work launched inside the program's
``filter.gating`` spans (``models/update.py:gating_scores``, the dense
per-track H P H^T + s2 I Cholesky, and the chi-square mask): the
textbook-update cells."""
from bench_vio.trace.spans import device_ms_under


def read(run):
    return device_ms_under(run.trace, "filter.gating")
