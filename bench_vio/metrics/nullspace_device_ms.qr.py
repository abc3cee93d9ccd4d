"""Device ms per batched frame of the work launched inside the program's
``filter.nullspace`` spans (``models/update.py:track_jacobians``: the
per-observation Jacobians and their left-null-space projection, in the
lost-track update and the camera prune): the textbook-update cells."""
from bench_vio.trace.spans import device_ms_under


def read(run):
    return device_ms_under(run.trace, "filter.nullspace")
