"""Device ms per batched frame of the work launched inside the program's
``filter.compress`` spans (``models/update.py:compress_measurements``, the
thin QR of each lane's stacked [H | r]): the textbook-update cells."""
from bench_vio.trace.spans import device_ms_under


def read(run):
    return device_ms_under(run.trace, "filter.compress")
