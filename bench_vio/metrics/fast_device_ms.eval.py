"""Device ms per batched frame of the work launched inside the program's
``frontend.fast`` span (the FAST candidates, ``models/frontend.py:
_detect_candidates``): the cells that report ``lane_frames_per_s``."""
from bench_vio.trace.spans import device_ms_under


def read(run):
    return device_ms_under(run.trace, "frontend.fast")
