"""Device ms per batched frame of the work launched inside the program's
``frontend.ransac`` span (``models/frontend.py``: both cameras' two-point
RANSAC, their undistortion, draws and (B, N, 16) scoring): the
msckf_vio-tracker cell."""
from bench_vio.trace.spans import device_ms_under


def read(run):
    return device_ms_under(run.trace, "frontend.ransac")
