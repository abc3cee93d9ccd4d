"""Kernel launches per batched frame inside the program's ``vio.step``
spans: the runtime's launch calls and the hand kernels' ``kernel.*``
spans; the cells that report ``frame_ms_p95``."""
from bench_vio.trace.spans import launches_per_frame


def read(run):
    return launches_per_frame(run.trace)
