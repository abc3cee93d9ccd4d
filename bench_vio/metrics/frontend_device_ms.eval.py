"""Device ms per batched frame inside the tracker's range
(``models/vio.py:_run_frontend``), hand-kernel launches included: the cells
that report ``lane_frames_per_s``."""
from bench_vio.metrics import stage_ms


def read(run):
    return stage_ms(run, "frontend total")
