"""Device ms per batched frame inside the filter's range
(``models/msckf.py:batched_filter_step``): the cells that report
``lane_frames_per_s``."""
from bench_vio.metrics import stage_ms


def read(run):
    return stage_ms(run, "filter total")
