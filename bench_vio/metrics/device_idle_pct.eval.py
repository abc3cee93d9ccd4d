"""The share of the traced window in which no kernel, copy or set runs on the
card (the union of the device intervals), in %: the cells that report
``lane_frames_per_s``."""
from bench_vio.metrics import idle_pct


def read(run):
    return idle_pct(run)
