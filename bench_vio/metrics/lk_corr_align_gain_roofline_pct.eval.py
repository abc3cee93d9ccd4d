"""``lk_corr_align_gain``'s least time (``roofline/lk.py``'s count of the
kept launches) over its device time, in %: the cells that report
``lane_frames_per_s``."""
from bench_vio.metrics import roofline_pct


def read(run):
    return roofline_pct(run, "lk_corr_align_gain")
