"""Host-device synchronisations inside the port per batched frame, over the
profiled frames (torch's sync debug mode): the cells that report
``lane_frames_per_s``."""
from bench_vio.metrics import syncs_per_frame


def read(run):
    return syncs_per_frame(run)
