"""95th percentile, over every frame of the window, of the time from the
frame handed in to its pose on the host (cells that read the pose every
frame)."""
import numpy as np


def read(run):
    ms = run.window.frame_ms
    return float(np.percentile(ms, 95)) if ms else None
