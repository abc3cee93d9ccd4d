"""The window's peak of allocated device memory, less the harness's
resident scenes, IMU and frame clock: the port's own memory, in GiB."""


def read(run):
    w = run.window
    return None if w.peak_bytes is None else (w.peak_bytes - w.resident_bytes) / 2**30
