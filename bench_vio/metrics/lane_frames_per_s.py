"""Lane-frames completed in the window, over the window's seconds."""


def read(run):
    w = run.window
    return w.frames * w.lanes / w.seconds if w.frames else None
