"""Process start to the first timed frame, in seconds."""


def read(run):
    return run.setup_s
