"""Stands in for msckf_stereo_c_torch/ops/_cuda.py in the frozen reference:
the reference runs the plain versions on every device and launches no
hand kernel, so reaching this module is a fault."""


def kernel_function(name: str):
    raise RuntimeError(f"the frozen reference launches no hand kernel (asked for {name})")


def check_launch(name: str, rc: int) -> None:
    raise RuntimeError(f"the frozen reference launches no hand kernel ({name})")


launch_counts: dict = {}
