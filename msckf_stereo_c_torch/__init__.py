"""msckf_stereo_c_torch: the stereo MSCKF visual-inertial engine on PyTorch
and CUDA, ported from ``msckf_stereo_c_tpu`` (the JAX reference) slice by
slice.  The LK iteration loop and the window extraction run as CUDA kernels
written for Hopper (``csrc/``); everything else is plain PyTorch.  Entry
points run on the CUDA card unless the caller passes another device.
"""

__version__ = "0.1.0"

from .config import EUROC_CALIB, FilterConfig, FrontendConfig, StereoCalib  # noqa: F401
