# Frozen copy of msckf_stereo_c_torch/io/__init__.py at commit 50013dad8c92.
from .tum import AteResult, associate, evaluate_ate, horn_align, read_tum, write_tum
