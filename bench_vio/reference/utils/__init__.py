# Frozen copy of msckf_stereo_c_torch/utils/__init__.py at commit 50013dad8c92.
"""JPL quaternions, SO(3) helpers and the chi-square table."""
from .lie import (
    rot_from_two_vectors,
    rotation_angle,
    se3_compose,
    se3_inverse,
    skew,
    so3_exp,
    so3_log,
)
from .quaternion import (
    jpl_to_hamilton,
    jpl_to_rot,
    quat_identity,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    rot_to_jpl,
    small_angle_quaternion,
)
from .chi2 import CHI2_P95, chi2_p95_table

__all__ = [
    "skew", "so3_exp", "so3_log", "rotation_angle", "rot_from_two_vectors",
    "se3_inverse", "se3_compose",
    "quat_identity", "quat_normalize", "quat_multiply", "jpl_to_rot",
    "rot_to_jpl", "small_angle_quaternion", "jpl_to_hamilton", "quat_rotate",
    "CHI2_P95", "chi2_p95_table",
]
