"""Configuration for the PyTorch port.

The port keeps its own copy of the configuration dataclasses so that it
imports nothing of the JAX package; ``tests/test_torch_vio.py`` holds the
fields and defaults equal to ``msckf_stereo_c_tpu/config.py``, which carries
the measured rationale for every default.  The YAML loaders read the
repository's config files through ``io/yaml_subset.py`` (no PyYAML) and give
field for field what the JAX package's loaders give.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from .io.yaml_subset import read_yaml
from .ops.precision import passes_of, products

Vec3 = Tuple[float, float, float]
Vec4 = Tuple[float, float, float, float]
Mat4 = Tuple[float, ...]  # 16 row-major entries

VALID_MATMUL_PRECISIONS = (
    "default",
    "bfloat16",
    "bfloat16_3x",
    "tensorfloat32",
    "float32",
    "highest",
)


def _check_matmul_precision(value: str) -> None:
    if value not in VALID_MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision={value!r} is not one of {VALID_MATMUL_PRECISIONS}"
        )


@contextlib.contextmanager
def matmul_precision_scope(precision: str):
    """Set torch's TF32 switches for matmuls AND cuDNN convolutions, and the
    bf16 pass count of the port's products, for the scope; the previous
    state comes back on exit.

    The bf16 names keep their TPU meaning: ``'bfloat16'`` is one bf16 pass
    per float32 product, ``'bfloat16_3x'`` three (``ops/precision.py``;
    ``precision.active_passes()`` tells the kernels' wrappers and the
    pyramids), with TF32 off.  On the TPU, ``'tensorfloat32'`` means three
    bf16 passes too; NVIDIA's TF32 keeps a 10-bit mantissa, far coarser.
    And torch runs f32 cuDNN convolutions in TF32 by default.  So
    ``'tensorfloat32'``, ``'float32'`` and ``'highest'`` map to full f32
    here, and only ``'default'`` lets the card use TF32."""
    _check_matmul_precision(precision)
    allow = precision == "default"
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        with products(passes_of(precision)):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Mirror of app_imgproc.yaml (reference image_processor.h:75-88)."""

    grid_row: int = 4
    grid_col: int = 5
    grid_min_feature_num: int = 3
    grid_max_feature_num: int = 4
    pyramid_levels: int = 4
    patch_size: int = 15
    fast_threshold: int = 7  # compensates the presmooth blur
    max_iteration: int = 30
    track_precision: float = 0.01
    ransac_threshold: float = 3.0
    stereo_threshold: float = 5.0
    max_features: int = 96  # static track-pool capacity
    detector_cell: int = 16
    klt_impl: str = "corr"  # the port implements 'corr' only
    distortion_model0: str = "radtan"
    distortion_model1: str = "radtan"
    ransac_enabled: bool = False
    temporal_levels: int = 1
    stereo_levels: int = 1
    tmpl_carry: bool = True
    cand_budget: int = 48
    presmooth: bool = True
    cand_level1: bool = True
    stereo_lr_threshold: float = 1.0
    stereo_lr_survivors: bool = True
    translation_seed: bool = True
    anchor_refine: bool = True
    anchor_radius: float = 2.0
    klt_norm: str = "none"  # every mode; K3 carries offset/gain/mixed/anchor_gain
    matmul_precision: str = "tensorfloat32"

    def __post_init__(self):
        _check_matmul_precision(self.matmul_precision)
        if self.klt_norm not in (
            "none", "zeromean", "offset", "gain", "mixed", "anchor_gain"
        ):
            raise ValueError(
                f"klt_norm={self.klt_norm!r} is not one of "
                "('none', 'zeromean', 'offset', 'gain', 'mixed', 'anchor_gain')"
            )
        if self.klt_norm != "none" and self.klt_impl != "corr":
            raise ValueError(
                f"klt_norm={self.klt_norm!r} requires klt_impl='corr' "
                f"(got {self.klt_impl!r})"
            )

    @property
    def num_grids(self) -> int:
        return self.grid_row * self.grid_col


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Mirror of app_msckfvio.yaml (reference msckf_vio.cpp:58-112)."""

    frame_rate: float = 20.0
    max_cam_state_size: int = 20
    position_std_threshold: float = 8.0
    rotation_threshold: float = 0.2618
    translation_threshold: float = 0.4
    tracking_rate_threshold: float = 0.5
    feature_translation_threshold: float = -1.0
    # Standard deviations; squared into variances on use.
    noise_gyro: float = 0.005
    noise_acc: float = 0.05
    noise_gyro_bias: float = 0.001
    noise_acc_bias: float = 0.01
    noise_feature: float = 0.035
    initial_velocity: Vec3 = (0.0, 0.0, 0.0)
    initial_cov_velocity: float = 0.25
    initial_cov_gyro_bias: float = 0.01
    initial_cov_acc_bias: float = 0.01
    initial_cov_extrinsic_rotation: float = 3.0462e-4
    initial_cov_extrinsic_translation: float = 2.5e-5
    max_tracks: int = 128
    max_imu_per_frame: int = 16
    imu_init_samples: int = 200
    max_update_tracks: int = 32
    # 0 = exact factorizations; >0 = Newton-Schulz solves.
    ns_iters: int = 0
    noise_adaptive: bool = False  # SNR-adaptive observation noise (msckf._snr_weights)
    noise_snr_ref: float = 40.0
    noise_inflation_cap: float = 16.0
    matmul_precision: str = "float32"

    def __post_init__(self):
        _check_matmul_precision(self.matmul_precision)

    @property
    def gyro_noise_var(self) -> float:
        return self.noise_gyro**2

    @property
    def acc_noise_var(self) -> float:
        return self.noise_acc**2

    @property
    def gyro_bias_noise_var(self) -> float:
        return self.noise_gyro_bias**2

    @property
    def acc_bias_noise_var(self) -> float:
        return self.noise_acc_bias**2

    @property
    def observation_noise_var(self) -> float:
        return self.noise_feature**2

    @property
    def state_dim(self) -> int:
        """Error-state dimension: 21 IMU + 6 per cam slot (all preallocated)."""
        return 21 + 6 * self.max_cam_state_size


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """One camera's Kalibr entry (camchain-imucam yaml)."""

    intrinsics: Vec4  # fx, fy, cx, cy
    distortion_model: str  # "radtan" | "equidistant"
    distortion_coeffs: Vec4
    resolution: Tuple[int, int]  # (width, height)
    T_cam_imu: Mat4  # row-major 4x4; transforms IMU-frame points to cam frame

    def K(self) -> np.ndarray:
        fx, fy, cx, cy = self.intrinsics
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)

    def T_cam_imu_mat(self) -> np.ndarray:
        return np.asarray(self.T_cam_imu, dtype=np.float64).reshape(4, 4)


@dataclasses.dataclass(frozen=True)
class StereoCalib:
    """Full Kalibr camchain: two cameras + stereo + body extrinsics."""

    cam0: CameraCalib
    cam1: CameraCalib
    T_cn_cnm1: Mat4  # cam0 -> cam1 transform (points): p_c1 = T * p_c0
    T_imu_body: Mat4

    def T_cam0_cam1_mat(self) -> np.ndarray:
        """p_c1 = R p_c0 + t (reference CAMState::T_cam0_cam1)."""
        return np.asarray(self.T_cn_cnm1, dtype=np.float64).reshape(4, 4)

    def R_imu_cam0(self) -> np.ndarray:
        """Rotation IMU->cam0 of *vectors*: R_i_c = R(T_cam_imu)."""
        return self.cam0.T_cam_imu_mat()[:3, :3]

    def t_cam0_imu(self) -> np.ndarray:
        """cam0 position in IMU frame: t = -R(T_cam_imu)^T t(T_cam_imu)."""
        T = self.cam0.T_cam_imu_mat()
        return -T[:3, :3].T @ T[:3, 3]


# EuRoC defaults (camchain-imucam-euroc.yaml).
_EUROC_CAM0 = CameraCalib(
    intrinsics=(458.654, 457.296, 367.215, 248.375),
    distortion_model="radtan",
    distortion_coeffs=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    resolution=(752, 480),
    T_cam_imu=(
        0.014865542981794, 0.999557249008346, -0.025774436697440, 0.065222909535531,
        -0.999880929698575, 0.014967213324719, 0.003756188357967, -0.020706385492719,
        0.004140296794224, 0.025715529947966, 0.999660727177902, -0.008054602460030,
        0.0, 0.0, 0.0, 1.0,
    ),
)
_EUROC_CAM1 = CameraCalib(
    intrinsics=(457.587, 456.134, 379.999, 255.238),
    distortion_model="radtan",
    distortion_coeffs=(-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05),
    resolution=(752, 480),
    T_cam_imu=(
        0.012555267089103, 0.999598781151433, -0.025389800891747, -0.044901980682509,
        -0.999755099723116, 0.013011905181504, 0.017900583825251, -0.020569771258915,
        0.018223771455443, 0.025158836311552, 0.999517347077547, -0.008638135126028,
        0.0, 0.0, 0.0, 1.0,
    ),
)
_EUROC_T_CN = (
    0.999997256477881, 0.002312067192424, 0.000376008102415, -0.110073808127187,
    -0.002317135723281, 0.999898048506644, 0.014089835846648, 0.000399121547014,
    -0.000343393120525, -0.014090668452714, 0.999900662637729, -0.000853702503357,
    0.0, 0.0, 0.0, 1.0,
)
_IDENTITY4 = (
    1.0, 0.0, 0.0, 0.0,
    0.0, 1.0, 0.0, 0.0,
    0.0, 0.0, 1.0, 0.0,
    0.0, 0.0, 0.0, 1.0,
)

EUROC_CALIB = StereoCalib(
    cam0=_EUROC_CAM0, cam1=_EUROC_CAM1, T_cn_cnm1=_EUROC_T_CN, T_imu_body=_IDENTITY4
)


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for another
    device; without CUDA and without an explicit device they raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _mat4_from_yaml(node) -> Mat4:
    flat = np.asarray(node, dtype=np.float64).reshape(-1)
    if flat.size != 16:
        raise ValueError(f"expected 16-element matrix, got {flat.size}")
    return tuple(float(v) for v in flat)


def load_camchain(path: str) -> StereoCalib:
    """Parse a Kalibr-style camchain YAML (reference config_io.h decoders)."""
    node = read_yaml(path)

    def cam(key: str) -> CameraCalib:
        c = node[key]
        return CameraCalib(
            intrinsics=tuple(float(v) for v in c["intrinsics"]),
            distortion_model=str(c["distortion_model"]),
            distortion_coeffs=tuple(float(v) for v in c["distortion_coeffs"]),
            resolution=tuple(int(v) for v in c["resolution"]),
            T_cam_imu=_mat4_from_yaml(c["T_cam_imu"]),
        )

    return StereoCalib(
        cam0=cam("cam0"),
        cam1=cam("cam1"),
        T_cn_cnm1=_mat4_from_yaml(node["cam1"]["T_cn_cnm1"]),
        T_imu_body=_mat4_from_yaml(node.get("T_imu_body", list(_IDENTITY4))),
    )


def load_frontend_config(path: str) -> FrontendConfig:
    """The front end's YAML (``config/app_imgproc.yaml``) over the defaults.
    Keys it does not name keep their defaults; it reads no
    ``pyramid_levels``, as the JAX loader reads none."""
    node = read_yaml(path)
    base = FrontendConfig()
    # presmooth pairs with the compensated FAST threshold 7; a YAML that pins
    # the reference's raw-pixel threshold (>= 10) without naming presmooth
    # gets the raw-pixel pairing (the JAX loader's rule and warning).
    if "presmooth" not in node and int(node.get("fast_threshold", 0)) >= 10:
        warnings.warn(
            f"{path}: fast_threshold={node['fast_threshold']} without an "
            "explicit 'presmooth' key — defaulting presmooth to false (the "
            "raw-pixel pairing). Set 'presmooth: true' with a lower "
            "threshold (e.g. 7) for the sensor-noise prefilter.",
            stacklevel=2,
        )
        base = dataclasses.replace(base, presmooth=False)
    return dataclasses.replace(
        base,
        matmul_precision=str(node.get("matmul_precision", base.matmul_precision)),
        grid_row=int(node.get("grid_row", base.grid_row)),
        grid_col=int(node.get("grid_col", base.grid_col)),
        grid_min_feature_num=int(node.get("grid_min_feature_num", base.grid_min_feature_num)),
        grid_max_feature_num=int(node.get("grid_max_feature_num", base.grid_max_feature_num)),
        patch_size=int(node.get("patch_size", base.patch_size)),
        fast_threshold=int(node.get("fast_threshold", base.fast_threshold)),
        max_iteration=int(node.get("max_iteration", base.max_iteration)),
        track_precision=float(node.get("track_precision", base.track_precision)),
        ransac_threshold=float(node.get("ransac_threshold", base.ransac_threshold)),
        stereo_threshold=float(node.get("stereo_threshold", base.stereo_threshold)),
        klt_impl=str(node.get("klt_impl", base.klt_impl)),
        klt_norm=str(node.get("klt_norm", base.klt_norm)),
        temporal_levels=int(node.get("temporal_levels", base.temporal_levels)),
        stereo_levels=int(node.get("stereo_levels", base.stereo_levels)),
        tmpl_carry=bool(node.get("tmpl_carry", base.tmpl_carry)),
        cand_budget=int(node.get("cand_budget", base.cand_budget)),
        ransac_enabled=bool(node.get("ransac_enabled", base.ransac_enabled)),
        stereo_lr_threshold=float(node.get("stereo_lr_threshold", base.stereo_lr_threshold)),
        presmooth=bool(node.get("presmooth", base.presmooth)),
        cand_level1=bool(node.get("cand_level1", base.cand_level1)),
        stereo_lr_survivors=bool(node.get("stereo_lr_survivors", base.stereo_lr_survivors)),
        anchor_refine=bool(node.get("anchor_refine", base.anchor_refine)),
        translation_seed=bool(node.get("translation_seed", base.translation_seed)),
    )


def load_filter_config(path: str, base: FilterConfig | None = None) -> FilterConfig:
    """The filter's YAML (``config/app_msckfvio.yaml``) over ``base``
    (the defaults when None)."""
    node = read_yaml(path)
    base = base if base is not None else FilterConfig()
    return dataclasses.replace(
        base,
        frame_rate=float(node.get("frame_rate", base.frame_rate)),
        max_cam_state_size=int(node.get("max_cam_state_size", base.max_cam_state_size)),
        position_std_threshold=float(node.get("position_std_threshold", base.position_std_threshold)),
        rotation_threshold=float(node.get("rotation_threshold", base.rotation_threshold)),
        translation_threshold=float(node.get("translation_threshold", base.translation_threshold)),
        tracking_rate_threshold=float(node.get("tracking_rate_threshold", base.tracking_rate_threshold)),
        feature_translation_threshold=float(
            node.get("feature/config/translation_threshold", base.feature_translation_threshold)
        ),
        noise_gyro=float(node.get("noise/gyro", base.noise_gyro)),
        noise_acc=float(node.get("noise/acc", base.noise_acc)),
        noise_gyro_bias=float(node.get("noise/gyro_bias", base.noise_gyro_bias)),
        noise_acc_bias=float(node.get("noise/acc_bias", base.noise_acc_bias)),
        noise_feature=float(node.get("noise/feature", base.noise_feature)),
        initial_velocity=tuple(float(v) for v in node.get("initial_state/velocity", base.initial_velocity)),
        initial_cov_velocity=float(node.get("initial_covariance/velocity", base.initial_cov_velocity)),
        initial_cov_gyro_bias=float(node.get("initial_covariance/gyro_bias", base.initial_cov_gyro_bias)),
        initial_cov_acc_bias=float(node.get("initial_covariance/acc_bias", base.initial_cov_acc_bias)),
        initial_cov_extrinsic_rotation=float(
            node.get("initial_covariance/extrinsic_rotation_cov", base.initial_cov_extrinsic_rotation)
        ),
        initial_cov_extrinsic_translation=float(
            node.get("initial_covariance/extrinsic_translation_cov", base.initial_cov_extrinsic_translation)
        ),
        ns_iters=int(node.get("ns_iters", base.ns_iters)),
        max_update_tracks=int(node.get("max_update_tracks", base.max_update_tracks)),
        matmul_precision=str(node.get("matmul_precision", base.matmul_precision)),
        noise_adaptive=bool(node.get("noise_adaptive", base.noise_adaptive)),
        noise_snr_ref=float(node.get("noise_snr_ref", base.noise_snr_ref)),
        noise_inflation_cap=float(node.get("noise_inflation_cap", base.noise_inflation_cap)),
    )
