# Frozen copy of msckf_stereo_c_torch/models/__init__.py at commit 50013dad8c92.
"""Front-end tracker, MSCKF filter and the VIO step that joins them.  The
names exported here are the JAX package's."""
from .state import FilterState, ImuState, CamStates, TrackMap, init_filter_state
from .propagation import ImuBatch, initialize_gravity_bias, process_model_step, propagate, propagate_sequential
from .augmentation import add_feature_observations, augment_state
from .triangulation import triangulate_track, triangulate_tracks, check_motion_tracks
from .update import (
    TrackJacobians,
    apply_correction,
    compress_measurements,
    gating_scores,
    measurement_update,
    track_jacobians,
)
from .pruning import compact_after_removal, find_redundant_cam_slots
from .msckf import (
    FrameFeatures,
    MsckfParams,
    PoseOutput,
    filter_step,
    make_params,
)
from .runner import SequenceResult, apply_gravity_init, pack_imu_batches, run_sequence
