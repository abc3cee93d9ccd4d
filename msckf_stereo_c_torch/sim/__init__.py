from .trajectory import (
    SimFeatures,
    SimImu,
    SimTrajectory,
    make_circle_trajectory,
    make_fastmotion_trajectory,
    make_landmarks,
    make_room_landmarks,
    make_stress_trajectory,
    make_wall_landmarks,
    project_tracks,
    synthesize_imu,
    transform_trajectory,
)
