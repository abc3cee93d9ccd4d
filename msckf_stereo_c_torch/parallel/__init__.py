"""Several sequences, sessions and processes: the batched runner
(``vio_multiseq``), the refinement back end (``ba``, ``posegraph``,
``refine``, ``multisession``) and their ``torch.distributed`` plumbing
(``collectives``)."""
from .ba import BAProblem, ba_gauss_newton, make_distributed_ba, problem_from_vio, shard_ba_problem
from .posegraph import (
    PoseGraph,
    make_distributed_pose_graph,
    odometry_edges,
    optimize_pose_graph,
    shard_pose_graph,
)
