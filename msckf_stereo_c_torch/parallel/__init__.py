"""Several sequences, sessions and processes: the batched runners
(``multiseq`` for the filter, ``vio_multiseq`` for the full pipeline), the
multi-process tier (``multiproc``), the refinement back end (``ba``,
``posegraph``, ``refine``, ``multisession``) and their
``torch.distributed`` plumbing (``collectives``).  The names exported here
are the JAX package's, but ``make_mesh``: a process group takes the mesh's
place."""
from .multiseq import (
    batched_gravity_init,
    batched_init_state,
    make_sharded_runner,
    run_multi_sequence,
)
from .ba import BAProblem, ba_gauss_newton, make_distributed_ba, problem_from_vio, shard_ba_problem
from .posegraph import (
    PoseGraph,
    make_distributed_pose_graph,
    odometry_edges,
    optimize_pose_graph,
    shard_pose_graph,
)
