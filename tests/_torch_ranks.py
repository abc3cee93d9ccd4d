"""Rank functions that port tests spawn with ``torch.multiprocessing``.
They live apart from the test modules, which import JAX, so a spawned rank
imports the port alone."""
import os

import torch


def multiseq_rank(rank, world, init_method, runs, out_dir):
    """One gloo rank of ``parallel/multiseq.py:run_multi_sequence`` over
    the default group: ``runs`` is {name: (cfg, calib, arrays, dtype,
    method)}; this rank's poses and metrics are saved per name."""
    import torch.distributed as dist

    from msckf_stereo_c_torch.parallel.multiseq import run_multi_sequence

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        got = {}
        for name, (cfg, calib, arrays, dtype, method) in runs.items():
            _, poses, metrics = run_multi_sequence(cfg, calib, *arrays, dtype=dtype, method=method, device="cpu")
            got[name] = dict(p=poses.p, q=poses.q_xyzw, num_tracks=poses.num_tracks, metrics=metrics)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
