"""The back end's ``torch.distributed`` solvers across a process boundary:
two CPU processes joined by the ``gloo`` backend run the sharded BA
(``make_distributed_ba``, ``refine_trajectory(group=...)``) and the sharded
pose graph (``make_distributed_pose_graph``, ``optimize_joint(group=...)``),
and every rank's result is held to the one-process solve, with
tests/test_ba.py's and tests/test_posegraph.py's tolerances for the
sharded forms: costs rtol 1e-6 (atol 1e-20 / 1e-18 on numerical zeros),
poses and landmarks within 1e-9 (BA) and 1e-8 (pose graph).  The problems
are built with the port alone (an odd landmark count and edge count, so
both shards pad); this module imports no JAX, so the workers start
quickly."""
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from msckf_stereo_c_torch.parallel import ba, multisession, posegraph, refine
from msckf_stereo_c_torch.utils.lie import so3_exp
from msckf_stereo_c_torch.utils.quaternion import rot_to_jpl

WORLD = 2
TIMEOUT_S = 120.0


def ba_problem(F=6, L=63, perturb=0.02, seed=17) -> ba.BAProblem:
    """tests/test_ba.py's construction (cameras on an arc over a landmark
    cloud, perturbed poses and landmarks), on the CPU in float64."""
    rng = np.random.default_rng(seed)
    Rs, ps = [], []
    for i in range(F):
        a, c, s = 0.25 * i, np.cos(0.08 * i), np.sin(0.08 * i)
        Rs.append([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        ps.append([2.0 * np.sin(a), 0.05 * i, -2.0 * np.cos(a)])
    R = torch.tensor(Rs, dtype=torch.float64)
    p = torch.tensor(ps, dtype=torch.float64)
    lms = torch.tensor(rng.uniform(-1.0, 1.0, (L, 3)) + np.array([0, 0, 1.5]))
    R01, t01 = torch.eye(3, dtype=torch.float64), torch.tensor([-0.1, 0.0, 0.0], dtype=torch.float64)
    p_c0 = torch.einsum("fij,lfj->lfi", R, lms[:, None] - p[None])
    p_c1 = p_c0 @ R01.T + t01
    mask = (p_c0[..., 2] > 0.3) & (p_c1[..., 2] > 0.3)
    obs = torch.cat([p_c0[..., :2] / p_c0[..., 2:], p_c1[..., :2] / p_c1[..., 2:]], dim=-1) * mask[..., None]
    dth = torch.tensor(rng.normal(0, perturb, (F, 3)))
    dp = torch.tensor(rng.normal(0, perturb, (F, 3)))
    dth[0] = dp[0] = 0
    return ba.BAProblem(rot_to_jpl(so3_exp(dth) @ R), p + dp, lms + torch.tensor(rng.normal(0, perturb, (L, 3))),
                        obs, mask, R01, t01)


def pose_graph(F=17, drift=0.03, seed=23) -> posegraph.PoseGraph:
    """tests/test_posegraph.py's drifted helix with perfect odometry edges,
    a loop closure and mixed weights (17 edges), on the CPU in float64."""
    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(F) / F
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros(F), np.ones(F)
    R = torch.tensor(np.stack([c, s, z, -s, c, z, z, z, o], 1).reshape(F, 3, 3))
    p = torch.tensor(np.stack([2 * c, 2 * s, 0.1 * np.arange(F)], 1))
    q = rot_to_jpl(R)
    ei, ej, Rm, tm, w = posegraph.odometry_edges(q.numpy(), p.numpy())
    ei, ej = np.append(ei, F - 1), np.append(ej, 0)
    Rm = np.concatenate([Rm, (R[F - 1] @ R[0].T).numpy()[None]])
    tm = np.concatenate([tm, (R[F - 1] @ (p[0] - p[F - 1])).numpy()[None]])
    w = np.where(np.arange(F) % 3 == 0, 1e4, 2.5)
    scale = torch.tensor(np.arange(F) / F)[:, None]
    dth = torch.tensor(rng.normal(0, drift, (F, 3))) * scale
    q_d = rot_to_jpl(so3_exp(dth) @ R)
    p_d = p + torch.tensor(rng.normal(0, drift, (F, 3))) * scale
    return posegraph.PoseGraph(q_d, p_d, torch.tensor(ei, dtype=torch.int64), torch.tensor(ej, dtype=torch.int64),
                               torch.tensor(Rm), torch.tensor(tm), torch.tensor(w))


def _rank(rank, world, init_method, prob, graph, out_dir):
    """One rank: the sharded solvers over the default group, saved for the
    parent to compare."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    try:
        blk, costs = ba.make_distributed_ba(iters=10)(ba.shard_ba_problem(prob, world, rank))
        full, full_costs = refine.refine_trajectory(prob, iters=10, group=dist.group.WORLD)
        pg, pg_costs = posegraph.make_distributed_pose_graph(iters=8)(posegraph.shard_pose_graph(graph, world, rank))
        joint, joint_costs = multisession.optimize_joint(graph, group=dist.group.WORLD, iters=8)
        torch.save(dict(ba=blk._asdict(), ba_costs=costs, refine=full._asdict(), refine_costs=full_costs,
                        pg_q=pg.q, pg_p=pg.p, pg_costs=pg_costs, joint_p=joint.p, joint_costs=joint_costs),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_gloo_ranks_equal_the_single_solve(tmp_path):
    prob, graph = ba_problem(), pose_graph()
    init = f"file://{tmp_path / 'rendezvous'}"
    ctx = mp.start_processes(_rank, args=(WORLD, init, prob, graph, str(tmp_path)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "the gloo ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    assert not any(p.is_alive() for p in ctx.processes)

    want, wc = ba.ba_gauss_newton(prob, iters=10)
    pg_want, pgc = posegraph.optimize_pose_graph(graph, iters=8)
    L = prob.landmarks.shape[0]
    for rank in range(WORLD):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        for costs in (got["ba_costs"], got["refine_costs"]):
            np.testing.assert_allclose(costs.numpy(), wc.numpy(), rtol=1e-6, atol=1e-20)
        assert float(wc[-1]) < 1e-12
        for field in ("cam_q", "cam_p"):
            np.testing.assert_allclose(got["ba"][field].numpy(), getattr(want, field).numpy(), rtol=0, atol=1e-9)
        # The rank's landmark block, then the gathered whole.
        s, e, size = 32 * rank, min(32 * (rank + 1), L), 32
        assert got["ba"]["landmarks"].shape[0] == size
        np.testing.assert_allclose(got["ba"]["landmarks"][: e - s].numpy(), want.landmarks[s:e].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["refine"]["landmarks"].numpy(), want.landmarks.numpy(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["refine"]["cam_p"].numpy(), want.cam_p.numpy(), rtol=0, atol=1e-9)
        for costs in (got["pg_costs"], got["joint_costs"]):
            np.testing.assert_allclose(costs.numpy(), pgc.numpy(), rtol=1e-6, atol=1e-18)
        for p in (got["pg_p"], got["joint_p"]):
            np.testing.assert_allclose(p.numpy(), pg_want.p.numpy(), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got["pg_q"].numpy(), pg_want.q.numpy(), rtol=0, atol=1e-8)
    assert float(pgc[-1]) < 1e-3 * float(pgc[0])
