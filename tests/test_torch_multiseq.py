"""The filter-only multi-sequence runner (``parallel/multiseq.py``)
against the JAX package's ``run_multi_sequence`` on tests/test_multiseq.py's
three sequences: in one process (all three lanes in one batch) and over two
gloo ranks in two processes (the batch padded to four lanes, two a rank).

Tolerances: in float64 with the Cholesky update (JAX's default method),
tests/test_torch_filter_methods.py's ``run_sequence`` bars: positions
within 1e-6 m, quaternions within 1e-8; in float32 with the Schur update,
tests/test_multiseq.py's own 1e-4 m.  Track counts and the cross-sequence
``total_tracks`` are integers and equal exactly.  JAX pads the batch to its
8-device mesh and its psum counts the padding lanes, so its total is not
compared; the port's is the sum over the three sequences."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_ranks import multiseq_rank
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch.parallel import collectives
from msckf_stereo_c_torch.parallel.multiseq import run_multi_sequence as t_run
from msckf_stereo_c_tpu.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c_tpu.parallel.multiseq import run_multi_sequence as j_run
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_landmarks, project_tracks, synthesize_imu

torch.set_num_threads(1)

KW = dict(max_cam_state_size=6, max_tracks=40, max_imu_per_frame=12)
RUNS = {  # name: (JAX dtype, port dtype, method, position tolerance, quaternion tolerance)
    "f64_cholesky": (jnp.float64, torch.float64, "cholesky", 1e-6, 1e-8),
    "f32_schur": (jnp.float32, torch.float32, "schur", 1e-4, None),
}
WORLD = 2
TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def sequences():
    """tests/test_multiseq.py's three sequences, stacked (B, ...)."""
    traj = make_circle_trajectory(duration=4.0)
    landmarks = make_landmarks(num=250)
    seqs = []
    for seed in range(3):
        imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=seed)
        feats = project_tracks(traj, landmarks, max_features=24, pixel_noise=0.2, seed=seed + 10)
        seqs.append((imu, feats))
    return tuple(np.stack(x) for x in (
        [f.t for _, f in seqs], [f.fid for _, f in seqs], [f.uv for _, f in seqs], [f.valid for _, f in seqs],
        [i.t for i, _ in seqs], [i.gyro for i, _ in seqs], [i.acc for i, _ in seqs],
    ))


@pytest.fixture(scope="module")
def jax_runs(sequences):
    out = {}
    for name, (jdt, _, method, _, _) in RUNS.items():
        _, poses, _ = j_run(FilterConfig(**KW), EUROC_CALIB, *sequences, dtype=jdt, method=method)
        out[name] = poses
    return out


@pytest.fixture(scope="module")
def rank_runs(sequences, tmp_path_factory):
    """Both runs over WORLD gloo ranks in WORLD processes: each rank's
    saved poses and metrics."""
    tmp = tmp_path_factory.mktemp("multiseq_ranks")
    runs = {name: (tconfig.FilterConfig(**KW), tconfig.EUROC_CALIB, sequences, tdt, method)
            for name, (_, tdt, method, _, _) in RUNS.items()}
    ctx = mp.start_processes(multiseq_rank, args=(WORLD, f"file://{tmp / 'rendezvous'}", runs, str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "the gloo ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _check(got_p, got_q, want, lanes, name):
    _, _, _, ptol, qtol = RUNS[name]
    np.testing.assert_allclose(got_p, np.asarray(want.p)[lanes], rtol=0, atol=ptol)
    if qtol is not None:
        np.testing.assert_allclose(got_q, np.asarray(want.q_xyzw)[lanes], rtol=0, atol=qtol)


@pytest.mark.parametrize("name", list(RUNS))
def test_one_process_matches_jax(sequences, jax_runs, name):
    """All three lanes in one batch on the CPU."""
    _, tdt, method, _, _ = RUNS[name]
    states, poses, metrics = t_run(tconfig.FilterConfig(**KW), tconfig.EUROC_CALIB, *sequences, dtype=tdt,
                                   method=method, device="cpu")
    want = jax_runs[name]
    assert poses.p.shape == np.asarray(want.p).shape
    _check(poses.p, poses.q_xyzw, want, slice(0, 3), name)
    np.testing.assert_array_equal(poses.num_tracks, np.asarray(want.num_tracks))
    assert metrics["total_tracks"] == int(np.asarray(want.num_tracks).sum()) > 0
    assert states.P.shape[0] == 3


@pytest.mark.parametrize("name", list(RUNS))
def test_two_gloo_ranks_match_jax(jax_runs, rank_runs, name):
    """Each rank returns its own block of the padded batch (rank 0 lanes
    0-1, rank 1 lane 2; the padding lane is stepped and dropped) and the
    total over the three sequences."""
    want = jax_runs[name]
    total = int(np.asarray(want.num_tracks).sum())
    for rank, got in enumerate(rank_runs):
        lo, hi = collectives.process_lane_range(4, WORLD, rank)
        lanes = slice(lo, min(hi, 3))
        g = got[name]
        assert g["p"].shape[0] == lanes.stop - lanes.start
        _check(g["p"], g["q"], want, lanes, name)
        np.testing.assert_array_equal(g["num_tracks"], np.asarray(want.num_tracks)[lanes])
        assert g["metrics"]["total_tracks"] == total


def test_lane_count_must_divide():
    """The per-process lane range keeps JAX's assert: the lanes divide
    over the ranks (run_multi_sequence pads first)."""
    assert collectives.process_lane_range(6, 3, 1) == (2, 4)
    with pytest.raises(ValueError):
        collectives.process_lane_range(5, 2, 0)
