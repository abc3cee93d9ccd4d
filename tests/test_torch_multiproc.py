"""The multi-process tier of the port (``parallel/multiproc.py``) and its
full-pipeline sharded runner (``parallel/vio_multiseq.py:
make_sharded_vio_runner``), on the CPU over gloo.

- The ``vio`` worker over two ranks in two processes (two lanes each) is
  bit-equal to one-process runs of the same lane blocks: lane math never
  crosses a process, and every process runs one CPU thread.  The blocks
  against the four lanes in one batch (float32 batched products round by
  batch shape) hold tests/test_torch_batch.py's bars: ids and validity
  exact, normalized observations within UV_TOL (5e-2 px over fx), positions
  within 1e-4 m, camera counts equal.
- The port's sharded runner against JAX's on a 2-device CPU mesh
  (conftest's virtual devices, the Pallas LK loop in interpret mode), 2
  lanes x VIO_FRAMES of ``vio_configs()`` on the same numpy frames (JAX's
  ``vio_lane_inputs``), float32 filter, with the same bars; the integer
  ``total_tracks`` equal.
- The ``ba`` worker against the one-process solve within 1e-9 (poses,
  landmarks; costs rtol 1e-6), JAX's bars for its multi-process BA.
- ``launch_workers`` returns every rank's code and output; a failing rank
  fails ``check_workers``; a rank still running at the timeout is killed;
  a worker asked for CUDA on a host without it raises."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.ops.klt_corr as jkc
from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.models.frontend import make_frontend_params as t_fparams
from msckf_stereo_c_torch.models.msckf import make_params as t_mparams
from msckf_stereo_c_torch.parallel import multiproc as tmproc
from msckf_stereo_c_torch.parallel import vio_multiseq as tvm
from msckf_stereo_c_tpu.config import EUROC_CALIB
from msckf_stereo_c_tpu.models.frontend import make_frontend_params as j_fparams
from msckf_stereo_c_tpu.models.msckf import make_params as j_mparams
from msckf_stereo_c_tpu.parallel import multiproc as jmp
from msckf_stereo_c_tpu.parallel import vio_multiseq as jvm
from msckf_stereo_c_tpu.parallel.multiseq import make_mesh

torch.set_num_threads(1)

TIMEOUT_S = 120.0
UV_TOL = 5e-2 / EUROC_CALIB.cam0.intrinsics[0]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close_to_batch(got, want):
    """tests/test_torch_batch.py's bars, lane by lane."""
    np.testing.assert_array_equal(got["fid"], want["fid"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_allclose(got["uv"][v], want["uv"][v], rtol=0, atol=UV_TOL)
    np.testing.assert_allclose(got["p"], want["p"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["num_cams"], want["num_cams"])


@pytest.fixture(scope="module")
def block_ref():
    """One-process runs of the two ranks' blocks (lanes 0-1, 2-3)."""
    return tmproc.run_vio_reference(2, "cpu")


def test_vio_worker_bit_equal_to_one_process_blocks(block_ref, tmp_path):
    path = tmp_path / "vio_ref.npz"
    np.savez(path, **block_ref)
    results = tmproc.launch_workers("vio", 2, 1, str(path), TIMEOUT_S, "cpu")
    assert len(results) == 2
    reports = [r[0] for r in tmproc.check_workers(results)]
    total = int(block_ref["total_tracks"])
    assert sum(r["local_total_tracks"] for r in reports) == total > 0
    for rank, r in enumerate(reports):
        assert (r["process"], r["world"], r["backend"], r["device"]) == (rank, 2, "gloo", "cpu")
        assert r["lanes"] == [2 * rank, 2 * rank + 2]
        assert r["total_tracks"] == total
        assert r["gaps"] == {"ids_equal": True, "max_position_gap_m": 0.0}
        assert not any(r["launches"].values())  # the CPU takes the plain versions


def test_blocks_agree_with_one_batch(block_ref):
    """The per-block runs against the four lanes stepped in one batch."""
    _close_to_batch(block_ref, tmproc.run_vio_reference(1, "cpu"))


def test_sharded_vio_runner_matches_jax():
    fcfg, mcfg, calib = jmp.vio_configs()
    imgs0, imgs1, times, imu = jmp.vio_lane_inputs(range(2), jmp.VIO_FRAMES, mcfg, calib)
    saved = jkc._LOOP_MODE
    jkc._LOOP_MODE = "interpret"
    try:
        states = jvm.batched_init_vio_state(fcfg, mcfg, calib, imgs0.shape[2:], 2, jnp.float32, jnp.float32)
        run = jvm.make_sharded_vio_runner(make_mesh(2), j_fparams(calib, jnp.float32), j_mparams(mcfg, calib, jnp.float32),
                                          fcfg, mcfg, method="schur")
        j_states, j_poses, j_fronts, j_metrics = jax.device_get(run(
            states, jnp.asarray(imgs0), jnp.asarray(imgs1), jnp.asarray(times), jax.tree.map(jnp.asarray, imu)))
    finally:
        jkc._LOOP_MODE = saved
    want = {"fid": j_fronts.fid, "valid": j_fronts.valid, "uv": j_fronts.uv, "p": j_poses.p,
            "num_cams": j_states.filt.num_cams}

    tf, tm, tc = tmproc.vio_configs()
    f32 = torch.float32
    t_states = tvm.batched_init_vio_state(tf, tm, tc, imgs0.shape[2:], 2, f32, f32, "cpu")
    run = tvm.make_sharded_vio_runner(t_fparams(tc, f32, "cpu"), t_mparams(tm, tc, f32, "cpu"), tf, tm, method="schur")
    s, poses, fronts, metrics = run(t_states, imgs0, imgs1, times, convert.from_numpy(imu))
    got = {"fid": fronts.fid.numpy(), "valid": fronts.valid.numpy(), "uv": fronts.uv.numpy(), "p": poses.p.numpy(),
           "num_cams": s.filt.num_cams.numpy()}
    _close_to_batch(got, {k: np.asarray(v) for k, v in want.items()})
    assert int(metrics["total_tracks"]) == int(j_metrics["total_tracks"]) > 0
    assert int(metrics["max_online_reset_count"]) == int(j_metrics["max_online_reset_count"])


def test_ba_worker_matches_the_one_process_solve():
    reports = tmproc.run_tier("ba", 2, device="cpu", timeout=TIMEOUT_S)
    assert [r["lanes"] for r in reports] == [[0, 32], [32, 64]]
    for r in reports:
        assert r["costs"][1] < 1e-3 * r["costs"][0]


def test_a_failing_rank_fails_the_caller(tmp_path):
    """Rank 1's landmarks are held to a reference moved by 1e-6 m: rank 1
    exits with an error, rank 0 passes, and ``check_workers`` raises."""
    ref = tmproc.run_ba_reference("cpu")
    ref["landmarks"][32:] += 1e-6
    path = tmp_path / "ba_ref.npz"
    np.savez(path, **ref)
    results = tmproc.launch_workers("ba", 2, 1, str(path), TIMEOUT_S, "cpu")
    (rc0, out0), (rc1, out1) = results
    assert rc0 == 0 and "MULTIPROC_OK ba" in out0
    assert rc1 != 0 and "MULTIPROC_OK" not in out1
    with pytest.raises(RuntimeError, match="worker 1 failed"):
        tmproc.check_workers(results)


def test_timeout_kills_every_rank():
    results = tmproc.launch_workers("vio", 2, 1, None, 1.0, "cpu")
    assert len(results) == 2
    for rc, out in results:
        assert rc != 0 and out.endswith("<TIMEOUT>")


def test_no_card_no_fallback(monkeypatch):
    """Without CUDA a worker asked for the card raises (by hand and from
    the launcher); it never runs on the CPU instead.  The backend rule:
    nccl only when every rank has a card of its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmproc.worker_device(None, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmproc.launch_workers("ba", 2, timeout=TIMEOUT_S)
    r = subprocess.run(
        [sys.executable, "-m", "msckf_stereo_c_torch.parallel.multiproc", "--mode", "ba", "--process-id", "0",
         "--num-processes", "1", "--coordinator", "localhost:1"],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S,
    )
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert tmproc.pick_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmproc.pick_backend(torch.device("cuda", 0), 4) == "nccl"
    assert tmproc.pick_backend(torch.device("cuda", 0), 8) == "gloo"
