"""B sequences stepped together: the port's batched frame step against the
JAX package's ``jax.vmap(vio_step)``, against one-lane runs of the port,
and the batched state's conversion; plus the batched entry points.

Three distinct lanes: lane b starts 12 b trajectory samples later (as
tests/test_vio_multiseq.py does), and enters the compared frames after b
frames of its own, so the lanes hold 0, 1 and 2 camera states.  With a
window of four cameras, the first compared frame is lane 0's first frame
only, and later frames prune the window in some lanes and not in others.
Sizes and tolerances are tests/test_torch_vio.py's: image float32, filter
float64, Schur method with Newton-Schulz solves, the JAX Pallas LK loop in
interpret mode; feature ids and validity identical, normalized observations
within 5e-2 px (divided by fx), pose within 1e-4 m, camera counts equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.config as jconfig
import msckf_stereo_c_tpu.ops.klt_corr as jkc
from msckf_stereo_c_torch import bench as tbench
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.models import msckf as tmsckf
from msckf_stereo_c_torch.models import vio as tvio
from msckf_stereo_c_torch.parallel import vio_multiseq as tmulti
from msckf_stereo_c_torch.utils.lanes import lane
from msckf_stereo_c_tpu.models import msckf as jmsckf
from msckf_stereo_c_tpu.models.frontend import make_frontend_params
from msckf_stereo_c_tpu.models.msckf import make_params
from msckf_stereo_c_tpu.models.runner import apply_gravity_init, pack_imu_batches
from msckf_stereo_c_tpu.models.vio import init_vio_state, vio_step
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_tpu.sim.render import render_stereo_sequence

torch.set_num_threads(1)

B = 3
N_PRE = B - 1  # lane b steps b frames of its own before the compared ones
N_STEP = 4  # compared frames: 3 against JAX, 4 against the one-lane runs
FKW = dict(max_features=48)
MKW = dict(max_cam_state_size=4, max_tracks=64, max_imu_per_frame=10, ns_iters=10)
UV_TOL = 5e-2 / jconfig.EUROC_CALIB.cam0.intrinsics[0]


def _tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def lanes(monkeypatch_module):
    """Per-lane frames and IMU batches, and the lanes' entry states, stepped
    by the JAX package (one vmapped, jitted step for every frame)."""
    monkeypatch_module.setattr(jkc, "_LOOP_MODE", "interpret")
    fcfg, mcfg = jconfig.FrontendConfig(**FKW), jconfig.FilterConfig(**MKW)
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    n = N_PRE + N_STEP
    idx = [290 + 12 * b + 10 * np.arange(n) for b in range(B)]
    rendered = [render_stereo_sequence(traj, lms, i, r_wall=8.0) for i in idx]
    img0 = np.stack([r[0] for r in rendered]).astype(np.float32)  # (B, n, H, W)
    img1 = np.stack([r[1] for r in rendered]).astype(np.float32)
    times = np.stack([traj.t[i] for i in idx])  # (B, n)
    imus = [_tree_np(pack_imu_batches(imu.t, imu.gyro, imu.acc, t, mcfg.max_imu_per_frame)) for t in times]

    fparams = make_frontend_params(jconfig.EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, jconfig.EUROC_CALIB, jnp.float64)
    one = init_vio_state(fcfg, mcfg, jconfig.EUROC_CALIB, img0.shape[2:], jnp.float32, jnp.float64)
    one = one._replace(filt=apply_gravity_init(one.filt, imu.gyro[:200], imu.acc[:200]))
    step = jax.jit(jax.vmap(
        lambda s, i0, i1, t, b: vio_step(s, i0, i1, t, b, fparams, mparams, fcfg, mcfg, "schur")
    ))

    def frame(k):
        """(img0, img1, time, imu) of the frames k[b] of each lane b."""
        ks = np.asarray(k)
        lane_ix = np.arange(B)
        imu_k = [jax.tree.map(lambda a: a[kk], imus[b]) for b, kk in enumerate(ks)]
        return (
            img0[lane_ix, ks], img1[lane_ix, ks], times[lane_ix, ks],
            jax.tree.map(lambda *x: np.stack(x), *imu_k),
        )

    # Lane b enters after b frames of its own: step every lane through the
    # prelude and keep lane b's state after step b - 1.
    state = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), one)
    entries = [_tree_np(state)]
    for j in range(N_PRE):
        state, _ = step(state, *frame([j] * B))
        entries.append(_tree_np(state))
    entry = jax.tree.map(lambda *x: np.stack([x[b][b] for b in range(B)]), *entries)
    return dict(
        step=step, frame=frame, entry=entry, fparams=_tree_np(fparams), mparams=_tree_np(mparams),
        img0=img0, img1=img1, times=times, imus=imus,
    )


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _port_frame(lanes, k):
    i0, i1, t, b = lanes["frame"](k)
    return (
        torch.as_tensor(i0), torch.as_tensor(i1), torch.as_tensor(t),
        convert.from_numpy(b),
    )


def _port_params():
    return (
        tconfig.FrontendConfig(**FKW), tconfig.FilterConfig(**MKW),
    )


def test_batched_step_matches_jax_vmap(lanes):
    """Three frames of the batched step, lane by lane against
    ``jax.vmap(vio_step)``; the lanes disagree on the first frame and on
    the camera prune."""
    tfcfg, tmcfg = _port_params()
    jstate = lanes["entry"]
    tstate, tfp, tmp = convert.vio_state_from_numpy(lanes["entry"], lanes["fparams"], lanes["mparams"], "cpu")
    assert tstate.filt.P.shape[0] == B
    np.testing.assert_array_equal(tstate.filt.num_cams.numpy(), np.arange(B))
    mixed_prune = 0
    for k in range(3):
        ks = [b + k for b in range(B)]
        first = np.asarray(jstate.prev_time) < 0
        before = np.asarray(jstate.filt.num_cams)
        jstate, (jpose, jout) = lanes["step"](jstate, *lanes["frame"](ks))
        tstate, (tpose, tout) = tvio.batched_vio_step(tstate, *_port_frame(lanes, ks), tfp, tmp, tfcfg, tmcfg, "schur")
        if k == 0:
            np.testing.assert_array_equal(first, [True, False, False])
        after = np.asarray(jpose.num_cams)
        pruned = after < before + 1
        mixed_prune += bool(pruned.any() and not pruned.all())
        for b in range(B):
            valid = np.asarray(jout.valid[b])
            np.testing.assert_array_equal(tout.fid[b].numpy(), np.asarray(jout.fid[b]))
            np.testing.assert_array_equal(tout.valid[b].numpy(), valid)
            np.testing.assert_allclose(
                tout.uv[b].numpy()[valid], np.asarray(jout.uv[b])[valid], rtol=0, atol=UV_TOL
            )
            np.testing.assert_allclose(tpose.p[b].numpy(), np.asarray(jpose.p[b]), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tpose.num_cams.numpy(), after)
        for name in ("after_tracking", "after_matching", "anchor_accepted"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), name)
    assert mixed_prune >= 1
    assert (np.asarray(jout.after_ransac) > 10).all()


def _assert_lane_equal(batched, single, what, ftol):
    """Every tensor of the tree ``single`` against the same tree ``batched``
    of one lane: ints and bools exact, floats within ``ftol`` times the
    field's largest magnitude (at least 1)."""
    got, want = jax.tree.leaves(convert.to_numpy(batched)), jax.tree.leaves(convert.to_numpy(single))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=ftol * max(1.0, np.abs(b).max()), err_msg=f"{what}, leaf {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}, leaf {i}")


def test_batched_step_equals_one_lane_runs(lanes):
    """The batched step at B=3 over four frames against three one-lane runs
    of the port on the same lanes: ints and bools exact, floats within 1e-12
    of each field's largest magnitude (at least 1).  The lanes take the same
    arithmetic; the float64 filter's batched products may associate
    differently (1.4e-20 m on a pose here)."""
    tfcfg, tmcfg = _port_params()
    tstate, tfp, tmp = convert.vio_state_from_numpy(lanes["entry"], lanes["fparams"], lanes["mparams"], "cpu")
    singles = [lane(tstate, b) for b in range(B)]
    for k in range(N_STEP):
        ks = [b + k for b in range(B)]
        i0, i1, t, imu = _port_frame(lanes, ks)
        tstate, outs = tvio.batched_vio_step(tstate, i0, i1, t, imu, tfp, tmp, tfcfg, tmcfg, "schur")
        for b in range(B):
            singles[b], one = tvio.vio_step(
                singles[b], i0[b], i1[b], t[b], lane(imu, b), tfp, tmp, tfcfg, tmcfg, "schur"
            )
            _assert_lane_equal(lane(outs, b), one, f"outputs, frame {k}, lane {b}", 1e-12)
    for b in range(B):
        _assert_lane_equal(lane(tstate, b), singles[b], f"state, lane {b}", 1e-12)


def test_batched_state_conversion(lanes):
    """``convert`` carries a batched JAX state (numpy tree with a leading B)
    into the port and back unchanged; each lane equals the lane's own
    unbatched conversion."""
    entry = lanes["entry"]
    tstate, _, _ = convert.vio_state_from_numpy(entry, device="cpu")
    back, _, _ = convert.vio_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(entry), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.shape[0] == B
        np.testing.assert_array_equal(a, b)
    for b in range(B):
        one, _, _ = convert.vio_state_from_numpy(jax.tree.map(lambda x: x[b], entry), device="cpu")
        for x, y in zip(jax.tree.leaves(convert.to_numpy(lane(tstate, b))), jax.tree.leaves(convert.to_numpy(one))):
            np.testing.assert_array_equal(x, y)


def test_online_reset_and_gravity_init_per_lane(lanes):
    """The per-lane online reset and gravity init against the JAX package's
    vmapped ones, with lanes that disagree: one lane's position covariance
    above the reset threshold, per-lane IMU windows."""
    filt = lanes["entry"].filt
    P = filt.P.copy()
    P[1, 12, 12] = 100.0  # lane 1's position std above the 8 m threshold
    filt = filt._replace(P=P)
    jparams = jmsckf.make_params(jconfig.FilterConfig(**MKW), jconfig.EUROC_CALIB, jnp.float64)
    want = _tree_np(jax.vmap(jmsckf._online_reset, in_axes=(0, None))(filt, jparams))
    tparams = tmsckf.make_params(tconfig.FilterConfig(**MKW), tconfig.EUROC_CALIB, torch.float64, "cpu")
    got = convert.to_numpy(tmsckf._online_reset(convert.from_numpy(filt), tparams))
    np.testing.assert_array_equal(got.online_reset_count - filt.online_reset_count, [0, 1, 0])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(4)
    gyro = rng.normal(0.0, 1e-3, (B, 50, 3))
    acc = np.array([0.3, -0.2, 9.8]) + rng.normal(0.0, 0.2, (B, 50, 3))
    want = _tree_np(jax.vmap(apply_gravity_init)(lanes["entry"].filt, gyro, acc))
    tstate, _, _ = convert.vio_state_from_numpy(lanes["entry"], device="cpu")
    got = convert.to_numpy(tmulti.batched_gravity_init(tstate, gyro, acc).filt)
    for name in ("q", "bg", "q_null"):
        np.testing.assert_allclose(getattr(got.imu, name), getattr(want.imu, name), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.gravity, want.gravity, rtol=0, atol=1e-12)
    assert np.ptp(got.gravity[:, 2]) > 0


def test_run_vio_batch_shared_images(lanes):
    """``run_vio_batch`` with images shared by every lane (bench.py's case)
    and identical lanes: every lane equals lane 0 exactly, and the
    metrics are the JAX runner's."""
    tfcfg, tmcfg = _port_params()
    entry = jax.tree.map(lambda x: np.broadcast_to(x[1], x.shape), lanes["entry"])
    tstate, tfp, tmp = convert.vio_state_from_numpy(entry, lanes["fparams"], lanes["mparams"], "cpu")
    imu = convert.from_numpy(jax.tree.map(lambda x: np.broadcast_to(x[1:3], (B,) + x[1:3].shape), lanes["imus"][1]))
    times = np.broadcast_to(lanes["times"][1, 1:3], (B, 2)).copy()
    states, poses, fronts, metrics = tmulti.run_vio_batch(
        tstate, lanes["img0"][1, 1:3], lanes["img1"][1, 1:3], times, imu, tfp, tmp, tfcfg, tmcfg, device="cpu"
    )
    assert poses.p.shape == (B, 2, 3) and fronts.fid.shape == (B, 2, FKW["max_features"])
    for b in range(1, B):
        _assert_lane_equal(lane(poses, b), lane(poses, 0), f"poses, lane {b}", 0.0)
        _assert_lane_equal(lane(states, b), lane(states, 0), f"state, lane {b}", 0.0)
    assert int(metrics["total_tracks"]) == int(poses.num_tracks.sum())
    assert int(metrics["max_online_reset_count"]) == int(states.filt.online_reset_count.max())


@pytest.mark.parametrize("env", [dict(BENCH_FILTER_PRECISION="bfloat16"), dict(BENCH_TEMPORAL_LEVELS="2"),
                                 dict(BENCH_KLT="gather"), dict(BENCH_UNROLL="2")])
def test_bench_unsupported_knobs_raise(monkeypatch, env):
    """BENCH_UNROLL raises; the knobs the port once rejected (the filter's
    bf16 names, two temporal levels, the gather LK) now give their
    configuration."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if "BENCH_FILTER_PRECISION" in env:
        _, mcfg, method = tbench.bench_configs()
        assert (mcfg.matmul_precision, mcfg.ns_iters, method) == ("bfloat16", 10, "schur")
        return
    if "BENCH_TEMPORAL_LEVELS" in env or "BENCH_KLT" in env:
        fcfg, _, _ = tbench.bench_configs()
        assert (fcfg.temporal_levels, fcfg.klt_impl) == (int(env.get("BENCH_TEMPORAL_LEVELS", 1)),
                                                         env.get("BENCH_KLT", "corr"))
        return
    with pytest.raises(NotImplementedError):
        tbench.bench_configs()


def test_batched_entry_points_need_a_device_or_cuda(monkeypatch):
    """``run_vio_batch`` and ``batched_init_vio_state`` default to the card;
    without CUDA they raise unless the caller names a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fcfg, mcfg = tconfig.FrontendConfig(max_features=8), tconfig.FilterConfig(max_cam_state_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmulti.batched_init_vio_state(fcfg, mcfg, tconfig.EUROC_CALIB, (64, 96), 2)
    states = tmulti.batched_init_vio_state(fcfg, mcfg, tconfig.EUROC_CALIB, (64, 96), 2, device="cpu")
    assert states.filt.P.shape[0] == 2 and states.pyr0_prev[0].shape == (2, 64, 96)
    imu = tmsckf.ImuBatch(*(torch.zeros((2, 1, 3) + s) for s in ((), (3,), (3,), (), ())))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmulti.run_vio_batch(states, np.zeros((1, 64, 96)), np.zeros((1, 64, 96)), np.zeros((2, 1)), imu,
                             None, None, fcfg, mcfg)
