"""The port's MSCKF filter (Schur method, Newton-Schulz solves) against the
JAX package's, in float64 on the CPU.

Both filters start from the same state (``convert.vio_state_from_numpy``'s
tree conversion) and consume the same recorded frames: feature tracks of a
synthetic circle trajectory and the IMU batches packed for it.  The run is
long enough for lost-track updates, camera-window pruning and the online
reset check to run on every frame.  Tolerances: pose position 1e-6 m,
quaternion 1e-8, covariance 1e-6 relative to its largest entry; the two
implementations differ only in summation order and in the propagation
prefix products' association (log-depth scans in JAX)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.config import EUROC_CALIB as T_CALIB
from msckf_stereo_c_torch.config import FilterConfig as TFilterConfig
from msckf_stereo_c_torch.models import msckf as tmsckf
from msckf_stereo_c_torch.models import propagation as tprop
from msckf_stereo_c_torch.models import runner as trunner
from msckf_stereo_c_tpu.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c_tpu.models import msckf as jmsckf
from msckf_stereo_c_tpu.models import propagation as jprop
from msckf_stereo_c_tpu.models import runner as jrunner
from msckf_stereo_c_tpu.models.state import init_filter_state
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_landmarks, project_tracks, synthesize_imu

torch.set_num_threads(1)

KW = dict(max_cam_state_size=6, max_tracks=48, max_imu_per_frame=12, ns_iters=10)
JCFG, TCFG = FilterConfig(**KW), TFilterConfig(**KW)
N_FRAMES = 24


@pytest.fixture(scope="module")
def world():
    traj = make_circle_trajectory(duration=4.2)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    feats = project_tracks(traj, make_landmarks(num=300), max_features=32, pixel_noise=0.3)
    # Frames after the spin-up, so the cameras move and tracks churn.
    sl = slice(56, 56 + N_FRAMES)
    t = feats.t[sl]
    batches = jrunner.pack_imu_batches(
        imu.t, imu.gyro, imu.acc, t, JCFG.max_imu_per_frame, prev_frame_t=feats.t[55]
    )
    state = init_filter_state(JCFG, EUROC_CALIB, jnp.float64)
    state = jrunner.apply_gravity_init(state, imu.gyro[:200], imu.acc[:200])
    return dict(
        imu=imu, t=t, fid=feats.fid[sl], uv=feats.uv[sl], valid=feats.valid[sl],
        batches=jax.device_get(batches), state0=jax.device_get(state),
        prev_t=feats.t[55],
    )


def _frame(w, k, lib):
    if lib == "jax":
        return jmsckf.FrameFeatures(
            time=jnp.asarray(w["t"][k]), fid=jnp.asarray(w["fid"][k], jnp.int32),
            uv=jnp.asarray(w["uv"][k]), valid=jnp.asarray(w["valid"][k]),
        )
    return tmsckf.FrameFeatures(
        time=torch.as_tensor(w["t"][k]), fid=torch.as_tensor(w["fid"][k].astype(np.int32)),
        uv=torch.as_tensor(w["uv"][k]), valid=torch.as_tensor(w["valid"][k]),
    )


def test_pack_imu_batches(world):
    w = world
    got = trunner.pack_imu_batches(
        w["imu"].t, w["imu"].gyro, w["imu"].acc, w["t"], TCFG.max_imu_per_frame, prev_frame_t=w["prev_t"]
    )
    for name, want in w["batches"]._asdict().items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want))


def test_propagate(world):
    """One frame's IMU propagation from a state with a full camera window:
    the port's sequential prefix products against JAX's associative
    scans."""
    w = world
    jparams = jmsckf.make_params(JCFG, EUROC_CALIB, jnp.float64)
    step = jax.jit(functools.partial(jmsckf.filter_step, params=jparams, cfg=JCFG, method="schur"))
    state = w["state0"]
    for k in range(8):
        imu = jax.tree.map(lambda x: jnp.asarray(x[k]), w["batches"])
        state, _ = step(state, _frame(w, k, "jax"), imu)
    batch = jax.tree.map(lambda x: jnp.asarray(x[8]), w["batches"])
    want = jax.device_get(jax.jit(jprop.propagate)(state, batch, jparams.Q_imu))
    tstate = convert.from_numpy(jax.device_get(state))
    tbatch = convert.from_numpy(jax.device_get(batch))
    got = tprop.propagate(tstate, tbatch, torch.as_tensor(np.array(jparams.Q_imu)))
    for name in ("q", "bg", "v", "ba", "p", "q_null", "v_null", "p_null", "time"):
        np.testing.assert_allclose(
            getattr(got.imu, name).numpy(), np.asarray(getattr(want.imu, name)), rtol=0, atol=1e-10
        )
    P_want = np.asarray(want.P)
    np.testing.assert_allclose(got.P.numpy(), P_want, rtol=0, atol=1e-10 * np.abs(P_want).max())


def test_filter_step_sequence(world):
    """filter_step over the recorded frames, each implementation carrying
    its own state."""
    w = world
    jparams = jmsckf.make_params(JCFG, EUROC_CALIB, jnp.float64)
    tparams = tmsckf.make_params(TCFG, T_CALIB, torch.float64, "cpu")
    np.testing.assert_array_equal(
        convert.to_numpy(tparams).Q_imu, np.asarray(jparams.Q_imu)
    )
    step = jax.jit(functools.partial(jmsckf.filter_step, params=jparams, cfg=JCFG, method="schur"))
    jstate = w["state0"]
    tstate = convert.from_numpy(w["state0"])
    cams, tracks = [], []
    for k in range(N_FRAMES):
        jimu = jax.tree.map(lambda x: jnp.asarray(x[k]), w["batches"])
        timu = convert.from_numpy(jax.tree.map(lambda x: np.asarray(x[k]), w["batches"]))
        jstate, jpose = step(jstate, _frame(w, k, "jax"), jimu)
        tstate, tpose = tmsckf.filter_step(tstate, _frame(w, k, "torch"), timu, tparams, TCFG)
        np.testing.assert_allclose(tpose.p.numpy(), np.asarray(jpose.p), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tpose.q_xyzw.numpy(), np.asarray(jpose.q_xyzw), rtol=0, atol=1e-8)
        assert int(tpose.num_cams) == int(jpose.num_cams)
        assert int(tpose.num_tracks) == int(jpose.num_tracks)
        P = np.asarray(jstate.P)
        np.testing.assert_allclose(tstate.P.numpy(), P, rtol=0, atol=1e-6 * np.abs(P).max())
        np.testing.assert_array_equal(tstate.tracks.fid.numpy(), np.asarray(jstate.tracks.fid))
        np.testing.assert_array_equal(
            tstate.tracks.obs_valid.numpy(), np.asarray(jstate.tracks.obs_valid)
        )
        cams.append(int(jpose.num_cams))
        tracks.append(int(jpose.num_tracks))
    assert int(jstate.next_sid) == N_FRAMES
    # The window was pruned and lost tracks left the map, more than once.
    assert sum(b < a for a, b in zip(cams, cams[1:])) >= 3
    assert sum(b < a for a, b in zip(tracks, tracks[1:])) >= 3


def test_snr_weights():
    """The per-track SNR weights against the JAX package's, on qualities
    with unknown (0) entries, masked observations and tracks at both clip
    limits (float64, equal to 1e-15)."""
    rng = np.random.default_rng(3)
    q = rng.uniform(0.0, 60.0, (40, 7)) * (rng.uniform(size=(40, 7)) < 0.8)
    q[0] = 0.0  # unknown quality: weight 1
    q[1] = 1e-3  # inflation at the cap
    mask = rng.uniform(size=(40, 7)) < 0.7
    mask[:2] = True
    cfg = TFilterConfig(**KW, noise_adaptive=True)
    want = np.asarray(jmsckf._snr_weights(jnp.asarray(q), jnp.asarray(mask), JCFG))
    got = tmsckf._snr_weights(torch.as_tensor(q), torch.as_tensor(mask), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    assert got[0] == 1.0 and got[1] == 1.0 / cfg.noise_inflation_cap
    assert (got > 0).all() and (got <= 1).all() and (got < 1).sum() > 10


def test_filter_step_noise_adaptive(world):
    """filter_step with the SNR-adaptive observation noise over the first
    frames, each observation carrying a tracking-SNR proxy drawn per (frame,
    feature): the lost-track updates and camera prunes weight each track by
    sqrt(w).  Same tolerances as test_filter_step_sequence."""
    w = world
    kw = dict(KW, noise_adaptive=True)
    jcfg, tcfg = FilterConfig(**kw), TFilterConfig(**kw)
    jparams = jmsckf.make_params(jcfg, EUROC_CALIB, jnp.float64)
    tparams = tmsckf.make_params(tcfg, T_CALIB, torch.float64, "cpu")
    step = jax.jit(functools.partial(jmsckf.filter_step, params=jparams, cfg=jcfg, method="schur"))
    rng = np.random.default_rng(5)
    qual = rng.uniform(2.0, 60.0, w["uv"].shape[:2])
    jstate, tstate = w["state0"], convert.from_numpy(w["state0"])
    weighted = 0  # track-frames whose updates would carry a weight below 1
    for k in range(14):
        jimu = jax.tree.map(lambda x: jnp.asarray(x[k]), w["batches"])
        timu = convert.from_numpy(jax.tree.map(lambda x: np.asarray(x[k]), w["batches"]))
        jstate, jpose = step(jstate, _frame(w, k, "jax")._replace(quality=jnp.asarray(qual[k])), jimu)
        tstate, tpose = tmsckf.filter_step(
            tstate, _frame(w, k, "torch")._replace(quality=torch.as_tensor(qual[k])), timu, tparams, tcfg
        )
        np.testing.assert_allclose(tpose.p.numpy(), np.asarray(jpose.p), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tpose.q_xyzw.numpy(), np.asarray(jpose.q_xyzw), rtol=0, atol=1e-8)
        P = np.asarray(jstate.P)
        np.testing.assert_allclose(tstate.P.numpy(), P, rtol=0, atol=1e-6 * np.abs(P).max())
        np.testing.assert_array_equal(tstate.tracks.fid.numpy(), np.asarray(jstate.tracks.fid))
        t = tstate.tracks
        weighted += int((tmsckf._snr_weights(t.quality, t.obs_valid, tcfg) < 1).sum())
    assert weighted > 50


def test_unsupported_filter_options_raise():
    for kw, method in [({}, "qr"), ({"ns_iters": 0}, "schur")]:
        with pytest.raises(NotImplementedError):
            tmsckf.check_supported(TFilterConfig(**{**KW, **kw}), method)
