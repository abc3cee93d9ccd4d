"""The port's whole stereo VIO step (tracker + filter) against the JAX
package's, plus the guards that keep the port's copies in step with it.

The setup is tests/test_vio_system.py's (bench scene frames, image float32,
filter float64, Schur method), with Newton-Schulz solves as the bench runs
them.  The JAX step runs its Pallas LK kernel in interpret mode, which takes
the template formula the port uses on every device.  The JAX package runs
the first frame; its state is carried into the port with
``convert.vio_state_from_numpy`` and both then step three frames.

Tolerances: published feature ids and validity identical; normalized
observations within 5e-2 px (divided by fx); pose within 1e-4 m.  The
port's LK surfaces come from a conv2d and its pyramid from shifted adds, so
tracked points agree to about 1e-3 px, not bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.config as jconfig
import msckf_stereo_c_tpu.ops.klt_corr as jkc
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.models import frontend as tfrontend
from msckf_stereo_c_torch.models import msckf as tmsckf
from msckf_stereo_c_torch.models import vio as tvio
from msckf_stereo_c_tpu.models.frontend import make_frontend_params
from msckf_stereo_c_tpu.models.msckf import make_params
from msckf_stereo_c_tpu.models.propagation import ImuBatch
from msckf_stereo_c_tpu.models.vio import init_vio_state, vio_step
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_tpu.sim.render import render_stereo_sequence

torch.set_num_threads(1)

FKW = dict(max_features=48)
MKW = dict(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=10, ns_iters=10)
IDX = np.array([290, 300, 310, 320])
UV_TOL = 5e-2 / jconfig.EUROC_CALIB.cam0.intrinsics[0]


def _imu_batch(traj, imu, i, L):
    t0 = traj.t[i]
    return dict(
        time=t0 - 0.05 + np.arange(1, L + 1) * 0.005,
        gyro=imu.gyro[i - L + 1 : i + 1],
        acc=imu.acc[i - L + 1 : i + 1],
        valid=np.ones(L, bool),
    )


def test_vio_step_three_frames(monkeypatch):
    monkeypatch.setattr(jkc, "_LOOP_MODE", "interpret")
    fcfg, mcfg = jconfig.FrontendConfig(**FKW), jconfig.FilterConfig(**MKW)
    tfcfg, tmcfg = tconfig.FrontendConfig(**FKW), tconfig.FilterConfig(**MKW)
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    img0, img1 = render_stereo_sequence(traj, lms, IDX, r_wall=8.0)
    L = mcfg.max_imu_per_frame

    fparams = make_frontend_params(jconfig.EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, jconfig.EUROC_CALIB, jnp.float64)
    state = init_vio_state(fcfg, mcfg, jconfig.EUROC_CALIB, img0.shape[1:], jnp.float32, jnp.float64)
    step = jax.jit(
        lambda s, i0, i1, t, b: vio_step(s, i0, i1, t, b, fparams, mparams, fcfg, mcfg, "schur")
    )

    def jstep(s, k):
        b = ImuBatch(**{n: jnp.asarray(v) for n, v in _imu_batch(traj, imu, IDX[k], L).items()})
        return step(s, jnp.asarray(img0[k]), jnp.asarray(img1[k]), jnp.asarray(traj.t[IDX[k]]), b)

    state, _ = jstep(state, 0)
    tstate, tfp, tmp = convert.vio_state_from_numpy(
        jax.device_get(state), jax.device_get(fparams), jax.device_get(mparams), device="cpu"
    )
    # The port's own parameter builders give the same constants.
    for mine, theirs in [
        (tfrontend.make_frontend_params(tconfig.EUROC_CALIB, torch.float32, "cpu"), tfp),
        (tmsckf.make_params(tmcfg, tconfig.EUROC_CALIB, torch.float64, "cpu"), tmp),
    ]:
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)

    for k in (1, 2, 3):
        state, (jpose, jout) = jstep(state, k)
        b = tmsckf.ImuBatch(**{n: torch.as_tensor(v) for n, v in _imu_batch(traj, imu, IDX[k], L).items()})
        tstate, (tpose, tout) = tvio.vio_step(
            tstate, torch.as_tensor(img0[k]), torch.as_tensor(img1[k]),
            torch.as_tensor(traj.t[IDX[k]]), b, tfp, tmp, tfcfg, tmcfg,
        )
        valid = np.asarray(jout.valid)
        np.testing.assert_array_equal(tout.fid.numpy(), np.asarray(jout.fid))
        np.testing.assert_array_equal(tout.valid.numpy(), valid)
        np.testing.assert_allclose(tout.uv.numpy()[valid], np.asarray(jout.uv)[valid], rtol=0, atol=UV_TOL)
        np.testing.assert_allclose(tpose.p.numpy(), np.asarray(jpose.p), rtol=0, atol=1e-4)
        assert int(tpose.num_cams) == int(jpose.num_cams)
        for name in ("after_tracking", "after_matching", "anchor_accepted"):
            assert int(getattr(tout, name)) == int(getattr(jout, name)), name
    assert int(jout.after_ransac) > 10
    assert int(jpose.num_cams) == 4

    # The state converts back to the same numpy tree.
    back, _, _ = convert.vio_state_to_numpy(tstate)
    again = convert.from_numpy(back)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(tstate)), jax.tree.leaves(convert.to_numpy(again))):
        np.testing.assert_array_equal(a, b)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["FrontendConfig", "FilterConfig", "CameraCalib", "StereoCalib"])
def test_config_copies_match(name):
    """The port keeps its own copy of the configuration: the same fields
    with the same defaults as msckf_stereo_c_tpu/config.py."""
    assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))


def test_calibration_and_defaults_match():
    assert dataclasses.asdict(tconfig.EUROC_CALIB) == dataclasses.asdict(jconfig.EUROC_CALIB)
    assert dataclasses.asdict(tconfig.FrontendConfig()) == dataclasses.asdict(jconfig.FrontendConfig())
    assert dataclasses.asdict(tconfig.FilterConfig()) == dataclasses.asdict(jconfig.FilterConfig())
    assert tconfig.FilterConfig().state_dim == jconfig.FilterConfig().state_dim
    assert tconfig.FrontendConfig().num_grids == jconfig.FrontendConfig().num_grids


def test_precision_scope():
    """TF32 only for 'default'; every other float name runs full f32, the
    bf16 names raise, and the previous flags come back on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for name, allow in [("default", True), ("tensorfloat32", False), ("float32", False), ("highest", False)]:
        with tconfig.matmul_precision_scope(name):
            assert torch.backends.cuda.matmul.allow_tf32 is allow
            assert torch.backends.cudnn.allow_tf32 is allow
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == prev
    for name in ("bfloat16", "bfloat16_3x"):
        with pytest.raises(NotImplementedError):
            with tconfig.matmul_precision_scope(name):
                pass
    with pytest.raises(ValueError):
        tconfig.FrontendConfig(matmul_precision="fp8")


@pytest.mark.parametrize(
    "option", [dict(klt_impl="gather"), dict(anchor_refine=False), dict(ransac_enabled=True),
               dict(stereo_lr_threshold=0.0), dict(temporal_levels=2), dict(tmpl_carry=False)]
)
def test_unported_frontend_options_raise(option):
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        tfrontend.check_supported(tconfig.FrontendConfig(**option), (480, 752))


def test_entry_points_need_a_device_or_cuda(monkeypatch):
    """Entry points default to the card; without CUDA they raise unless
    the caller names a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fcfg, mcfg = tconfig.FrontendConfig(max_features=8), tconfig.FilterConfig(max_cam_state_size=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvio.init_vio_state(fcfg, mcfg, tconfig.EUROC_CALIB, (64, 96))
    with pytest.raises(RuntimeError, match="CUDA"):
        tvio.run_vio_sequence(
            fcfg, mcfg, tconfig.EUROC_CALIB, np.zeros(1), np.zeros((1, 64, 96)), np.zeros((1, 64, 96)),
            np.zeros(1), np.zeros((1, 3)), np.zeros((1, 3)),
        )
    state = tvio.init_vio_state(fcfg, mcfg, tconfig.EUROC_CALIB, (64, 96), device="cpu")
    assert state.filt.P.device.type == "cpu"
