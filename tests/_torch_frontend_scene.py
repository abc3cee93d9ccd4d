"""Shared set-up of the port's front-end path tests: the bench scene of
tests/test_torch_frontend_options.py (circle trajectory, 300 wall landmarks,
752x480 stereo), frame inputs from the ground truth, and one
``frontend_step`` of both packages from the same JAX state.

Each frame the JAX tracker state is carried into the port with
``convert.from_numpy`` and both step once, so every frame is compared from
identical inputs.  The JAX step runs its Pallas LK loop in interpret mode
(the template formula the port uses on every device).

Tolerances: feature ids, validity and the five counters exact; tracked
points (``pts0``, ``pts1``) within 5e-2 px where valid; templates, birth
templates and the template quality (``snr``) bit-equal to the state before
the step where JAX's step leaves them untouched (no template carry: the
templates; no fused stereo call: ``snr``), elsewhere within 2e-3 (templates,
in grey levels) and 1e-2 relative (``snr``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import msckf_stereo_c_tpu.config as jconfig
import msckf_stereo_c_tpu.models.frontend as jfe
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.models import frontend as tfe
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_tpu.sim.render import render_stereo_sequence

IDX = np.array([290, 300, 310])
PT_TOL = 5e-2
TMPL_TOL = 2e-3
SNR_RTOL = 1e-2
COUNTERS = ("before_tracking", "after_tracking", "after_matching", "after_ransac", "anchor_accepted")
CALIB = jconfig.EUROC_CALIB


def make_scene(idx=IDX):
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    img0, img1 = render_stereo_sequence(traj, lms, idx, r_wall=8.0)
    return traj, imu, img0, img1


def frame_inputs(traj, imu, idx, k):
    """(mean gyro over the frame's 10 IMU samples, dt, is_first, cam0-frame
    velocity) of frame k, float32 numpy; dt 0 on the first frame."""
    i = idx[k]
    R_ic = CALIB.cam0.T_cam_imu_mat()[:3, :3]
    gyro = imu.gyro[i - 9 : i + 1].mean(0)
    v_cam = R_ic @ (traj.R_w_b[i].T @ traj.v[i])
    dt = 0.0 if k == 0 else traj.t[i] - traj.t[idx[k - 1]]
    return gyro.astype(np.float32), np.float32(dt), np.bool_(k == 0), v_cam.astype(np.float32)


def jax_params():
    return jfe.make_frontend_params(CALIB, jnp.float32)


def run_both(kw, scene, cam_vel=True, frames=3):
    """Step both packages over the scene's first ``frames`` frames under
    FrontendConfig(max_features=48, **kw), the JAX state carried into the
    port before every step; check each frame (module docstring).  Returns
    the JAX outputs."""
    traj, imu, img0, img1 = scene
    fcfg = jconfig.FrontendConfig(max_features=48, **kw)
    tfcfg = tconfig.FrontendConfig(max_features=48, **kw)
    jp = jax_params()
    tp = convert.from_numpy(jax.device_get(jp))
    step = jax.jit(
        lambda s, a, b, c, g, dt, f, v: jfe.frontend_step(s, a, b, c, g, dt, f, jp, fcfg, v if cam_vel else None)
    )
    state = jfe.init_tracker_state(fcfg, jnp.float32)
    pyr_prev = None
    outs = []
    for k in range(frames):
        p0 = jfe.pyramids_for(jnp.asarray(img0[k]), fcfg)
        p1 = jfe.pyramids_for(jnp.asarray(img1[k]), fcfg)
        if pyr_prev is None:
            pyr_prev = jax.tree.map(jnp.zeros_like, p0)
        g, dt, first, v = frame_inputs(traj, imu, IDX, k)
        tstate = convert.from_numpy(jax.device_get(state))
        tpyr_prev = tuple(torch.as_tensor(np.array(x)) for x in pyr_prev)
        new, jout = step(state, pyr_prev, p0, p1, jnp.asarray(g), jnp.asarray(dt), jnp.asarray(first), jnp.asarray(v))
        tnew, tout = tfe.frontend_step(
            tstate, tpyr_prev, tfe.pyramids_for(torch.as_tensor(img0[k]), tfcfg),
            tfe.pyramids_for(torch.as_tensor(img1[k]), tfcfg), torch.as_tensor(g), torch.as_tensor(dt),
            torch.as_tensor(first), tp, tfcfg, torch.as_tensor(v) if cam_vel else None,
        )
        check_step(jax.device_get(state), jax.device_get(new), jout, tnew, tout,
                   untouched_fields(fcfg, img0.shape[1:]))
        outs.append(jout)
        state, pyr_prev = new, p0
    return outs


def untouched_fields(fcfg, img_shape):
    """The state fields JAX's step leaves as they were under ``fcfg``: the
    templates without template carry, the quality without the fused call."""
    out = set()
    if not jfe._tmpl_carry_active(fcfg):
        out |= {"tmpl", "anchor"}
    if not jfe._fused_stereo_active(fcfg, img_shape):
        out.add("snr")
    return out


def check_step(jold, jnew, jout, tnew, tout, untouched):
    valid = np.asarray(jout.valid)
    np.testing.assert_array_equal(tout.fid.numpy(), np.asarray(jout.fid))
    np.testing.assert_array_equal(tout.valid.numpy(), valid)
    for name in COUNTERS:
        assert int(getattr(tout, name)) == int(getattr(jout, name)), name
    for name in ("pts0", "pts1"):
        np.testing.assert_allclose(
            getattr(tnew, name).numpy()[valid], np.asarray(getattr(jnew, name))[valid], rtol=0, atol=PT_TOL
        )
    for name, tol in (("tmpl", TMPL_TOL), ("anchor", TMPL_TOL), ("snr", None)):
        old, want, got = np.asarray(getattr(jold, name)), np.asarray(getattr(jnew, name)), getattr(tnew, name).numpy()
        if name in untouched:
            np.testing.assert_array_equal(want, old)
            np.testing.assert_array_equal(got, old, err_msg=f"{name}: JAX leaves it unchanged")
        elif tol is None:
            np.testing.assert_allclose(got, want, rtol=SNR_RTOL, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
