"""The stress-gate path of the port: the device renderer
(``sim/render_torch.py``) against the JAX package's ``JaxRenderer``, its
sensor noise, the stress gate (``sim/stress.py``), and one VIO step over
stress-scene frames with ``klt_norm='mixed'`` against the JAX step.

Tolerances are stated at each test."""
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
from msckf_stereo_c_torch.models import msckf as tmsckf
from msckf_stereo_c_torch.models import vio as tvio
from msckf_stereo_c_torch.ops import _cuda
from msckf_stereo_c_torch.sim import render_torch as trender
from msckf_stereo_c_torch.sim import stress as tstress
from msckf_stereo_c_torch.utils.lie import so3_log
from msckf_stereo_c_tpu.models.frontend import make_frontend_params
from msckf_stereo_c_tpu.models.msckf import make_params
from msckf_stereo_c_tpu.models.propagation import ImuBatch
from msckf_stereo_c_tpu.models.vio import init_vio_state, vio_step
from msckf_stereo_c_tpu.sim import render_jax as jrender
from msckf_stereo_c_tpu.sim.trajectory import make_room_landmarks, make_stress_trajectory, synthesize_imu
from msckf_stereo_c_tpu.utils.lie import so3_log as jso3_log

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    traj = make_stress_trajectory(duration=36.0)
    idx = np.arange(0, traj.t.shape[0], 10)
    lms = make_room_landmarks(num=900, radius=7.0, z_cap=3.5, seed=1)
    return traj, idx, lms


def _pick(ev, k, cls):
    """The events of frames ``k`` as ``cls`` (either package's StressEvents)."""
    fields = {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)}
    out = {n: (v[k] if isinstance(v, np.ndarray) else v) for n, v in fields.items()}
    return cls(**out)


def test_so3_log_and_pose_taps(scene):
    """so3_log against the JAX package's (1e-12 rad in float64), and the
    blur taps against the JAX renderer's, which it computes in float32
    (1e-6 in rotation entries and 1e-9 m in position)."""
    traj, idx, _ = scene
    rng = np.random.default_rng(0)
    from msckf_stereo_c_torch.utils.lie import so3_exp

    phi = rng.normal(size=(50, 3)) * np.r_[[1e-9] * 10 + [0.3] * 40][:, None]
    R = so3_exp(torch.as_tensor(phi))
    got = so3_log(R).numpy()
    np.testing.assert_allclose(got, np.asarray(jso3_log(jnp.asarray(R.numpy()))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, phi, rtol=0, atol=1e-9)
    offs = np.array([-0.5, 0.0, 0.5])
    Rt, pt = trender._interp_pose_taps(traj, idx[100:104], offs, traj.p.shape[0])
    Rj, pj = jrender._interp_pose_taps(traj, idx[100:104], offs, traj.p.shape[0])
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)


def test_make_stress_events_matches(scene):
    traj, idx, _ = scene
    jev = jrender.make_stress_events(traj, idx, noise_seed=3)
    tev = trender.make_stress_events(traj, idx, noise_seed=3)
    for f in dataclasses.fields(jev):
        a, b = getattr(tev, f.name), getattr(jev, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    s = tev.slice(100, 164)
    assert s.noise_frame0 == 100 and s.gain.shape == (64,)


def test_renderer_matches_jax(scene):
    """Two frames inside the occluder window with blur, vignette, exposure
    gain and offset and the occluder on, noise off.  The renderers agree to
    float32 rounding almost everywhere: median |diff| < 1e-4 DN, 99.99 % of
    pixels within 0.05 DN; the few others sit where a rounding flips a
    discrete choice (a blob's rounded centre, the wall/cap seam, the
    occluder's rim), so the largest difference stays below 60 DN.
    Measured: median 3.8e-6 DN in both cameras, one pixel of 721920 above
    0.05 DN (8.1 DN, cam1), the rest within 0.0017 DN; the occluder changes
    33 % of cam0's pixels."""
    traj, idx, lms = scene
    jev = jrender.make_stress_events(traj, idx, sensor_noise=False)
    tev = trender.make_stress_events(traj, idx, sensor_noise=False)
    sel = np.flatnonzero(jev.occ_radius > 0.7)
    k = np.array([sel[len(sel) // 2], sel[len(sel) // 2] + 5])
    jr = jrender.JaxRenderer(lms, r_wall=7.0, z_cap=3.5)
    tr = trender.TorchRenderer(lms, r_wall=7.0, z_cap=3.5, device="cpu")
    want = jr.render_sequence(traj, idx[k], _pick(jev, k, jrender.StressEvents))
    got = tr.render_sequence(traj, idx[k], _pick(tev, k, trender.StressEvents))
    # The occluder must be in view for this check to cover it.
    plain = tr.render_sequence(traj, idx[k], dataclasses.replace(_pick(tev, k, trender.StressEvents),
                                                                 occ_radius=np.zeros(2)))
    assert float((got[0] != plain[0]).float().mean()) > 0.01
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 480, 752)
        diff = np.abs(g.numpy().astype(np.float64) - np.asarray(w, np.float64))
        assert np.median(diff) < 1e-4, np.median(diff)
        assert np.mean(diff < 0.05) > 0.9999, np.mean(diff < 0.05)
        assert diff.max() < 60.0, diff.max()


def test_noise_chunked_and_statistics(scene):
    """Sensor noise depends on the absolute frame index only: one-shot and
    chunked renders are bit-identical.  Its statistics follow the sigma
    model sqrt(read^2 + shot * I): against the noise-free render, the
    normalised residual has mean 0 and variance 1 within 1 % over pixels
    away from the [0, 255] clip."""
    traj, idx, lms = scene
    tr = trender.TorchRenderer(lms, r_wall=7.0, z_cap=3.5, device="cpu")
    fr = idx[40:43]
    ev = trender.make_stress_events(traj, idx, noise_seed=4).slice(40, 43)
    one = tr.render_sequence(traj, fr, ev, chunk=3)
    parts = tr.render_sequence(traj, fr, ev, chunk=2)
    for a, b in zip(one, parts):
        assert torch.equal(a, b)
    assert not torch.equal(one[0], one[1])  # the cameras draw their own noise
    clean = tr.render_sequence(traj, fr, dataclasses.replace(ev, noise_read=None, noise_shot=None), chunk=3)
    for noisy, base in zip(one, clean):
        x, b = noisy.double(), base.double()
        keep = (b > 20) & (b < 230)
        sigma = torch.sqrt(1.5**2 + 0.04 * b)
        z = ((x - b) / sigma)[keep]
        assert z.numel() > 500_000
        assert abs(float(z.mean())) < 0.01
        assert abs(float(z.var()) - 1.0) < 0.01


def test_run_stress_gate_needs_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstress.run_stress_gate(duration=0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.TorchRenderer(np.zeros((3, 3)))


def test_run_stress_gate_short_cpu():
    """A few stress frames through run_stress_gate on the CPU with 'gain' and the
    SNR-adaptive noise: two chunks, finite poses near the ground truth, and
    no kernel launched (a CPU tensor takes the plain versions)."""
    before = dict(_cuda.launch_counts)
    out = tstress.run_stress_gate(
        duration=0.5, chunk=6, fcfg=tconfig.FrontendConfig(klt_norm="gain"),
        mcfg=tconfig.FilterConfig(ns_iters=10, noise_adaptive=True), device="cpu",
    )
    assert out.n_frames == 11
    assert np.isfinite(out.result.positions).all()
    assert out.ate_rmse < 0.05
    assert out.min_tracks_after_ransac > 20
    assert _cuda.launch_counts == before


def _imu_batch(traj, imu, i, L):
    return dict(
        time=traj.t[i] - 0.05 + np.arange(1, L + 1) * 0.005,
        gyro=imu.gyro[i - L + 1 : i + 1],
        acc=imu.acc[i - L + 1 : i + 1],
        valid=np.ones(L, bool),
    )


def test_vio_step_stress_frames_mixed(scene, monkeypatch):
    """Three stress-scene frames (exposure drift, vignette, blur and noise
    on, rendered once by the JAX renderer and given to both) through
    ``vio_step`` with klt_norm='mixed', which runs K3's plain version with
    the offset surfaces on the frame-to-frame problems and with the gain
    surfaces on the anchor.  The JAX package steps the first frame; its
    state carries into the port.  Tolerances as tests/test_torch_vio.py:
    ids and validity identical, observations within 5e-2 px, pose 1e-4 m."""
    monkeypatch.setattr(jkc, "_LOOP_MODE", "interpret")
    traj, idx, lms = scene
    FKW = dict(max_features=48, klt_norm="mixed")
    MKW = dict(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=10, ns_iters=10)
    fcfg, mcfg = jconfig.FrontendConfig(**FKW), jconfig.FilterConfig(**MKW)
    tfcfg, tmcfg = tconfig.FrontendConfig(**FKW), tconfig.FilterConfig(**MKW)
    k = np.arange(60, 64)  # u = 0.17: drift on, outside the texture-poor windows
    ev = jrender.make_stress_events(traj, idx).slice(60, 64)
    img0, img1 = jrender.JaxRenderer(lms, r_wall=7.0, z_cap=3.5).render_sequence(traj, idx[k], ev)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    L = mcfg.max_imu_per_frame
    fparams = make_frontend_params(jconfig.EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, jconfig.EUROC_CALIB, jnp.float64)
    state = init_vio_state(fcfg, mcfg, jconfig.EUROC_CALIB, img0.shape[1:], jnp.float32, jnp.float64)
    step = jax.jit(lambda s, i0, i1, t, b: vio_step(s, i0, i1, t, b, fparams, mparams, fcfg, mcfg, "schur"))

    def jstep(s, j):
        b = ImuBatch(**{n: jnp.asarray(v) for n, v in _imu_batch(traj, imu, idx[k[j]], L).items()})
        return step(s, jnp.asarray(img0[j]), jnp.asarray(img1[j]), jnp.asarray(traj.t[idx[k[j]]]), b)

    state, _ = jstep(state, 0)
    tstate, tfp, tmp = convert.vio_state_from_numpy(
        jax.device_get(state), jax.device_get(fparams), jax.device_get(mparams), device="cpu"
    )
    uv_tol = 5e-2 / jconfig.EUROC_CALIB.cam0.intrinsics[0]
    for j in (1, 2, 3):
        state, (jpose, jout) = jstep(state, j)
        b = tmsckf.ImuBatch(**{n: torch.as_tensor(v) for n, v in _imu_batch(traj, imu, idx[k[j]], L).items()})
        tstate, (tpose, tout) = tvio.vio_step(
            tstate, torch.as_tensor(img0[j]), torch.as_tensor(img1[j]),
            torch.as_tensor(traj.t[idx[k[j]]]), b, tfp, tmp, tfcfg, tmcfg, "schur",
        )
        valid = np.asarray(jout.valid)
        np.testing.assert_array_equal(tout.fid.numpy(), np.asarray(jout.fid))
        np.testing.assert_array_equal(tout.valid.numpy(), valid)
        np.testing.assert_allclose(tout.uv.numpy()[valid], np.asarray(jout.uv)[valid], rtol=0, atol=uv_tol)
        np.testing.assert_allclose(tpose.p.numpy(), np.asarray(jpose.p), rtol=0, atol=1e-4)
        for name in ("after_tracking", "after_matching", "anchor_accepted"):
            assert int(getattr(tout, name)) == int(getattr(jout, name)), name
    assert int(jout.after_ransac) > 10
    assert int(jout.anchor_accepted) > 0
