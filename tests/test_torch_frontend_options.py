"""Front-end options that the YAML loaders produce, against the JAX
package's ``vio_step``: the reference's own front end (``pyramid_levels=3``
and the raw-pixel FAST threshold 10 with ``presmooth=False``, what
``load_frontend_config`` gives a YAML with ``fast_threshold >= 10`` and no
``presmooth`` key), ``cand_level1=False`` with ``cand_budget=0``, the
reference's own tracker (four pyramid levels for temporal and stereo LK,
rotation-only prediction, no template carry, anchor or left-right check,
RANSAC on, with the JAX package's ``jax.random`` draws passed to the port's
RANSAC), ``translation_seed=False`` and ``klt_impl='gather'``.

The setup and the tolerances are tests/test_torch_vio.py's (bench scene,
image float32, filter float64, Schur method with Newton-Schulz solves, the
JAX Pallas LK loop in interpret mode; feature ids and validity identical,
normalized observations within 5e-2 px divided by fx, pose within 1e-4 m),
but both packages step from the initial state, so the first frame matches
new candidates only (the coarse walk, the level-1 pass and the candidate
budget all act on it).  After three frames the last one comes again with
its time and an empty IMU batch (dt 0), as a padded frame of the batch app
does: both give the same finite pose.  The port's default front end steps
beside each option from the same state, and the option must change what the
port computes on some frame."""
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
from msckf_stereo_c_torch.models import vio as tvio
from msckf_stereo_c_torch.ops import ransac as transac
from msckf_stereo_c_tpu.models.frontend import make_frontend_params
from msckf_stereo_c_tpu.models.msckf import make_params
from msckf_stereo_c_tpu.models.propagation import ImuBatch
from msckf_stereo_c_tpu.models.vio import init_vio_state, vio_step
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_tpu.sim.render import render_stereo_sequence

torch.set_num_threads(1)

MKW = dict(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=10, ns_iters=10)
IDX = np.array([290, 300, 310])
UV_TOL = 5e-2 / jconfig.EUROC_CALIB.cam0.intrinsics[0]
OPTIONS = {
    "reference_frontend": dict(pyramid_levels=3, presmooth=False, fast_threshold=10),
    "no_level1_no_budget": dict(cand_level1=False, cand_budget=0),
    # The reference's own tracker: four levels everywhere, rotation-only
    # prediction, no template carry, anchor or left-right check, RANSAC on.
    "reference_tracker": dict(
        pyramid_levels=4, temporal_levels=4, stereo_levels=4, tmpl_carry=False, anchor_refine=False,
        translation_seed=False, stereo_lr_threshold=0.0, presmooth=False, fast_threshold=10, cand_budget=0,
        ransac_enabled=True,
    ),
    "no_translation_seed": dict(translation_seed=False),
    "gather_klt": dict(klt_impl="gather"),
}


@pytest.fixture(scope="module")
def frames():
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    img0, img1 = render_stereo_sequence(traj, lms, IDX, r_wall=8.0)
    return traj, imu, img0, img1


def _imu_batch(traj, imu, i, L, empty=False):
    return dict(
        time=traj.t[i] - 0.05 + np.arange(1, L + 1) * 0.005,
        gyro=imu.gyro[i - L + 1 : i + 1],
        acc=imu.acc[i - L + 1 : i + 1],
        valid=np.full(L, not empty),
    )


def _jax_ransac_draws(next_fid, camera, n=transac.NUM_HYPOTHESES):
    """The draws JAX's front end makes: fold_in(PRNGKey(17), next_fid), for
    camera 1 folded once more with 1, split in two, randint each."""
    rows = []
    for nf in next_fid.tolist():
        key = jax.random.fold_in(jax.random.PRNGKey(17), nf)
        if camera == 1:
            key = jax.random.fold_in(key, 1)
        rows.append([np.array(jax.random.randint(k, (n,), 0, 1 << 30)) for k in jax.random.split(key)])
    return tuple(torch.as_tensor(np.stack([r[j] for r in rows]), dtype=torch.int64) for j in (0, 1))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax_from_first_frame(frames, monkeypatch, name):
    monkeypatch.setattr(jkc, "_LOOP_MODE", "interpret")
    monkeypatch.setattr(transac, "ransac_draws", _jax_ransac_draws)
    traj, imu, img0, img1 = frames
    kw = dict(max_features=48, **OPTIONS[name])
    fcfg, mcfg = jconfig.FrontendConfig(**kw), jconfig.FilterConfig(**MKW)
    tfcfg, tmcfg = tconfig.FrontendConfig(**kw), tconfig.FilterConfig(**MKW)
    L = mcfg.max_imu_per_frame

    fparams = make_frontend_params(jconfig.EUROC_CALIB, jnp.float32)
    mparams = make_params(mcfg, jconfig.EUROC_CALIB, jnp.float64)
    state = init_vio_state(fcfg, mcfg, jconfig.EUROC_CALIB, img0.shape[1:], jnp.float32, jnp.float64)
    tstate, tfp, tmp = convert.vio_state_from_numpy(
        jax.device_get(state), jax.device_get(fparams), jax.device_get(mparams), device="cpu"
    )
    step = jax.jit(lambda s, i0, i1, t, b: vio_step(s, i0, i1, t, b, fparams, mparams, fcfg, mcfg, "schur"))

    default = dataclasses.replace(tfcfg, **{k: getattr(tconfig.FrontendConfig(), k) for k in OPTIONS[name]})
    dstate, differs = tstate, False

    for k, empty in ((0, False), (1, False), (2, False), (2, True)):
        b = _imu_batch(traj, imu, IDX[k], L, empty)
        t = traj.t[IDX[k]]
        state, (jpose, jout) = step(
            state, jnp.asarray(img0[k]), jnp.asarray(img1[k]), jnp.asarray(t),
            ImuBatch(**{n: jnp.asarray(v) for n, v in b.items()}),
        )
        tstate, (tpose, tout) = tvio.vio_step(
            tstate, torch.as_tensor(img0[k]), torch.as_tensor(img1[k]), torch.as_tensor(t),
            tvio.ImuBatch(**{n: torch.as_tensor(v) for n, v in b.items()}), tfp, tmp, tfcfg, tmcfg, "schur",
        )
        dstate, (_, dout) = tvio.vio_step(
            dstate, torch.as_tensor(img0[k]), torch.as_tensor(img1[k]), torch.as_tensor(t),
            tvio.ImuBatch(**{n: torch.as_tensor(v) for n, v in b.items()}), tfp, tmp, default, tmcfg, "schur",
        )
        differs |= not (np.array_equal(tout.valid.numpy(), dout.valid.numpy())
                        and np.allclose(tout.uv.numpy(), dout.uv.numpy(), rtol=0, atol=1e-9))
        valid = np.asarray(jout.valid)
        np.testing.assert_array_equal(tout.fid.numpy(), np.asarray(jout.fid))
        np.testing.assert_array_equal(tout.valid.numpy(), valid)
        np.testing.assert_allclose(tout.uv.numpy()[valid], np.asarray(jout.uv)[valid], rtol=0, atol=UV_TOL)
        assert np.isfinite(np.asarray(jpose.p)).all()
        np.testing.assert_allclose(tpose.p.numpy(), np.asarray(jpose.p), rtol=0, atol=1e-4)
        assert int(tpose.num_cams) == int(jpose.num_cams)
        for field in ("after_tracking", "after_matching", "anchor_accepted", "after_ransac"):
            assert int(getattr(tout, field)) == int(getattr(jout, field)), field
        if k == 0:
            assert len(tstate.pyr0_prev) == tfcfg.pyramid_levels
            assert int(jout.after_ransac) > 10
    # The option changes what the port computes (the default front end
    # stepped beside it from the same state).
    assert differs, name
