"""``chip_smoke.py:launches_per_frame`` against the kernel-wrapper calls one
``frontend_step`` makes on the CPU under each configuration the card checks
(every call with features counts as the launch it makes on the card);
``feature_lifetime_statistics`` against the JAX package's on a stepped
tracker state (equal dicts); and the EuRoC app with a YAML that sets the
options this slice ported (``temporal_levels: 2``, ``ransac_enabled:
true``, ``klt_impl: gather``): ``run_euroc --device cpu`` on six frames
gives ``run_vio_sequence``'s poses under the loaded config (1e-9 m, filter
in float64), and the loaded config carries the three keys."""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import msckf_stereo_c_tpu.models.frontend as jfe
from _torch_frontend_scene import CALIB, IDX, frame_inputs, make_scene
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.apps import run_euroc
from msckf_stereo_c_torch.io import euroc as teuroc
from msckf_stereo_c_torch.models import frontend as tfe
from msckf_stereo_c_torch.models.vio import run_vio_sequence
from msckf_stereo_c_torch.ops import klt_corr as tkc
from msckf_stereo_c_torch.sim.euroc_dataset import to_uint8, write_euroc
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_tpu.sim.render import render_stereo_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(ROOT, "config", f) for name, f in (
    ("--camchain", "camchain-imucam-euroc.yaml"), ("--msckf-config", "app_msckfvio.yaml"))}
NEW_KEYS = "temporal_levels: 2\nransac_enabled: true\nklt_impl: gather\n"

torch.set_num_threads(1)

LAUNCH_CONFIGS = {
    "bench": dict(),
    "fast_motion_tl2": dict(temporal_levels=2),
    "fast_motion_tl4": dict(temporal_levels=4),
    "reference_tracker": chip_smoke.REFERENCE_TRACKER,
    **{f"path_{i}": kw for i, kw in enumerate(chip_smoke.BENCH_PATHS.values())},
    "anchor_gain": dict(klt_norm="anchor_gain"),
    "mixed": dict(klt_norm="mixed"),
    "three_levels": dict(pyramid_levels=3),
    "stereo_levels_2": dict(stereo_levels=2),
    "no_level1": dict(cand_level1=False),
}
KERNELS = ("lk_corr_align", "lk_corr_align_gain", "extract_template", "resample_template")


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.mark.parametrize("name", list(LAUNCH_CONFIGS))
def test_launches_per_frame_counts_the_wrapper_calls(scene, monkeypatch, name):
    traj, imu, img0, img1 = scene
    calls = dict.fromkeys(chip_smoke.KERNEL_SOURCES, 0)
    for kernel in KERNELS:
        def counted(*args, _fn=getattr(tkc, kernel), _name=kernel, **kwargs):
            out = _fn(*args, **kwargs)
            calls[_name] += int(out.shape[0] > 0)
            return out

        monkeypatch.setattr(tkc, kernel, counted)
    cfg = tconfig.FrontendConfig(max_features=48, **LAUNCH_CONFIGS[name])
    p0, p1 = tfe.pyramids_for(torch.as_tensor(img0[0]), cfg), tfe.pyramids_for(torch.as_tensor(img1[0]), cfg)
    g, dt, first, v = (torch.as_tensor(np.asarray(x)) for x in frame_inputs(traj, imu, IDX, 0))
    tfe.frontend_step(tfe.init_tracker_state(cfg), p0, p0, p1, g, dt, first, tfe.make_frontend_params(CALIB), cfg,
                      v if cfg.translation_seed else None)
    assert calls == chip_smoke.launches_per_frame(cfg, img0.shape[1:])


def test_feature_lifetime_statistics_matches_jax(scene):
    traj, imu, img0, img1 = scene
    cfg = tconfig.FrontendConfig(max_features=48)
    params = tfe.make_frontend_params(CALIB)
    state = tfe.init_tracker_state(cfg)
    assert tfe.feature_lifetime_statistics(state) == jfe.feature_lifetime_statistics(convert.to_numpy(state))
    pyr_prev = None
    for k in range(3):
        p0, p1 = tfe.pyramids_for(torch.as_tensor(img0[k]), cfg), tfe.pyramids_for(torch.as_tensor(img1[k]), cfg)
        pyr_prev = pyr_prev or tuple(torch.zeros_like(x) for x in p0)
        g, dt, first, v = (torch.as_tensor(np.asarray(x)) for x in frame_inputs(traj, imu, IDX, k))
        state, _ = tfe.frontend_step(state, pyr_prev, p0, p1, g, dt, first, params, cfg, v)
        pyr_prev = p0
    got = tfe.feature_lifetime_statistics(state)
    assert got == jfe.feature_lifetime_statistics(convert.to_numpy(state))
    assert got["count"] > 20 and got["max"] == 3 and len(got["histogram"]) == 4


def test_app_runs_a_yaml_with_the_new_keys(tmp_path):
    traj = make_circle_trajectory(duration=4.0)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    idx = 250 + 10 * np.arange(6)
    img0, img1 = render_stereo_sequence(traj, make_wall_landmarks(num=400, radius=8.0, seed=1), idx, r_wall=8.0)
    mav0 = write_euroc(str(tmp_path / "seq"), traj.t[idx], to_uint8(img0), to_uint8(img1), imu.t, imu.gyro,
                       imu.acc, traj.p[idx])
    yaml = tmp_path / "imgproc.yaml"
    with open(os.path.join(ROOT, "config", "app_imgproc.yaml")) as f:
        yaml.write_text(f.read() + NEW_KEYS)
    fcfg = tconfig.load_frontend_config(str(yaml))
    assert (fcfg.temporal_levels, fcfg.ransac_enabled, fcfg.klt_impl) == (2, True, "gather")

    res = run_euroc.main([mav0, "--device", "cpu", "--f64", "--chunk", "4", "--imgproc-config", str(yaml),
                          "--out", str(tmp_path / "pose.txt")] + [x for kv in CFG.items() for x in kv])
    seq = teuroc.load_sequence(mav0)
    times, f0, f1 = teuroc.synchronize_stereo(seq)
    t_base = min(times[0], seq.imu.t[0])
    direct = run_vio_sequence(
        fcfg, tconfig.load_filter_config(CFG["--msckf-config"]), tconfig.load_camchain(CFG["--camchain"]),
        times - t_base, teuroc.load_images(f0), teuroc.load_images(f1), seq.imu.t - t_base,
        seq.imu.gyro, seq.imu.acc, filter_dtype=torch.float64, method="schur", device="cpu",
    )
    assert res.positions.shape == (6, 3) and np.isfinite(res.positions).all()
    np.testing.assert_allclose(res.positions, direct.positions, rtol=0, atol=1e-9)
    assert direct.tracking["after_ransac"][1:].min() > 10
