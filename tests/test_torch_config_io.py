"""The port's YAML reader and config loaders, checkpoints, phase timer and
compile-check entry point against PyYAML and the JAX package.

The reader must give exactly ``yaml.safe_load``'s result on the three
in-repo config files and on written edge cases, and raise ``ValueError``
naming the file and line on constructs outside its subset; the loaders must
give the JAX loaders' configs field for field.  Checkpoints use the JAX
package's ``.npz`` keys, so a file written by either package loads into the
other with every array equal; a run split by a save and a load equals the
uninterrupted run to 1e-12 m in float64."""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import msckf_stereo_c_tpu.config as jconfig
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.entry import entry
from msckf_stereo_c_torch.io import checkpoint as tckpt
from msckf_stereo_c_torch.io.yaml_subset import parse_yaml, read_yaml
from msckf_stereo_c_torch.models import runner as trunner
from msckf_stereo_c_torch.models import state as tstate
from msckf_stereo_c_torch.models import vio as tvio
from msckf_stereo_c_torch.utils import timing as ttiming
from msckf_stereo_c_torch.utils.lanes import map_tree
from msckf_stereo_c_tpu.io import checkpoint as jckpt
from msckf_stereo_c_tpu.models.vio import init_vio_state
from msckf_stereo_c_tpu.utils import timing as jtiming

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["app_imgproc.yaml", "app_msckfvio.yaml", "camchain-imucam-euroc.yaml"]

torch.set_num_threads(1)


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_matches_safe_load_on_repo_configs(name):
    path = os.path.join(ROOT, "config", name)
    with open(path) as f:
        assert read_yaml(path) == yaml.safe_load(f)


EDGE_CASES = [
    "eps: 1e-5",  # YAML 1.1: no dot, so a string
    "eps: 1.0e5",  # no exponent sign: a string too
    "eps: 1.76187114e-05\nb: 3.0462e-4",
    "a: -.5\nb: .5\nc: 1.\nd: +1\ne: -0\nf: 1.0E+3",
    "flag: On\nno_flag: off\ny: y\nnothing: ~\nempty:",
    "mode: none  # trailing comment\n# whole line\n\nx: 1 # another",
    "noise/gyro: 0.005\nfeature/config/translation_threshold: -1.0",
    "m: [1, 2.0,\n  -3,   4]  # spans lines\nn: []",
    "cam0:\n  T:\n    [1, 0,\n     0, 1]\n  model: pinhole\ncam1:\n  r: [752, 480]\nlast: 1",
    "inf: .inf\nminf: -.Inf",
    "",
]


@pytest.mark.parametrize("text", EDGE_CASES, ids=range(len(EDGE_CASES)))
def test_reader_matches_safe_load_on_edge_cases(text):
    assert parse_yaml(text) == yaml.safe_load(text)


UNSUPPORTED = [
    ("a: 1\n- b", 2),
    ("a: 'quoted'", 1),
    ("a: &anchor 1", 1),
    ("a: !!float 1", 1),
    ("a: {b: 1}", 1),
    ("a: |\n  text", 1),
    ("a: [1, [2]]", 1),
    ("a: [1,\n 2", 1),
    ("a: 0x1F", 1),
    ("a: 010", 1),
    ("a: 1_000", 1),
    ("a: 1\na: 2", 2),
    ("---\na: 1", 1),
    ("a:\n\tb: 1", 2),
    ("a:b", 1),
    ("a:\n  b: 1\n c: 2", 3),
    ("x: 1\non: 1", 2),
]


@pytest.mark.parametrize("text,line", UNSUPPORTED, ids=range(len(UNSUPPORTED)))
def test_reader_raises_on_unsupported(text, line):
    with pytest.raises(ValueError, match=rf"^cfg\.yaml:{line}: "):
        parse_yaml(text, "cfg.yaml")


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_loaders_match_jax_on_repo_configs():
    cam = os.path.join(ROOT, "config", "camchain-imucam-euroc.yaml")
    img = os.path.join(ROOT, "config", "app_imgproc.yaml")
    msckf = os.path.join(ROOT, "config", "app_msckfvio.yaml")
    _same(tconfig.load_camchain(cam), jconfig.load_camchain(cam))
    _same(tconfig.load_frontend_config(img), jconfig.load_frontend_config(img))
    _same(tconfig.load_filter_config(msckf), jconfig.load_filter_config(msckf))
    _same(
        tconfig.load_filter_config(msckf, tconfig.FilterConfig(ns_iters=10)),
        jconfig.load_filter_config(msckf, jconfig.FilterConfig(ns_iters=10)),
    )
    # The shipped YAMLs name no option off the defaults, and the front
    # end's loader reads no pyramid_levels: 4 levels, 7 LK launches a frame.
    assert tconfig.load_frontend_config(img) == tconfig.FrontendConfig()
    assert tconfig.load_filter_config(msckf) == tconfig.FilterConfig()


def test_loaders_match_jax_on_written_configs(tmp_path):
    """Every key each loader reads, with values off the defaults, some in
    YAML 1.1's string form of a float ('1e-5')."""
    img = tmp_path / "img.yaml"
    img.write_text(
        "grid_row: 3\ngrid_col: 6\ngrid_min_feature_num: 2\ngrid_max_feature_num: 5\n"
        "patch_size: 13\nfast_threshold: 9\nmax_iteration: 20\ntrack_precision: 1e-2\n"
        "ransac_threshold: 2.5\nstereo_threshold: 4\nklt_impl: corr\nklt_norm: gain\n"
        "temporal_levels: 2\nstereo_levels: 2\ntmpl_carry: false\ncand_budget: 0\n"
        "ransac_enabled: yes\nstereo_lr_threshold: 0.5\npresmooth: off\ncand_level1: false\n"
        "stereo_lr_survivors: false\nanchor_refine: false\ntranslation_seed: false\n"
        "matmul_precision: highest\npyramid_levels: 3\n"
    )
    msckf = tmp_path / "msckf.yaml"
    msckf.write_text(
        "frame_rate: 30\nmax_cam_state_size: 12\nposition_std_threshold: 4.0\n"
        "rotation_threshold: 0.1\ntranslation_threshold: 0.2\ntracking_rate_threshold: 0.4\n"
        "feature/config/translation_threshold: 0.1\nnoise/gyro: 1e-3\nnoise/acc: 2.0e-2\n"
        "noise/gyro_bias: 1e-5\nnoise/acc_bias: 1.0e-4\nnoise/feature: 0.05\n"
        "initial_state/velocity: [0.1, 0, -0.2]\ninitial_covariance/velocity: 0.5\n"
        "initial_covariance/gyro_bias: 1e-4\ninitial_covariance/acc_bias: 0.02\n"
        "initial_covariance/extrinsic_rotation_cov: 1e-4\n"
        "initial_covariance/extrinsic_translation_cov: 1.0e-5\nns_iters: 6\n"
        "max_update_tracks: 16\nmatmul_precision: highest\nnoise_adaptive: true\n"
        "noise_snr_ref: 30\nnoise_inflation_cap: 8\n"
    )
    t_img, j_img = tconfig.load_frontend_config(str(img)), jconfig.load_frontend_config(str(img))
    _same(t_img, j_img)
    assert t_img.pyramid_levels == 4 and not t_img.presmooth and t_img.klt_norm == "gain"
    t_f, j_f = tconfig.load_filter_config(str(msckf)), jconfig.load_filter_config(str(msckf))
    _same(t_f, j_f)
    assert t_f.noise_gyro_bias == 1e-5 and t_f.initial_velocity == (0.1, 0.0, -0.2)


def test_presmooth_warning_matches_jax(tmp_path):
    """A reference-style YAML (FAST threshold 10, no presmooth key) gets
    presmooth=False with the same warning from both loaders."""
    p = tmp_path / "ref.yaml"
    p.write_text("fast_threshold: 10\npatch_size: 15\n")
    with warnings.catch_warnings(record=True) as t_w:
        warnings.simplefilter("always")
        t_cfg = tconfig.load_frontend_config(str(p))
    with warnings.catch_warnings(record=True) as j_w:
        warnings.simplefilter("always")
        j_cfg = jconfig.load_frontend_config(str(p))
    _same(t_cfg, j_cfg)
    assert t_cfg.presmooth is False
    assert [str(w.message) for w in t_w] == [str(w.message) for w in j_w]
    assert len(t_w) == 1 and "presmooth" in str(t_w[0].message)


def test_bad_matmul_precision_raises_at_load(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("matmul_precision: fp16\n")
    for load in (tconfig.load_frontend_config, jconfig.load_frontend_config,
                 tconfig.load_filter_config, jconfig.load_filter_config):
        with pytest.raises(ValueError, match="matmul_precision"):
            load(str(p))


SMALL_F = dict(max_features=32)
SMALL_M = dict(max_cam_state_size=4, max_tracks=40, max_imu_per_frame=8)


def _random_fill(tree, seed):
    """Every float and int leaf replaced by seeded random values of its
    shape and dtype (bools flipped at random)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        if x.dtype == torch.bool:
            return torch.as_tensor(rng.random(tuple(x.shape)) < 0.5)
        if x.dtype.is_floating_point:
            return torch.as_tensor(rng.normal(size=tuple(x.shape))).to(x.dtype)
        return torch.as_tensor(rng.integers(-5, 50, size=tuple(x.shape))).to(x.dtype)

    return map_tree(fill, tree)


def _port_vio_state():
    return tvio.init_vio_state(
        tconfig.FrontendConfig(**SMALL_F), tconfig.FilterConfig(**SMALL_M), tconfig.EUROC_CALIB,
        (96, 128), torch.float32, torch.float64, "cpu",
    )


def _jax_vio_state():
    return init_vio_state(
        jconfig.FrontendConfig(**SMALL_F), jconfig.FilterConfig(**SMALL_M), jconfig.EUROC_CALIB,
        (96, 128), jnp.float32, jnp.float64,
    )


def test_checkpoint_written_by_port_loads_into_jax(tmp_path):
    state = _random_fill(_port_vio_state(), 0)
    path = str(tmp_path / "port.npz")
    tckpt.save_state(path, state)
    with np.load(path) as f:
        keys = set(f.files)
    assert {"filt/imu/q", "tracker/pts0", "pyr0_prev/0", "prev_time"} <= keys
    loaded = jckpt.load_state(path, _jax_vio_state())
    got = jax.tree.leaves(jax.device_get(loaded))
    want = jax.tree.leaves(convert.to_numpy(state))
    assert len(got) == len(want) == len(keys)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkpoint_written_by_jax_loads_into_port(tmp_path):
    jstate = jax.tree.map(jnp.asarray, convert.to_numpy(_random_fill(_port_vio_state(), 1)))
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jstate)
    loaded = tckpt.load_state(path, _port_vio_state())
    got = jax.tree.leaves(convert.to_numpy(loaded))
    want = jax.tree.leaves(jax.device_get(jstate))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkpoint_split_run_equals_uninterrupted(tmp_path):
    """tests/test_checkpoint.py's protocol on the port's filter-only runner:
    first half, save, load into a fresh template, second half."""
    from msckf_stereo_c_torch.sim import make_circle_trajectory, make_landmarks, project_tracks, synthesize_imu

    cfg = tconfig.FilterConfig(max_cam_state_size=6, max_tracks=40, max_imu_per_frame=12)
    traj = make_circle_trajectory(duration=4.0)
    feats = project_tracks(traj, make_landmarks(num=250), max_features=24, pixel_noise=0.2)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    kw = dict(method="schur", device="cpu")
    full = trunner.run_sequence(cfg, tconfig.EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
                                imu.t, imu.gyro, imu.acc, **kw)
    h = len(feats.t) // 2
    first = trunner.run_sequence(cfg, tconfig.EUROC_CALIB, feats.t[:h], feats.fid[:h], feats.uv[:h],
                                 feats.valid[:h], imu.t, imu.gyro, imu.acc, **kw)
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, first.final_state)
    restored = tckpt.load_state(path, tstate.init_filter_state(cfg, tconfig.EUROC_CALIB, torch.float64, "cpu"))
    second = trunner.run_sequence(cfg, tconfig.EUROC_CALIB, feats.t[h:], feats.fid[h:], feats.uv[h:],
                                  feats.valid[h:], imu.t, imu.gyro, imu.acc, state=restored, **kw)
    resumed = np.concatenate([first.positions, second.positions])
    np.testing.assert_allclose(resumed, full.positions, rtol=0, atol=1e-12)


def test_checkpoint_mismatch_raises(tmp_path):
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, tstate.init_filter_state(tconfig.FilterConfig(**SMALL_M), tconfig.EUROC_CALIB,
                                                    torch.float64, "cpu"))
    other = tstate.init_filter_state(tconfig.FilterConfig(max_cam_state_size=3, max_tracks=40),
                                     tconfig.EUROC_CALIB, torch.float64, "cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(path, other)
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.load_state(path, _port_vio_state())


def test_phase_timer_matches_jax():
    """Same phases, same times: the same report and overrun count."""
    reports = []
    for mod in (ttiming, jtiming):
        t = mod.PhaseTimer(frame_budget_s=0.05)
        for name, dt, n in (("decode_images", 0.25, 3), ("vio_chunk", 4.0, 3)):
            t.totals[name] += dt
            t.counts[name] += n
        for ft in (0.01, 0.06, 0.2, 0.05):
            t.frame_done(ft)
        reports.append((t.report(), t.overruns))
    assert reports[0] == reports[1]
    timer = ttiming.PhaseTimer()
    with timer.phase("x", sync="cpu"):
        pass
    assert timer.counts["x"] == 1 and timer.overruns == 0


def test_entry_matches_graft_entry_and_steps():
    """``entry(device='cpu')`` builds the JAX entry's example arguments (the
    same images, time and IMU batch, the same initial state) and its step
    gives a finite pose."""
    import __graft_entry__

    fn, args = entry(device="cpu")
    _, jargs = __graft_entry__.entry()
    want = jax.tree.leaves(jax.device_get(jargs))
    got = jax.tree.leaves(convert.to_numpy(args))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    state, (pose, front) = fn(*args)
    assert tuple(pose.p.shape) == (3,) and bool(torch.isfinite(pose.p).all())
    assert int(front.after_ransac) > 0
