"""msckf_vio's image processor in the port (``euroc-v101-msckfvio``'s
tracker) against its plain reference,
``msckf_stereo_c_torch/reference/image_processor.py``:

- ``ops/ransac.py:two_point_ransac`` and ``ransac_draws`` against the
  reference's step-by-step RANSAC and its integer hash, on three seeded
  lanes (a translation with injected outliers, a camera that only rotates,
  a lane with two raw inliers): the draws equal; the masks equal in float64,
  and in float32 equal but for points whose tested value lies within a
  relative 1e-5 of the threshold (float32 rounding of the scaled points
  decides those);
- the untemplated level loop (``ops/klt_corr.py:optical_flow_pyr_lk_corr``
  at 4 levels, two lanes folded into one feature axis) against the
  reference's per-lane level loop given the port's one-level solve
  (``_track_level_corr``, the plain ``lk_corr_align_reference`` on the
  CPU), from the temporal (gyro rotation) and the stereo (extrinsic
  rotation) guesses, on a 376x240 pyramid whose level 3 (47x30) still
  holds a 15-pixel window: points within 1e-4 px, validity equal; the
  guesses themselves within 1e-3 px of the reference's;
- the ``frontend.ransac`` span opens under a profiler, and
  ``ransac_work_log`` gains one (B,) int32 entry a call, the matches the
  call rejected, only while one records."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msckf_stereo_c_torch.config import EUROC_CALIB, FrontendConfig
from msckf_stereo_c_torch.models import frontend as tfe
from msckf_stereo_c_torch.ops import camera as tcam
from msckf_stereo_c_torch.ops import ransac as transac
from msckf_stereo_c_torch.ops.klt_corr import _track_level_corr, optical_flow_pyr_lk_corr
from msckf_stereo_c_torch.ops.pyramid import build_pyramid
from msckf_stereo_c_torch.reference import image_processor as ref
from msckf_stereo_c_torch.utils.lanes import lane_index
from msckf_stereo_c_torch.utils.lie import so3_exp

torch.set_num_threads(1)

K0 = np.asarray(EUROC_CALIB.cam0.intrinsics, np.float64)
D0 = np.asarray(EUROC_CALIB.cam0.distortion_coeffs, np.float64)
K1 = np.asarray(EUROC_CALIB.cam1.intrinsics, np.float64)
D1 = np.asarray(EUROC_CALIB.cam1.distortion_coeffs, np.float64)
R01 = EUROC_CALIB.T_cam0_cam1_mat()[:3, :3]
N = 40
NEXT_FID = (7, 1234, 2**31 - 5)
RANSAC_RTOL = 1e-5  # float32's 6e-8 rounding, grown through undistortion, scaling and the 3-term rows
WIN, ITERS, EPS = 15, 30, 0.01


def _project(X):
    """Pixels of camera-frame points (n, 3) under cam0's radtan model, in
    float64."""
    uv = torch.as_tensor(X[:, :2] / X[:, 2:])
    return tcam.distort_points(uv, torch.as_tensor(K0), torch.as_tensor(D0)).numpy()


def _rotation(rng, scale):
    return so3_exp(torch.as_tensor(rng.normal(size=3) * scale)).numpy()


def _ransac_case(seed=3):
    """Three lanes of N matches (previous, current pixels), validity and the
    rotation previous -> current camera, and lane 0's injected outliers:
    lane 0 a translation (0.1, 0.02, 0.05) m with 6 matches moved 8-25 px
    and 4 slots invalid; lane 1 a rotation only, 0.05 px noise, 5 matches
    beyond the 50-unit gate; lane 2 five valid slots, three beyond it."""
    rng = np.random.default_rng(seed)
    pts1, pts2, valid, R, outliers = [], [], [], [], None
    for lane in range(3):
        X1 = rng.uniform(-1.5, 1.5, (N, 3)) + np.array([0.0, 0.0, 4.0])
        Rl = _rotation(rng, 0.02)
        t = np.array([0.1, 0.02, 0.05]) if lane == 0 else np.zeros(3)
        u1, u2 = _project(X1), _project(X1 @ Rl.T + t)
        v = np.ones(N, bool)
        if lane == 0:
            outliers = rng.choice(N, 6, replace=False)
            u2[outliers] += rng.uniform(8, 25, (6, 2)) * np.sign(rng.normal(size=(6, 2)))
            v[rng.choice(np.setdiff1d(np.arange(N), outliers), 4, replace=False)] = False
        elif lane == 1:
            u2 += rng.normal(0, 0.05, u2.shape)
            u2[:5] += 300.0
        else:
            v[5:] = False
            u2[:3] += 300.0
        pts1.append(u1)
        pts2.append(u2)
        valid.append(v)
        R.append(Rl)
    return np.stack(pts1), np.stack(pts2), np.stack(valid), np.stack(R), outliers


def _ransac_args(dtype, camera=0):
    """The port's ``two_point_ransac`` arguments of the three lanes, its
    draws included, and the lanes' validity and lane 0's outliers."""
    pts1, pts2, valid, R, outliers = _ransac_case()
    t = dict(dtype=dtype)
    args = (torch.as_tensor(pts1, **t), torch.as_tensor(pts2, **t), torch.as_tensor(valid),
            torch.as_tensor(R, **t), torch.as_tensor(K0, **t), torch.as_tensor(D0, **t))
    return args + transac.ransac_draws(torch.tensor(NEXT_FID, dtype=torch.int32), camera), valid, outliers


def _both_ransac(dtype, camera=0):
    args, valid, outliers = _ransac_args(dtype, camera)
    got = transac.two_point_ransac(*args)
    steps = []
    want = ref.two_point_ransac(*args[:6], torch.tensor(NEXT_FID), camera, steps=steps)
    return got, want, steps, valid, outliers


@pytest.mark.parametrize("camera", [0, 1])
def test_the_draws_are_the_references_hash(camera):
    got1, got2 = transac.ransac_draws(torch.tensor(NEXT_FID, dtype=torch.int32), camera)
    for b, fid in enumerate(NEXT_FID):
        want1, want2 = ref.ransac_draws(fid, camera)
        assert got1[b].tolist() == want1 and got2[b].tolist() == want2


def test_ransac_float64_masks_equal_the_reference():
    got, want, steps, valid, outliers = _both_ransac(torch.float64)
    assert [s["branch"] for s in steps] == ["hypotheses", "degenerate", "too few"]
    assert torch.equal(got, want)
    assert not bool(got[0, outliers].any()) and int(got[0].sum()) >= 0.8 * (int(valid[0].sum()) - len(outliers))
    assert not bool(got[1, :5].any()) and bool(got[1, 5:].all())
    assert not bool(got[2].any())


@pytest.mark.parametrize("camera", [0, 1])
def test_ransac_float32_masks_equal_the_reference_off_the_threshold(camera):
    """Every point where the two masks differ has its tested value (error
    under the winning model, or motion on the no-translation branch) within
    a relative ``RANSAC_RTOL`` of the threshold."""
    got, want, steps, _, _ = _both_ransac(torch.float32, camera)
    for b in range(got.shape[0]):
        for i in torch.nonzero(got[b] != want[b]).flatten().tolist():
            value, thr = steps[b]["value"][i], steps[b]["threshold"]
            assert value is not None and abs(float(value) - float(thr)) <= RANSAC_RTOL * float(thr), (b, i)
    assert int((got != want).sum()) <= 1


def _texture(B, H, W, shift, seed):
    """(B, H, W) float32 crops of one smoothed noise field (Gaussian blur,
    sigma 3 px, so the 1/8 level keeps texture), lane b's crop moved by
    the whole-pixel ``shift[b]`` (dx, dy): the scene translated exactly,
    with no resampling."""
    m = 40
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((1, 1, H + 2 * m, W + 2 * m), generator=g, dtype=torch.float64)
    k = torch.exp(-0.5 * (torch.arange(-9, 10, dtype=torch.float64) / 3.0) ** 2)
    k = k / k.sum()
    field = torch.nn.functional.conv2d(noise, k.view(1, 1, 1, -1), padding=(0, 9))
    field = torch.nn.functional.conv2d(field, k.view(1, 1, -1, 1), padding=(9, 0))[0, 0]
    field = 128.0 + 60.0 * field / field.std()
    return torch.stack([field[m - dy:m - dy + H, m - dx:m - dx + W] for dx, dy in shift]).float()


def _solve(img_prev, img_curr, pts_prev, start, final):
    return _track_level_corr(img_prev, img_curr, pts_prev, start, WIN, ITERS, EPS, final)


def _level_loops(pyr_prev, pyr_curr, pts_prev, guess, valid):
    B, n = valid.shape
    res = optical_flow_pyr_lk_corr(pyr_prev, pyr_curr, pts_prev.reshape(B * n, 2), guess.reshape(B * n, 2),
                                   valid.reshape(B * n), win=WIN, iters=ITERS, eps=EPS,
                                   img_index=lane_index(B, n, "cpu"))
    want_pts, want_ok = ref.pyramid_lk(_solve, pyr_prev, pyr_curr, pts_prev, guess, valid)
    return res.pts.reshape(B, n, 2), res.valid.reshape(B, n), want_pts, want_ok


PT_TOL = 1e-4  # px: the same solve on the same windows; lanes folded into one call only reorder the launches
GUESS_TOL = 1e-3  # px: a few float32 ulps (6.1e-5 px) of a 752-px coordinate, the products summed in another order


def _points(rng, B, n, H, W, m=64):
    """Points at least ``m`` px inside: level 3's 15-px template (120 px at
    level 0) then lies mostly inside the image."""
    pts = torch.as_tensor(np.stack([rng.uniform([m, m], [W - m, H - m], (n, 2)) for _ in range(B)]),
                          dtype=torch.float32)
    valid = torch.as_tensor(rng.random((B, n)) > 0.15)
    return pts, valid


def test_temporal_level_loop_from_the_gyro_guess():
    B, n, H, W = 2, 24, 240, 376
    rng = np.random.default_rng(5)
    shift = [(6, -4), (-9, 3)]
    pyr_prev = build_pyramid(_texture(B, H, W, [(0, 0)] * B, 11), 4)
    pyr_curr = build_pyramid(_texture(B, H, W, shift, 11), 4)
    assert tuple(pyr_prev[3].shape[-2:]) == (30, 47)
    pts, valid = _points(rng, B, n, H, W)
    K = torch.as_tensor(K0, dtype=torch.float32)
    R = torch.as_tensor(np.stack([_rotation(rng, 0.004) for _ in range(B)]), dtype=torch.float32)
    guess = tfe._rotation_warp(pts, K, R)
    assert float((guess - ref.temporal_guess(pts, K, R)).abs().max()) <= GUESS_TOL
    got_pts, got_ok, want_pts, want_ok = _level_loops(pyr_prev, pyr_curr, pts, guess, valid)
    assert torch.equal(got_ok, want_ok) and int(got_ok.sum()) >= n
    assert float((got_pts - want_pts).abs().max()) <= PT_TOL
    moved = got_pts - pts
    truth = torch.as_tensor(shift, dtype=torch.float32)[:, None, :]
    assert float((moved - truth)[got_ok].abs().max()) < 0.1  # it tracks the scene, not only the reference


def test_stereo_level_loop_from_the_extrinsic_guess():
    B, n, H, W = 2, 24, 240, 376
    rng = np.random.default_rng(8)
    left = _texture(B, H, W, [(0, 0)] * B, 13)
    right = _texture(B, H, W, [(-11, 0), (-8, 1)], 13)
    pts, valid = _points(rng, B, n, H, W)
    t = dict(dtype=torch.float32)
    k0, d0, k1, d1 = (torch.as_tensor(a, **t) for a in (K0, D0, K1, D1))
    r01 = torch.as_tensor(R01, **t)
    guess = tcam.distort_points(tcam.undistort_points(pts, k0, d0, R=r01), k1, d1)
    assert float((guess - ref.stereo_guess(pts, k0, d0, k1, d1, r01)).abs().max()) <= GUESS_TOL
    got_pts, got_ok, want_pts, want_ok = _level_loops(build_pyramid(left, 4), build_pyramid(right, 4), pts, guess, valid)
    assert torch.equal(got_ok, want_ok) and int(got_ok.sum()) >= n
    assert float((got_pts - want_pts).abs().max()) <= PT_TOL


def test_ransac_logs_its_rejections_only_under_a_profiler():
    args, valid, _ = _ransac_args(torch.float32)
    log = transac.ransac_work_log
    log.clear()
    plain = transac.two_point_ransac(*args)
    assert len(log) == 0
    with profile(activities=[ProfilerActivity.CPU]):
        traced = transac.two_point_ransac(*args)
    assert torch.equal(traced, plain) and len(log) == 1
    rejected = (torch.as_tensor(valid) & ~plain).sum(-1).int()
    assert log[0].dtype == torch.int32 and torch.equal(log[0], rejected) and int(rejected.sum()) > 0


def test_frontend_ransac_span_opens_under_a_profiler():
    """Two frames of the msckf_vio tracker (4 levels, no carried template,
    RANSAC on) on two lanes: unprofiled, no span and no log entry; profiled,
    one ``frontend.ransac`` span and two log entries (one a camera) a frame,
    and the same tracks."""
    import json
    from pathlib import Path

    config = json.loads((Path(__file__).resolve().parents[1] / "bench_vio/configs/euroc-v101-msckfvio.json").read_text())
    cfg = FrontendConfig(**config["frontend"])
    assert cfg.ransac_enabled and cfg.temporal_levels == 4 and not cfg.tmpl_carry
    B, H, W = 2, 160, 256  # level 3 (20x32) still holds a 19-px template window
    params = tfe.make_frontend_params(EUROC_CALIB, torch.float32, "cpu")
    frames = [_texture(B, H, W, [(s, s // 2)] * B, 17) for s in (0, 2, 4)]
    right = [_texture(B, H, W, [(s - 9, s // 2)] * B, 17) for s in (0, 2, 4)]

    def run():
        st = tfe.init_tracker_state(cfg, torch.float32, "cpu")
        st = st._replace(**{k: v.expand(B, *v.shape).clone() for k, v in st._asdict().items()})
        outs = []
        for k in range(1, 3):
            pyr = [tfe.pyramids_for(x, cfg) for x in (frames[k - 1], frames[k], right[k])]
            st, out = tfe.batched_frontend_step(st, *pyr, torch.zeros(B, 3), torch.full((B,), 0.05),
                                                torch.tensor([k == 1] * B), params, cfg)
            outs.append(out)
        return outs

    log = transac.ransac_work_log
    log.clear()
    plain = run()
    assert len(log) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run()
    assert sum(e.name == "frontend.ransac" for e in prof.events()) == 2
    assert len(log) == 4 and all(x.shape == (B,) and x.dtype == torch.int32 for x in log)
    for a, b in zip(plain, traced):
        assert torch.equal(a.fid, b.fid) and torch.equal(a.valid, b.valid) and torch.equal(a.uv, b.uv)
