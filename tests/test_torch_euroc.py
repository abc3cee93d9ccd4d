"""The port's EuRoC reader, PNG decoders, image source and dataset apps on
the CPU, against the JAX package, OpenCV and the port's own direct runs.

The dataset is tests/test_euroc_io.py's fake_euroc layout, cut to 12 frames
from the circle trajectory's spin-up (IMU sample 250 on) and written with
OpenCV (libpng's adaptive row filters).  The reader must equal the JAX
reader exactly; both decoders (the native runtime built from
``native/euroc_runtime.cpp``, and ``io/png.py``) must equal
``cv2.imread(..., IMREAD_GRAYSCALE)`` bit for bit, on that dataset and on
PNGs written with each of the five row filters.  The app's poses must equal
``run_vio_sequence`` on the decoded frames to 1e-9 m with the filter in
float64; each lane of the batch app must equal that sequence run alone by
the batch app (to 1e-9 m; the lanes take the same arithmetic)."""
import os

import cv2
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.io.euroc as jeuroc
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch.apps import run_euroc, run_euroc_batch
from msckf_stereo_c_torch.io import euroc as teuroc
from msckf_stereo_c_torch.io import native, png
from msckf_stereo_c_torch.io.tum import read_tum
from msckf_stereo_c_torch.models.vio import run_vio_sequence
from msckf_stereo_c_torch.sim.euroc_dataset import EUROC_EPOCH_NS, to_uint8, write_euroc
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_tpu.sim.render import render_stereo_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {name: os.path.join(ROOT, "config", f) for name, f in (
    ("--camchain", "camchain-imucam-euroc.yaml"), ("--imgproc-config", "app_imgproc.yaml"),
    ("--msckf-config", "app_msckfvio.yaml"))}
N_FRAMES = 12

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    traj = make_circle_trajectory(duration=4.0)
    landmarks = make_wall_landmarks(num=400, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    idx = 250 + 10 * np.arange(N_FRAMES)
    img0, img1 = render_stereo_sequence(traj, landmarks, idx, r_wall=8.0)
    return traj, imu, idx, to_uint8(img0), to_uint8(img1)


@pytest.fixture(scope="module")
def dataset(scene, tmp_path_factory):
    """fake_euroc's layout, written by the port's ``write_euroc``, its PNGs
    then rewritten by OpenCV."""
    traj, imu, idx, img0, img1 = scene
    root = tmp_path_factory.mktemp("euroc")
    mav0 = write_euroc(str(root / "seq"), traj.t[idx], img0, img1, imu.t, imu.gyro, imu.acc, traj.p[idx])
    for cam, imgs in (("cam0", img0), ("cam1", img1)):
        names = sorted(os.listdir(os.path.join(mav0, cam, "data")))
        for name, img in zip(names, imgs):
            assert cv2.imwrite(os.path.join(mav0, cam, "data", name), img)
    return mav0


def test_load_sequence_and_sync_match_jax(dataset):
    t, j = teuroc.load_sequence(dataset), jeuroc.load_sequence(dataset)
    for a, b in ((t.imu.t, j.imu.t), (t.imu.gyro, j.imu.gyro), (t.imu.acc, j.imu.acc),
                 (t.cam0.t, j.cam0.t), (t.cam1.t, j.cam1.t), (t.gt.t, j.gt.t), (t.gt.p, j.gt.p),
                 (t.gt.q_wxyz, j.gt.q_wxyz)):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    assert t.cam0.files == j.cam0.files and t.cam1.files == j.cam1.files
    times, f0, f1 = teuroc.synchronize_stereo(t)
    jtimes, jf0, jf1 = jeuroc.synchronize_stereo(j)
    np.testing.assert_array_equal(times, jtimes)
    assert (f0, f1) == (jf0, jf1) and len(times) == N_FRAMES
    assert abs(times[0] - (EUROC_EPOCH_NS * 1e-9 + 1.25)) < 1e-6


def test_synchronize_unsynced_stereo_matches_jax():
    """cam1 late by up to 6 ms (some beyond the 4 ms window), one cam1
    frame missing, one extra."""
    rng = np.random.default_rng(3)
    t0 = 1403636579.0 + 0.05 * np.arange(20)
    t1 = np.sort(np.delete(t0 + rng.uniform(-0.006, 0.006, 20), 7).tolist() + [t0[12] + 0.025])
    seqs = []
    for mod in (teuroc, jeuroc):
        cams = [mod.EurocCamIndex(t=t, files=[f"{c}/{k}.png" for k in range(len(t))])
                for c, t in (("c0", t0), ("c1", t1))]
        seqs.append(mod.EurocSequence(cam0=cams[0], cam1=cams[1], imu=None, gt=None))
    times, f0, f1 = teuroc.synchronize_stereo(seqs[0])
    jtimes, jf0, jf1 = jeuroc.synchronize_stereo(seqs[1])
    np.testing.assert_array_equal(times, jtimes)
    assert (f0, f1) == (jf0, jf1)
    assert 0 < len(times) < 20


def _native():
    if not native.available():
        pytest.fail(f"the native runtime did not build here: {native.build_error()}")
    return native


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1)],
                         ids=["none", "sub", "up", "average", "paeth", "all5", "mixed"])
def test_decoders_equal_cv2_on_each_filter(scene, tmp_path, filters):
    img = scene[3][5]
    noise = np.random.default_rng(len(filters)).integers(0, 256, (23, 41), dtype=np.uint8)
    for k, im in enumerate((img, noise)):
        path = str(tmp_path / f"{k}.png")
        png.encode_png(path, im, filters)
        ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(ref, im)
        np.testing.assert_array_equal(png.decode_png(path), ref)
        np.testing.assert_array_equal(_native().decode_png(path, 752, 480), ref)


def test_decoders_equal_cv2_on_dataset(dataset):
    _, files0, files1 = teuroc.synchronize_stereo(teuroc.load_sequence(dataset))
    files = files0 + files1
    ref = np.stack([cv2.imread(f, cv2.IMREAD_GRAYSCALE) for f in files])
    assert len(files) > png.SWEEP_IMAGES  # two sweeps
    np.testing.assert_array_equal(png.decode_pngs(files), ref)
    np.testing.assert_array_equal(np.stack([_native().decode_png(f, 752, 480) for f in files]), ref)


def test_zlib_decoder_rejects_other_formats(tmp_path):
    p16 = str(tmp_path / "deep.png")
    assert cv2.imwrite(p16, np.arange(12 * 10, dtype=np.uint16).reshape(12, 10) * 500)
    with pytest.raises(ValueError, match=r"deep\.png: bit depth 16"):
        png.decode_png(p16)
    rgb = str(tmp_path / "rgb.png")
    assert cv2.imwrite(rgb, np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError, match=r"rgb\.png: .*color type 2"):
        png.decode_png(rgb)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match=r"bad\.png: not a PNG"):
        png.decode_png(bad)


@pytest.mark.parametrize("backend", ["native", "zlib"])
def test_image_source_chunks(dataset, monkeypatch, backend):
    """Chunked reads across boundaries equal OpenCV's pixels, the last
    chunk short, with the backend named."""
    _, files0, _ = teuroc.synchronize_stereo(teuroc.load_sequence(dataset))
    if backend == "zlib":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        _native()
    ref = np.stack([cv2.imread(f, cv2.IMREAD_GRAYSCALE) for f in files0]).astype(np.float32)
    with teuroc.ImageSource(files0, prefetch=4) as src:
        assert src.backend == backend
        parts = [src.next(5) for _ in range(3)]
        assert src.next(5).shape == (0, 480, 752)
    assert [p.shape[0] for p in parts] == [5, 5, 2]
    np.testing.assert_array_equal(np.concatenate(parts), ref)
    np.testing.assert_array_equal(teuroc.load_images(files0[:3]), ref[:3])


def test_native_imu_csv_matches_reader(dataset):
    t, gyro, acc = _native().load_imu_csv(os.path.join(dataset, "imu0", "data.csv"))
    seq = teuroc.load_sequence(dataset)
    np.testing.assert_array_equal(t, seq.imu.t)
    np.testing.assert_array_equal(gyro, seq.imu.gyro)
    np.testing.assert_array_equal(acc, seq.imu.acc)


def test_app_equals_direct_run(dataset, tmp_path):
    """``run_euroc.main`` on the CPU with the in-repo YAMLs, the filter in
    float64 and chunks of 5 frames: its TUM file and poses against
    ``run_vio_sequence`` over the decoded frames in one call."""
    out = str(tmp_path / "pose.txt")
    argv = [dataset, "--device", "cpu", "--f64", "--chunk", "5", "--ate", "--out", out,
            "--debug-dump", str(tmp_path / "dbg.txt"), "--cov-out", str(tmp_path / "cov.txt"),
            "--dump-filter-frame", "7", "--dump-filter-out", str(tmp_path / "filt.npz")]
    res = run_euroc.main(argv + [x for kv in CFG.items() for x in kv])
    seq = teuroc.load_sequence(dataset)
    times, f0, f1 = teuroc.synchronize_stereo(seq)
    t_base = min(times[0], seq.imu.t[0])
    direct = run_vio_sequence(
        tconfig.load_frontend_config(CFG["--imgproc-config"]),
        tconfig.load_filter_config(CFG["--msckf-config"]), tconfig.load_camchain(CFG["--camchain"]),
        times - t_base, teuroc.load_images(f0), teuroc.load_images(f1), seq.imu.t - t_base,
        seq.imu.gyro, seq.imu.acc, filter_dtype=torch.float64, method="schur", device="cpu",
    )
    np.testing.assert_allclose(res.positions, direct.positions, rtol=0, atol=1e-9)
    assert res.backend == "native"
    tum_t, tum_p, _ = read_tum(out)
    assert tum_t.shape == (N_FRAMES,)
    np.testing.assert_allclose(tum_t, times, rtol=0, atol=2e-6)  # epoch seconds, 6 decimals
    np.testing.assert_allclose(tum_p, res.positions, rtol=0, atol=1e-6)
    assert res.ate.num_pairs == N_FRAMES and res.ate.rmse < 0.13
    for name in ("dbg.txt", "cov.txt"):
        with open(tmp_path / name) as f:
            assert len(f.read().splitlines()) == N_FRAMES + 1
    assert res.timer.counts["decode_images"] == res.timer.counts["vio_chunk"] == 3
    with np.load(tmp_path / "filt.npz") as dump:
        assert {"H_o", "r_o", "gamma_schur", "frontend_fid"} <= set(dump.files)


def test_apps_need_cuda_unless_cpu_is_asked(dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_euroc.main([dataset])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_euroc_batch.main([dataset])


def test_batch_app_lanes_equal_their_one_lane_runs(scene, dataset, tmp_path):
    """Two sequences of 12 and 8 frames as lanes: the shorter one is padded
    with its last frame and the padding masked out; each lane equals the
    sequence run alone."""
    traj, imu, idx, img0, img1 = scene
    seq8 = write_euroc(str(tmp_path / "short"), traj.t[idx[:8]], img0[:8], img1[:8], imu.t, imu.gyro, imu.acc,
                       traj.p[idx[:8]])
    kw = ["--device", "cpu", "--chunk", "5", "--ate"]
    lanes = run_euroc_batch.main([dataset, seq8, "--out-dir", str(tmp_path / "both")] + kw)
    assert [len(r.times) for r in lanes] == [N_FRAMES, 8]
    for path, lane in zip((dataset, seq8), lanes):
        alone = run_euroc_batch.main([path, "--out-dir", str(tmp_path / "alone")] + kw)[0]
        assert np.isfinite(lane.positions).all()
        np.testing.assert_array_equal(lane.times, alone.times)
        np.testing.assert_allclose(lane.positions, alone.positions, rtol=0, atol=1e-9)
        assert lane.ate.rmse < 0.13
        tum_t, tum_p, _ = read_tum(lane.out)
        assert tum_t.shape == (len(lane.times),)
