"""msckf_vio's image processor and the clean live camera: the configuration
``euroc-v101-msckfvio``, the cells ``v101-msckfvio.eval.b512`` and
``v101.live.b1`` and the two RANSAC metrics are found from their files and
entries, and the accepted metrics' lists gained the new cells; a tiny CPU
run of the new eval cell is correct and its neighbour-field fault is not;
the frozen judge's RANSAC (``reference/ops/ransac.py``) equals the frozen
plain image processor (``reference/image_processor.py``) on a seeded case;
the two readers read a hand-made trace, and nothing without the span or
the program's log."""
import collections
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_vio.calibrate import neighbour_field
from bench_vio.harness import Trace, Window, load_json
from bench_vio.metrics import reader
from bench_vio.tests._tiny import run_tiny
from bench_vio.trace.events import WINDOW_RANGE, Event

REPO = Path(__file__).resolve().parents[2]
EVAL, LIVE = "v101-msckfvio.eval.b512", "v101.live.b1"
NEW_METRICS = ("ransac_device_ms.msckfvio", "ransac_rejections_per_frame.msckfvio")
EVAL_APPENDED = (
    "host_reads_per_frame.eval", "frontend_device_ms.eval", "filter_device_ms.eval", "device_idle_pct.eval",
    "dispatch_idle_ms.eval", "fast_device_ms.eval", "lm_kernel_iterations_per_frame.eval",
    "lk_corr_align_roofline_pct", "nullspace_device_ms.qr", "gating_device_ms.qr", "compress_device_ms.qr",
    "qr_compress_roofline_pct",
)
LIVE_APPENDED = (
    "frontend_device_ms.live", "filter_device_ms.live", "schur_gating_device_ms.live", "device_idle_pct.live",
    "host_reads_per_frame.live", "dispatch_idle_ms.live", "launches_per_frame.live",
    "lm_kernel_iterations_per_frame.live",
)
RETIRING = ("host_syncs_per_frame.eval", "host_syncs_per_frame.live", "lm_iterations_per_frame.eval",
            "lm_iterations_per_frame.live")
REFERENCE_TRACKER = dict(
    pyramid_levels=4, temporal_levels=4, stereo_levels=4, tmpl_carry=False, anchor_refine=False,
    translation_seed=False, stereo_lr_threshold=0.0, presmooth=False, fast_threshold=10, cand_budget=0,
    ransac_enabled=True,
)
# msckf_vio's config/app_imgproc.yaml, as the port's FrontendConfig names it
PUBLISHED = dict(grid_row=4, grid_col=5, grid_min_feature_num=3, grid_max_feature_num=4, patch_size=15,
                 max_iteration=30, track_precision=0.01, ransac_threshold=3.0, stereo_threshold=5.0)


def test_the_cells_configuration_and_metrics_are_found():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    assert [w["name"] for w in bench["workloads"][-2:]] == [EVAL, LIVE]
    assert (workloads[EVAL]["config"], workloads[EVAL]["traffic"], workloads[EVAL]["chips"]) == (
        "euroc-v101-msckfvio", "eval.b512", 1)
    assert (workloads[LIVE]["config"], workloads[LIVE]["traffic"], workloads[LIVE]["chips"]) == (
        "euroc-v101", "live.b1", 1)
    assert bench["configs"][-1]["name"] == "euroc-v101-msckfvio"
    assert bench["configs"][-1]["reduced"] == ["duration"]
    config = load_json("configs", "euroc-v101-msckfvio")
    assert config["frontend"] == {**REFERENCE_TRACKER, **PUBLISHED}
    assert (config["method"], config["dtype"], config["filter"], config["reduced"], config["published"]) == (
        "qr", "float32", {"ns_iters": 0, "matmul_precision": "float32"}, ["duration"], {"duration": 144.0})
    qr = load_json("configs", "euroc-v101-qr")
    assert (config["scene"], config["calib"]) == (qr["scene"], qr["calib"])
    assert set(qr["assumed"]) - {"frontend"} <= set(config["assumed"])

    eval_cell, qr_cell = load_json("cells", EVAL), load_json("cells", "v101-qr.eval.b512")
    assert {k: v for k, v in eval_cell.items() if k not in ("config", "limits")} == {
        k: v for k, v in qr_cell.items() if k not in ("config", "limits")}
    live = load_json("cells", LIVE)
    assert (live["config"], live["lanes"], live["fields"], live["seq_frames"], live["warmup_frames"],
            live["pose_read"], live["check_every"], live["trace_frames"], live["roofline_frames"]) == (
        "euroc-v101", 1, 1, 721, 40, "frame", 10, 20, 20)

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["lane_frames_per_s"]["workloads"][-1] == EVAL and LIVE not in e2e["lane_frames_per_s"]["workloads"]
    assert e2e["frame_ms_p95"]["workloads"][-1] == LIVE and EVAL not in e2e["frame_ms_p95"]["workloads"]
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == [EVAL] and per_layer[name]["moves"] == "lane_frames_per_s"
        assert callable(reader(name))
    assert [m["name"] for m in bench["per_layer"][-2:]] == list(NEW_METRICS)
    for name in EVAL_APPENDED:
        assert per_layer[name]["workloads"][-1] == EVAL and per_layer[name]["moves"] == "lane_frames_per_s"
    for name in LIVE_APPENDED:
        assert per_layer[name]["workloads"][-1] == LIVE and per_layer[name]["moves"] == "frame_ms_p95"
    listed = {name for name, m in per_layer.items() if EVAL in m.get("workloads", [])}
    assert listed == set(EVAL_APPENDED) | set(NEW_METRICS)
    assert {name for name, m in per_layer.items() if LIVE in m.get("workloads", [])} == set(LIVE_APPENDED)
    assert not any(cell in per_layer[name]["workloads"] for name in RETIRING for cell in (EVAL, LIVE))


def test_the_tracker_cell_runs_on_the_cpu_and_its_fault_is_caught():
    rc, _, err, result = run_tiny(EVAL)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    with neighbour_field():
        rc, _, err, result = run_tiny(EVAL)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]


def _ransac_case(seed):
    """Three lanes of 40 matches under the frozen calibration, in float64:
    a translation with 6 matches moved 8-25 px, a rotation only with 0.05 px
    noise, and five valid slots with three beyond the 50-unit gate."""
    from bench_vio.reference.config import EUROC_CALIB
    from bench_vio.reference.ops.camera import distort_points
    from bench_vio.reference.utils.lie import so3_exp

    rng = np.random.default_rng(seed)
    K = torch.as_tensor(np.asarray(EUROC_CALIB.cam0.intrinsics, np.float64))
    D = torch.as_tensor(np.asarray(EUROC_CALIB.cam0.distortion_coeffs, np.float64))

    def project(X):
        return distort_points(torch.as_tensor(X[:, :2] / X[:, 2:]), K, D).numpy()

    n, pts1, pts2, valid, R = 40, [], [], [], []
    for lane in range(3):
        X = rng.uniform(-1.5, 1.5, (n, 3)) + np.array([0.0, 0.0, 4.0])
        Rl = so3_exp(torch.as_tensor(rng.normal(size=3) * 0.02)).numpy()
        t = np.array([0.1, 0.02, 0.05]) if lane == 0 else np.zeros(3)
        u1, u2 = project(X), project(X @ Rl.T + t)
        v = np.ones(n, bool)
        if lane == 0:
            u2[:6] += rng.uniform(8, 25, (6, 2)) * np.sign(rng.normal(size=(6, 2)))
        elif lane == 1:
            u2 += rng.normal(0, 0.05, u2.shape)
        else:
            v[5:] = False
            u2[:3] += 300.0
        pts1.append(u1)
        pts2.append(u2)
        valid.append(v)
        R.append(Rl)
    t = torch.as_tensor
    return t(np.stack(pts1)), t(np.stack(pts2)), t(np.stack(valid)), t(np.stack(R)), K, D


@pytest.mark.parametrize("camera", [0, 1])
def test_the_judges_ransac_is_the_plain_image_processors(camera):
    """On float64 inputs (where no point sits within rounding of a
    threshold) the masks are equal, and so are the draws."""
    from bench_vio.reference import image_processor as ip
    from bench_vio.reference.ops import ransac as rr

    args = _ransac_case(5)
    fid = torch.tensor([3, 77, 2**30 + 1], dtype=torch.int32)
    d1, d2 = rr.ransac_draws(fid, camera)
    for b in range(3):
        assert (d1[b].tolist(), d2[b].tolist()) == ip.ransac_draws(int(fid[b]), camera)
    got = rr.two_point_ransac(*args, d1, d2)
    steps = []
    want = ip.two_point_ransac(*args, fid, camera, steps=steps)
    assert [s["branch"] for s in steps] == ["hypotheses", "degenerate", "too few"]
    assert torch.equal(got, want)
    assert not bool(got[0, :6].any()) and bool(got[1].all()) and not bool(got[2].any())


FRAMES = 2


def _trace(spans: bool):
    """Two frames, each a ``vio.step`` with (if ``spans``) a
    ``frontend.ransac`` span holding one op whose kernel runs 1 ms and one
    ``kernel.undistort_points`` launch whose event (no linked op) runs
    0.5 ms; a 2 ms kernel outside the span."""
    ev = [Event("cpu", WINDOW_RANGE, 0, 10_000_000, 1, 0)]
    corr = 10
    for f in range(FRAMES):
        base = f * 5_000_000
        ev.append(Event("cpu", "vio.step", base, base + 4_000_000, corr, 0))
        corr += 1
        if spans:
            ev.append(Event("cpu", "frontend.ransac", base + 100, base + 900, corr, 0))
            ev.append(Event("cpu", "kernel.undistort_points", base + 200, base + 210, corr + 1, 0))
            ev.append(Event("device", "void undistort_points_kernel<float>(float const*)", base + 300,
                            base + 500_300, corr + 2, 0))
            corr += 3
        for start, dur in ((150, 1_000_000), (1_000, 2_000_000)):
            ev.append(Event("cpu", "aten::op", base + start, base + start + 10, corr, 0))
            ev.append(Event("device", "op_kernel", base + 600_000 + start, base + 600_000 + start + dur, corr + 1, corr))
            corr += 2
    return Trace(events=ev, launches=[], frames=FRAMES, syncs=None, sync_sites={}, roofline={})


def _run(trace):
    w = Window(seconds=1.0, frames=FRAMES, lanes=512, frame_ms=None, peak_bytes=None, resident_bytes=0, sequences=0)
    return types.SimpleNamespace(window=w, trace=trace, setup_s=1.0)


@pytest.fixture
def log(monkeypatch):
    from msckf_stereo_c_torch.ops import ransac

    entries = collections.deque(maxlen=256)
    monkeypatch.setattr(ransac, "ransac_work_log", entries)
    return entries


def test_the_readers_on_a_hand_made_trace(log, monkeypatch):
    """1.5 device ms a frame under the span (the op's kernel and the hand
    kernel placed by its launch span); the rejections of the log's last
    four entries (two a span, an older one ignored) over the two frames;
    None without a trace, without the span, without the log or with fewer
    logged calls than the spans hold."""
    from msckf_stereo_c_torch.ops import ransac

    assert reader(NEW_METRICS[0])(_run(_trace(True))) == pytest.approx(1.5)
    log.append(torch.full((4,), 50, dtype=torch.int32))
    calls = [torch.tensor(x, dtype=torch.int32) for x in ([1, 0, 2, 0], [0, 3, 0, 0], [5, 0, 0, 1], [0, 0, 0, 0])]
    log.extend(calls[:3])
    assert reader(NEW_METRICS[1])(_run(_trace(True))) == pytest.approx((4 * 50 + 3 + 3 + 6) / FRAMES)
    log.append(calls[3])
    assert reader(NEW_METRICS[1])(_run(_trace(True))) == pytest.approx((3 + 3 + 6 + 0) / FRAMES)
    for name in NEW_METRICS:
        assert reader(name)(_run(None)) is None
        assert reader(name)(_run(_trace(False))) is None
    log.clear()
    log.extend(calls[:3])
    assert reader(NEW_METRICS[1])(_run(_trace(True))) is None
    monkeypatch.delattr(ransac, "ransac_work_log")
    assert reader(NEW_METRICS[1])(_run(_trace(True))) is None
