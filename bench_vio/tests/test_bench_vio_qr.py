"""The textbook-update configuration and the protocol cell: discovered from
their files and entries; a tiny CPU run of ``euroc-v101-qr`` is correct and
its neighbour-field fault is not; the frozen judge's float64 'qr' update
equals the frozen textbook reference (``reference/textbook_update.py``) on
a seeded state; ``roofline/qr.py``'s count equals a hand count, and the
roofline and span readers read a hand-made trace and nothing without the
spans or the program's work log."""
import collections
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_vio.calibrate import neighbour_field
from bench_vio.harness import Trace, Window
from bench_vio.metrics import reader
from bench_vio.roofline import lk, qr
from bench_vio.tests._tiny import run_tiny
from bench_vio.trace.events import WINDOW_RANGE, Event

REPO = Path(__file__).resolve().parents[2]
CELLS = ("v101-qr.eval.b512", "v101-stress-gain.protocol.b5")
QR_METRICS = ("nullspace_device_ms.qr", "gating_device_ms.qr", "compress_device_ms.qr", "qr_compress_roofline_pct")
# Accepted metrics that the new cells report too: name -> the new cells
# appended to its ``workloads``.
APPENDED = {
    "host_syncs_per_frame.eval": CELLS, "frontend_device_ms.eval": CELLS, "filter_device_ms.eval": CELLS,
    "device_idle_pct.eval": CELLS, "fast_device_ms.eval": CELLS, "host_reads_per_frame.eval": CELLS,
    "lm_iterations_per_frame.eval": CELLS, "dispatch_idle_ms.eval": CELLS,
    "lk_corr_align_roofline_pct": CELLS[:1], "schur_gating_device_ms.eval": CELLS[1:],
}


def test_the_new_cells_and_metrics_are_found():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    from bench_vio.harness import load_json

    workloads = {w["name"]: w for w in bench["workloads"]}
    assert workloads["v101-qr.eval.b512"]["config"] == "euroc-v101-qr"
    assert workloads["v101-stress-gain.protocol.b5"]["config"] == "euroc-v101-stress-gain"
    for name in CELLS:
        assert load_json("cells", name)["config"] == workloads[name]["config"]
        assert name in next(m for m in bench["end_to_end"] if m["name"] == "lane_frames_per_s")["workloads"]
        assert any(name in m.get("workloads", []) for m in bench["per_layer"])
    config = load_json("configs", "euroc-v101-qr")
    assert (config["method"], config["filter"]["ns_iters"], config["frontend"]) == (
        "qr", 0, {"presmooth": False, "fast_threshold": 10})
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in QR_METRICS:
        assert per_layer[name]["workloads"] == ["v101-qr.eval.b512"]
        assert per_layer[name]["moves"] == "lane_frames_per_s"
        assert callable(reader(name))
    gain = per_layer["lk_corr_align_gain_roofline_pct.eval"]
    assert (gain["workloads"], gain["moves"]) == (["v101-stress-gain.protocol.b5"], "lane_frames_per_s")
    assert callable(reader(gain["name"]))
    for name, cells in APPENDED.items():
        assert per_layer[name]["workloads"][0] == "v101.eval.b512"
        assert set(per_layer[name]["workloads"][1:]) == set(cells)
        assert per_layer[name]["moves"] == "lane_frames_per_s"


def test_the_textbook_cell_runs_on_the_cpu_and_its_fault_is_caught():
    rc, _, err, result = run_tiny("v101-qr.eval.b512")
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    with neighbour_field():
        rc, _, err, result = run_tiny("v101-qr.eval.b512")
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]


def _state(seed):
    """A frozen-reference batch of 2 lanes (3 and 4 active of M=4 slots)
    with 4 tracks each seen from 2-4 cameras, in float64."""
    from bench_vio.reference.config import EUROC_CALIB, FilterConfig
    from bench_vio.reference.models import msckf as rm
    from bench_vio.reference.models.state import init_filter_state
    from bench_vio.reference.utils.lanes import stack_lanes
    from bench_vio.reference.utils.quaternion import jpl_to_rot, small_angle_quaternion

    rng = np.random.default_rng(seed)
    M, K = 4, 4
    cfg = FilterConfig(max_cam_state_size=M, max_tracks=K, ns_iters=0)
    params = rm.make_params(cfg, EUROC_CALIB, torch.float64, "cpu")
    R01, t01 = params.R_c0_c1, params.t_c0_c1

    def rot(scale):
        return small_angle_quaternion(torch.as_tensor(rng.normal(size=3) * scale))

    lanes, pos, obs, mask = [], [], [], []
    for N in (3, 4):
        s = init_filter_state(cfg, EUROC_CALIB, torch.float64, "cpu")
        q = torch.stack([rot(0.05) for _ in range(M)])
        p = torch.as_tensor(np.c_[0.2 * np.arange(M), 0.05 * rng.normal(size=(M, 2))])
        Da = 21 + 6 * N
        A = rng.normal(size=(Da, Da))
        P = torch.zeros((21 + 6 * M,) * 2, dtype=torch.float64)
        P[:Da, :Da] = torch.as_tensor(1e-4 * A @ A.T / Da + 1e-6 * np.eye(Da))
        lanes.append(s._replace(cams=s.cams._replace(q=q, p=p, q_null=q, p_null=p), P=P,
                                num_cams=torch.tensor(N, dtype=torch.int32), imu=s.imu._replace(q=rot(0.5))))
        p_w = torch.as_tensor(np.c_[rng.uniform(-1, 1, (K, 2)), rng.uniform(3, 6, K)])
        o = torch.zeros((K, M, 4), dtype=torch.float64)
        m = torch.zeros((K, M), dtype=torch.bool)
        for k in range(K):
            for i in sorted(rng.choice(N, size=int(rng.integers(2, min(4, N) + 1)), replace=False)):
                R_w_c0 = jpl_to_rot(q[i])
                R_w_c1 = R01 @ R_w_c0
                c0, c1 = R_w_c0 @ (p_w[k] - p[i]), R_w_c1 @ (p_w[k] - p[i] + R_w_c1.T @ t01)
                o[k, i] = torch.cat([c0[:2] / c0[2], c1[:2] / c1[2]]) + torch.as_tensor(1e-3 * rng.normal(size=4))
                m[k, i] = True
        pos.append(p_w + torch.as_tensor(0.01 * rng.normal(size=(K, 3))))
        obs.append(o)
        mask.append(m)
    mask = torch.stack(mask)
    use = mask.any(-1)
    dof = torch.clamp(mask.sum(-1) - 1, 1, 99)
    return stack_lanes(lanes), params, torch.stack(pos), torch.stack(obs), mask, use, dof


def test_the_judges_update_is_the_textbook_update():
    """The frozen copy's ``_gate_and_update(method='qr')`` (what the judge
    runs) and the frozen textbook reference agree to float64 rounding
    (1e-9 of each quantity's scale) on a seeded state."""
    from bench_vio.reference import textbook_update as tb
    from bench_vio.reference.models import msckf as rm

    state, params, pos, obs, mask, use, dof = _state(11)
    got = rm._gate_and_update(state, params, "qr", pos, obs, mask, use, dof)
    f = state.imu
    want = tb.textbook_update(
        state.P, dict(q=f.q, bg=f.bg, v=f.v, ba=f.ba, p=f.p, R_imu_cam0=f.R_imu_cam0, t_cam0_imu=f.t_cam0_imu),
        dict(q=state.cams.q, p=state.cams.p, q_null=state.cams.q_null, p_null=state.cams.p_null), state.num_cams,
        state.gravity, params.R_c0_c1, params.t_c0_c1, params.sigma2, pos, obs, mask, use, params.chi2_table[dof])
    assert bool(want["passed"].any())

    def close(a, b):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())

    close(got.P, want["P"])
    assert float((got.P - state.P).abs().max()) > 1e-3 * float(state.P.abs().max())
    for name in ("q", "p", "v", "bg", "ba", "R_imu_cam0", "t_cam0_imu"):
        close(getattr(got.imu, name), want["imu"][name])
    close(got.cams.p, want["cams"]["p"])
    close(got.cams.q, want["cams"]["q"])


def test_the_least_work_is_counted_by_hand():
    """Householder on each lane's nonzero block: 2mn^2 - 2n^3/3 operations
    where m >= n (48 x 46), 2nm^2 - 2m^3/3 where m < n (10 x 46), nothing
    for an empty lane; one read of the block and R's upper trapezoid
    written, in float32 words; one call's bound the larger time."""
    n_bytes, n_ops = qr.lane_work(np.array([48, 10, 0]), np.array([46, 46, 0]), 4)
    assert n_ops == pytest.approx((2 * 48 * 46 ** 2 - 2 * 46 ** 3 / 3) + (2 * 46 * 10 ** 2 - 2 * 10 ** 3 / 3))
    assert n_bytes == (48 * 46 + 46 * 47 // 2) * 4 + (10 * 46 + (10 * 46 - 45)) * 4
    w = np.array([[48, 46], [10, 46], [0, 0]], np.int32)
    want = max(n_bytes / lk.HBM_BYTES_PER_S, n_ops / lk.F32_OPS_PER_S) * 1e3
    assert qr.call_bound_ms(w, 4) == pytest.approx(want)


def _trace(with_spans: bool, frames: int = 2):
    ev = [Event("cpu", WINDOW_RANGE, 0, 10_000_000, 1, 0)]
    corr = 10
    for f in range(frames):
        base = f * 5_000_000
        names = ("filter", "filter.nullspace", "filter.gating", "filter.update", "filter.compress")
        spans = {"filter": (0, 4_000_000), "filter.nullspace": (100, 200), "filter.gating": (300, 400),
                 "filter.update": (500, 3_900_000), "filter.compress": (600, 700)}
        for name in names if with_spans else ("filter",):
            s, t = spans[name]
            ev.append(Event("cpu", name, base + s, base + t, corr, 0))
            corr += 1
        for start in (150, 350, 650):  # an op in each inner span, and its 1 ms kernel
            ev.append(Event("cpu", "aten::op", base + start, base + start + 10, corr, 0))
            ev.append(Event("device", "op_kernel", base + start + 20, base + start + 1_000_020, corr + 1, corr))
            corr += 2
    return Trace(events=ev, launches=[], frames=frames, syncs=None, sync_sites={}, roofline={})


def _log(*works):
    return collections.deque((torch.tensor(w, dtype=torch.int32), 4) for w in works)


def test_the_readers_on_a_hand_made_trace(monkeypatch):
    """Per frame 1 ms under each span; the roofline share is the logged
    calls' least time over the 2 ms under the two ``filter.compress``
    spans, from the log's last two entries (an older one ignored); a trace
    without the spans, a run without a trace, a program without the log
    and a log shorter than the spans give None."""
    from msckf_stereo_c_torch.ops import linalg

    w = Window(seconds=1.0, frames=2, lanes=512, frame_ms=None, peak_bytes=None, resident_bytes=0, sequences=0)
    run = types.SimpleNamespace(window=w, trace=_trace(True))
    for name in ("nullspace_device_ms.qr", "gating_device_ms.qr", "compress_device_ms.qr"):
        assert reader(name)(run) == pytest.approx(1.0)
    calls = ([[2000, 142], [0, 0]], [[700, 100], [40, 61]])
    monkeypatch.setattr(linalg, "qr_work_log", _log([[9, 9]], *calls))
    least = sum(qr.call_bound_ms(np.array(c), 4) for c in calls)
    assert reader("qr_compress_roofline_pct")(run) == pytest.approx(100.0 * least / 2.0)
    monkeypatch.setattr(linalg, "qr_work_log", _log(calls[1]))
    assert reader("qr_compress_roofline_pct")(run) is None
    monkeypatch.delattr(linalg, "qr_work_log")
    assert reader("qr_compress_roofline_pct")(run) is None
    monkeypatch.setattr(linalg, "qr_work_log", _log(*calls), raising=False)
    parent = types.SimpleNamespace(window=w, trace=_trace(False))
    for name in QR_METRICS:
        assert reader(name)(parent) is None
        assert reader(name)(types.SimpleNamespace(window=w, trace=None)) is None
