"""The port's multi-session tier (``msckf_stereo_c_torch/parallel/multisession.py``
and ``scripts/multisession_gate.py``) against the JAX package's, in float64
on the CPU.

* ``match_landmarks``, ``intersession_edges``, ``build_joint_graph`` and
  ``optimize_joint`` on tests/test_multisession.py's synthetic sessions:
  indices equal, floats within 1e-9;
* ``align_and_solve`` on a synthetic two-session dict (a room-shaped
  landmark field seen by two sessions in their own odometry frames, no VIO
  run) with the port given JAX's sweep grid: the three joint-ATE tiers
  within 1e-9 of JAX's pipeline, match and edge counts equal;
* the two faults of the JAX module that the port does not copy: a skipped
  ICP pass keeps the last committed matches (at least ``min_matches``), and
  the sweep's half-ranges follow the prior, with a warning line when the
  winner sits on the grid's edge;
* the session cache: keyed by sources and configuration, a corrupt or
  truncated file recomputed;
* ``compute_sessions``' two lanes against two one-lane runs (float64
  filter, 2 s sessions): every array within 1e-9 (landmarks 1e-8 m)."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import torch

from msckf_stereo_c_torch.parallel import multisession as tms
from msckf_stereo_c_torch.scripts import multisession_gate as tgate
from msckf_stereo_c_tpu.io import evaluate_ate
from msckf_stereo_c_tpu.parallel import multisession as jms
from msckf_stereo_c_tpu.sim import make_room_landmarks
from msckf_stereo_c_tpu.utils.quaternion import rot_to_jpl

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GRID = dict(yaw_sweep_deg=24.0, dz_sweep_m=2.0, xy_sweep_m=1.6)


def _rigid(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]), np.asarray(t, float)


def _kf_poses(th, radius, phase):
    """Keyframes on a circle looking outward (tests/test_multisession.py's
    poses): JPL world->body quaternions and positions."""
    p = np.stack([radius * np.cos(th + phase), radius * np.sin(th + phase), 0.2 * np.sin(th)], axis=1)
    qs = [np.asarray(rot_to_jpl(jnp.asarray(np.array([[-np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0],
                                                      [np.cos(a), np.sin(a), 0.0]])))) for a in th]
    return np.stack(qs), p


def _synthetic_sessions(yaw=0.5, offset=(1.0, -0.5, 0.2), n_kf=24, n_lm=80, seed=3):
    """tests/test_multisession.py:_synthetic_sessions (noise-free; B's frame
    rigidly offset from A's)."""
    rng = np.random.default_rng(seed)
    lms_w = rng.uniform(-4, 4, (n_lm, 3))
    th = np.linspace(0, 2 * np.pi, n_kf, endpoint=False)
    qA, pA = _kf_poses(th, 3.0, 0.0)
    qB_w, pB_w = _kf_poses(th, 2.5, 1.0)
    R_ab, t_ab = _rigid(yaw, offset)
    qB, pB = jms.apply_rigid(R_ab.T, -R_ab.T @ t_ab, qB_w, pB_w)
    mask = rng.random((n_lm, n_kf)) < 0.6
    sessA = jms.SessionData(np.arange(n_kf) * 1.0, qA, pA, lms_w, mask)
    sessB = jms.SessionData(np.arange(n_kf) * 1.0 + 1e4, qB, pB, (lms_w - t_ab) @ R_ab, mask)
    return sessA, sessB, (R_ab, t_ab)


def _port(s: "jms.SessionData") -> tms.SessionData:
    return tms.SessionData(s.kf_times, s.q, s.p, s.landmarks, s.lm_mask)


def test_match_landmarks_matches_jax():
    """tests/test_multisession.py's mutual-NN case, and a dense cloud
    against a shifted copy at several radii: identical index arrays."""
    rng = np.random.default_rng(0)
    lms = rng.uniform(-5, 5, (60, 3))
    perm = rng.permutation(60)[:40]
    all_b = np.concatenate([lms[perm] + rng.normal(0, 0.02, (40, 3)), rng.uniform(20, 30, (20, 3))])
    cloud = make_room_landmarks(num=300, seed=4)
    for a, b, r in ((lms, all_b, 0.3), (cloud, cloud[::-1] + 0.2, 0.5), (cloud, cloud + 0.05, 3.0)):
        got, want = tms.match_landmarks(a, b, radius=r), jms.match_landmarks(a, b, radius=r)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert len(tms.match_landmarks(lms, all_b, 0.3)[0]) >= 35
    assert [len(x) for x in tms.match_landmarks(lms[:0], all_b)] == [0, 0]


def test_intersession_edges_and_joint_graph_match_jax():
    """Edges, their weights, the joint graph and its solve from a wrong
    prior (tests/test_multisession.py's exact-transform case)."""
    sessA, sessB, (R_ab, t_ab) = _synthetic_sessions()
    ia = ib = np.arange(sessB.landmarks.shape[0], dtype=np.int32)
    want = jms.intersession_edges(sessA, sessB, ia, ib, min_common=6, max_edges=48)
    got = tms.intersession_edges(_port(sessA), _port(sessB), ia, ib, min_common=6, max_edges=48)
    assert len(got[0]) >= 8
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)

    Rn, tn = _rigid(0.10, (0.3, -0.25, 0.1))
    qB_bad, pB_bad = jms.apply_rigid(Rn @ R_ab, Rn @ t_ab, sessB.q, sessB.p)
    qB_port, pB_port = tms.apply_rigid(Rn @ R_ab, Rn @ t_ab, sessB.q, sessB.p)
    np.testing.assert_allclose(qB_port, qB_bad, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pB_port, pB_bad, rtol=0, atol=1e-12)
    jB = jms.SessionData(sessB.kf_times, qB_bad, pB_bad, sessB.landmarks, sessB.lm_mask)
    jg = jms.build_joint_graph(sessA, jB, want)
    tg = tms.build_joint_graph(_port(sessA), _port(jB), got, device="cpu")
    assert tg.edge_i.dtype == torch.int64 and tg.q.dtype == torch.float64
    for field in jg._fields:
        np.testing.assert_allclose(getattr(tg, field).numpy(), np.asarray(getattr(jg, field)), rtol=1e-9, atol=1e-9)
    jr, jc = jms.optimize_joint(jg, mesh=None, iters=15)
    tr, tc = tms.optimize_joint(tg, group=None, iters=15)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-9, atol=1e-20)
    np.testing.assert_allclose(tr.p.numpy(), np.asarray(jr.p), rtol=0, atol=1e-9)
    qB_w, pB_w = tms.apply_rigid(R_ab, t_ab, sessB.q, sessB.p)
    assert np.abs(tr.p.numpy()[24:] - pB_w).max() < 0.02


def _two_session_dict(seed=7):
    """A synthetic finished-session dict (``compute_sessions``' keys): one
    room-shaped landmark field, each session seeing an overlapping noisy
    subset in its own odometry frame, keyframes with 1 cm position noise."""
    rng = np.random.default_rng(seed)
    world = make_room_landmarks(num=170, seed=11)
    frames = {"A": _rigid(0.3, (0.2, 0.1, 0.0)), "B": _rigid(-0.7, (1.0, -0.5, 0.2))}
    picks = {"A": np.arange(0, 130), "B": np.arange(40, 170)}
    th = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    kfw = {"A": _kf_poses(th, 3.0, 0.0), "B": _kf_poses(th, 2.5, 1.0)}
    out = {}
    for s in "AB":
        R_ws, t_ws = frames[s]
        q, p = jms.apply_rigid(R_ws.T, -R_ws.T @ t_ws, *kfw[s])
        lms = (world[picks[s]] - t_ws) @ R_ws + rng.normal(0, 0.02, (len(picks[s]), 3))
        out.update({f"kf_times_{s}": np.arange(20) * 0.25, f"q_{s}": q,
                    f"p_{s}": p + rng.normal(0, 0.01, p.shape), f"landmarks_{s}": lms,
                    f"lm_mask_{s}": rng.random((len(lms), 20)) < 0.5, f"frame_w_R_{s}": R_ws,
                    f"frame_w_t_{s}": t_ws, f"ate_{s}": np.float64(0.01), f"gt_kf_{s}": kfw[s][1]})
    return out


def _jax_tiers(sess, seed, prior_yaw_deg, prior_trans_m):
    """scripts/multisession_gate.py:align_and_solve's steps through the JAX
    package's functions, unrounded (the script rounds to 4 digits)."""
    sA = jms.SessionData(sess["kf_times_A"], sess["q_A"], sess["p_A"], sess["landmarks_A"], sess["lm_mask_A"])
    sB = jms.SessionData(sess["kf_times_B"], sess["q_B"], sess["p_B"], sess["landmarks_B"], sess["lm_mask_B"])
    R_ab, t_ab = jms.relative_prior((sess["frame_w_R_A"], sess["frame_w_t_A"]),
                                    (sess["frame_w_R_B"], sess["frame_w_t_B"]),
                                    yaw_noise_rad=np.deg2rad(prior_yaw_deg), trans_noise_m=prior_trans_m, seed=seed)
    t_all = np.concatenate([sA.kf_times, sB.kf_times + 1e4])
    gt = np.concatenate([sess["gt_kf_A"], sess["gt_kf_B"]])

    def ate(pA, pB):
        return evaluate_ate(t_all, np.concatenate([pA, pB]), t_all, gt).rmse

    before = ate(sA.p, jms.apply_rigid(R_ab, t_ab, sB.q, sB.p)[1])
    R_g, t_g, ia, ib = jms.refine_alignment(sA.landmarks, sB.landmarks @ R_ab.T + t_ab)
    R_tot, t_tot = R_g @ R_ab, R_g @ t_ab + t_g
    qB, pB = jms.apply_rigid(R_tot, t_tot, sB.q, sB.p)
    mid = ate(sA.p, pB)
    sBa = jms.SessionData(sB.kf_times + 1e4, qB, pB, sB.landmarks @ R_tot.T + t_tot, sB.lm_mask)
    inter = jms.intersession_edges(sA, sBa, ia, ib, min_common=6, max_edges=96)
    refined, costs = jms.optimize_joint(jms.build_joint_graph(sA, sBa, inter), mesh=None, iters=12)
    p = np.asarray(refined.p)
    Fa = len(sA.kf_times)
    return dict(joint_ate_prior=before, joint_ate_global_align=mid, joint_ate_after_graph=ate(p[:Fa], p[Fa:]),
                landmark_matches=len(ia), inter_edges=len(inter[0]), cost_drop=float(costs[0] / costs[-1]))


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_multisession_gate",
                                                  os.path.join(ROOT, "scripts", "multisession_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_align_and_solve_matches_jax():
    """The three tiers at the gate's default prior (10 deg / 0.75 m) with
    the port given JAX's grid; the JAX script's own (rounded) line agrees
    to its 4 digits."""
    sess = _two_session_dict()
    got = tgate.align_and_solve(sess, seed=0, sweep=JAX_GRID, use_group=False, device="cpu", verbose=False)
    want = _jax_tiers(sess, 0, 10.0, 0.75)
    for k in ("joint_ate_prior", "joint_ate_global_align", "joint_ate_after_graph"):
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    assert (got["landmark_matches"], got["inter_edges"]) == (want["landmark_matches"], want["inter_edges"])
    assert got["inter_edges"] >= 3 and got["graph_nodes"] == 40 and got["mesh_devices"] == 0
    np.testing.assert_allclose(got["cost_drop"], want["cost_drop"], rtol=1e-6)
    assert got["joint_ate_after_graph"] < 0.5 * got["joint_ate_prior"]
    line = _jax_script().align_and_solve(sess, seed=0, use_mesh=False, verbose=False)
    for k in ("joint_ate_prior", "joint_ate_global_align", "joint_ate_after_graph", "ate_session_a"):
        assert abs(got[k] - line[k]) <= 5e-5 + 1e-12
    assert (got["landmark_matches"], got["inter_edges"], got["graph_nodes"]) == (
        line["landmark_matches"], line["inter_edges"], line["graph_nodes"])


def test_skipped_icp_pass_keeps_committed_matches():
    """Radii (3.0, 1.5, 0.002) on 2 cm-noisy clouds: the last pass finds
    fewer than min_matches.  JAX keeps that pass's short match set; the
    port keeps the 1.5 m pass's (at least min_matches), with the same fit
    and rms as both."""
    rng = np.random.default_rng(2)
    a = make_room_landmarks(num=200, seed=5)
    b = a @ _rigid(0.05, (0, 0, 0))[0].T + np.array([0.2, -0.1, 0.1]) + rng.normal(0, 0.02, a.shape)
    radii = (3.0, 1.5, 0.002)
    R, t, ia, ib, rms = tms._icp_passes(a, b, radii, 12)
    Rj, tj, iaj, ibj, rmsj = jms._icp_passes(a, b, radii, 12)
    assert len(iaj) < 12 <= len(ia)
    np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t, tj, rtol=0, atol=1e-12)
    assert abs(rms - rmsj) < 1e-12
    R2, t2, ia2, ib2, _ = jms._icp_passes(a, b, radii[:2], 12)
    np.testing.assert_array_equal(ia, ia2)
    np.testing.assert_array_equal(ib, ib2)
    # No pass meets min_matches: identity, no matches, infinite rms.
    R0, t0, ia0, _, rms0 = tms._icp_passes(a, b + 50.0, (0.1,), 12)
    assert np.array_equal(R0, np.eye(3)) and len(ia0) == 0 and rms0 == np.inf


def test_sweep_grid_follows_the_prior(capsys):
    """JAX's grids at JAX's half-ranges; the gate's half-ranges at the
    default prior (30 deg, 2.25 m); a warning line when the result lies at
    the grid's edge (the truth 20 deg off a +-6 deg grid), none when it lies
    inside (3 deg off)."""
    assert np.array_equal(tms._grid(24.0, 3.0), np.arange(-24.0, 24.0 + 1e-9, 3.0))
    assert np.array_equal(tms._grid(2.0, 0.5), np.arange(-2.0, 2.0 + 1e-9, 0.5))
    assert np.array_equal(tms._grid(1.6, 1.6), np.array([-1.6, 0.0, 1.6]))
    assert np.array_equal(tms._grid(0.0, 3.0), np.array([0.0]))
    assert tgate.sweep_ranges(10.0, 0.75) == dict(yaw_sweep_deg=30.0, dz_sweep_m=2.25, xy_sweep_m=2.25)
    assert tgate.sweep_ranges(2.0, 0.1) == JAX_GRID
    a = make_room_landmarks(num=150, seed=6)
    c = a.mean(axis=0)
    for yaw, warned in ((np.deg2rad(20.0), True), (np.deg2rad(3.0), False)):
        R, _ = _rigid(-yaw, (0, 0, 0))
        b = (a - c) @ R.T + c
        tms.refine_alignment(a, b, yaw_sweep_deg=6.0, dz_sweep_m=0.5, xy_sweep_m=0.0, device="cpu")
        err = capsys.readouterr().err
        assert ("warning" in err and "edge" in err) == warned, err


def test_session_cache(monkeypatch, tmp_path):
    """The cache key changes with the configuration; a valid file is read
    (under ``with np.load``), a corrupt, truncated or incomplete one is
    recomputed and rewritten."""
    monkeypatch.setattr(tgate, "CACHE_DIR", str(tmp_path))
    sess = _two_session_dict()
    calls = []
    monkeypatch.setattr(tgate, "compute_sessions", lambda **kw: calls.append(kw) or dict(sess))
    monkeypatch.setattr(tgate, "align_and_solve", lambda s, **kw: {"n_keys": len(s)})
    kw = dict(duration=3.0, device="cpu", verbose=False)
    out = tgate.run_multisession(**kw)
    path = tgate._cache_path(dict(duration=3.0, seed=0, keyframe_stride=5, chunk=64, device="cpu"))
    assert os.path.exists(path) and out["n_keys"] == len(sess) and len(calls) == 1
    assert path != tgate._cache_path(dict(duration=3.0, seed=1, keyframe_stride=5, chunk=64, device="cpu"))
    tgate.run_multisession(**kw)
    assert len(calls) == 1
    good = open(path, "rb").read()
    for bad in (b"not an npz file", good[: len(good) // 2]):
        with open(path, "wb") as f:
            f.write(bad)
        tgate.run_multisession(**kw)
        assert tgate._read_cache(path) is not None
    assert len(calls) == 3
    np.savez(path, **{k: v for k, v in sess.items() if k != "gt_kf_B"})
    tgate.run_multisession(**kw)
    assert len(calls) == 4
    tgate.run_multisession(**kw, cache=False)
    assert len(calls) == 5


def test_two_lane_sessions_equal_one_lane_runs():
    """compute_sessions runs A and B as two lanes of one run_vio_batch; with
    the filter in float64 each lane equals its session run alone (2 s
    sessions, 41 frames in chunks of 16)."""
    kw = dict(keyframe_stride=5, chunk=16, filter_dtype=torch.float64, device="cpu", verbose=False)
    both = tgate.compute_sessions(duration=2.0, **kw)
    one = {}
    for spec in tgate.session_specs(2.0, 0):
        one.update(tgate.run_sessions([spec], **kw))
    assert sorted(both) == sorted(one) == sorted(f"{k}_{s}" for k in tgate.SESSION_KEYS for s in "AB")
    for k in both:
        assert np.shape(both[k]) == np.shape(one[k]), k
        if k.startswith("lm_mask"):
            np.testing.assert_array_equal(both[k], one[k])
        else:
            np.testing.assert_allclose(both[k], one[k], rtol=0, atol=1e-8 if k.startswith("landmarks") else 1e-9)
    assert both["q_A"].shape[0] == 9 and len(both["landmarks_A"]) >= 8
    assert not np.allclose(both["p_A"], both["p_B"])
    assert max(float(both["ate_A"]), float(both["ate_B"])) < 0.13
