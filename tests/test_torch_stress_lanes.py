"""The port's multi-seed stress script and its filter debug dump.

* ``run_stress_lanes``: robustness seeds as the lanes of one batched run,
  against each seed's one-lane ``run_stress_gate`` on the CPU;
* ``scripts/stress_gate.py``: the knobs give the run the JAX script builds
  (its ``run_stress_gate`` calls recorded), and the script prints its
  per-seed lines and the final line;
* ``filter_internals`` and ``run_vio_sequence(internals_at=N)`` on a short
  rendered scene blanked from frame N (tests/test_filter_internals.py's
  set-up, cut to 10 frames), against the JAX package's ``filter_internals``
  from the same state and frame.

Tolerances are stated at each test."""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch.models import runner as trunner
from msckf_stereo_c_torch.models import vio as tvio
from msckf_stereo_c_torch.scripts import stress_gate as tgate
from msckf_stereo_c_torch.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_torch.sim import stress as tstress
from msckf_stereo_c_torch.sim.render_torch import StressEvents, TorchRenderer
from msckf_stereo_c_torch.utils.lanes import map_tree
from msckf_stereo_c_tpu import config as jconfig
from msckf_stereo_c_tpu.models import msckf as jmsckf
from msckf_stereo_c_tpu.models import propagation as jprop
from msckf_stereo_c_tpu.models import state as jstate
from msckf_stereo_c_tpu.sim import stress as jstress

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stress_lanes_equal_one_lane_runs():
    """Seeds 0 and 3 as two lanes over 0.3 s of the stress scene (7 frames,
    three chunks), against each seed's one-lane run_stress_gate: feature ids
    and validity equal on every frame, ATEs within 1e-5 m.  The filter runs
    in float64 here: in float32 the batched products round by batch shape
    (ROADMAP.md, Queue 3), which can flip one track's gate within these
    frames."""
    kw = dict(duration=0.3, chunk=3, filter_dtype=torch.float64, device="cpu")
    lanes = tstress.run_stress_lanes([0, 3], **kw)
    assert [r.n_frames for r in lanes] == [7, 7]
    for seed, got in zip((0, 3), lanes):
        want = tstress.run_stress_gate(seed=seed, lm_seed=tstress.protocol_lm_seed(seed), **kw)
        np.testing.assert_array_equal(got.result.fid, want.result.fid)
        np.testing.assert_array_equal(got.result.valid, want.result.valid)
        assert abs(got.ate_rmse - want.ate_rmse) <= 1e-5
        assert np.isfinite(got.result.positions).all() and got.ate_rmse < 0.13
    # The lanes drew their own landmarks, noise and images.
    assert not np.array_equal(lanes[0].result.uv, lanes[1].result.uv)


def _jax_script(monkeypatch, env):
    """Runs scripts/stress_gate.py's main (the JAX package's script, not
    edited) under ``env`` with its run_stress_gate replaced by a recorder:
    the keyword arguments of every call."""
    for k in [k for k in os.environ if k.startswith("STRESS_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []

    def record(**kw):
        calls.append(kw)
        return jstress.StressGateResult(
            ate_rmse=0.05, ate_mean=0.04, ate_max=0.1, duration=kw["duration"], n_frames=3,
            min_tracks_after_ransac=40, result=None, gt_t=None, gt_p=None,
        )

    monkeypatch.setattr(jstress, "run_stress_gate", record)
    spec = importlib.util.spec_from_file_location("jax_stress_gate", os.path.join(ROOT, "scripts", "stress_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return calls


@pytest.mark.parametrize("env", [
    {},
    {"STRESS_GENERATOR": "fastmotion", "STRESS_SEEDS": "3", "STRESS_SEED": "2"},
    {"STRESS_GENERATOR": "fastmotion", "STRESS_TEX_POOR": "0.7"},
    {"STRESS_NS_ITERS": "0", "STRESS_METHOD": "qr", "STRESS_FILTER_PRECISION": "float32",
     "STRESS_NOISE_ADAPTIVE": "1", "STRESS_NOISE_REF": "30", "STRESS_NOISE_CAP": "8",
     "STRESS_FRONTEND_PRECISION": "highest", "STRESS_KLT_NORM": "gain", "STRESS_FAST_THR": "12",
     "STRESS_PRESMOOTH": "0", "STRESS_CAND_LEVEL1": "0", "STRESS_SENSOR_NOISE": "0",
     "STRESS_MOTION_BLUR": "1", "STRESS_VIGNETTE": "0.1", "STRESS_NOISE_READ": "2",
     "STRESS_NOISE_SHOT": "0.05", "STRESS_BLOB_POOR": "0.2", "STRESS_DURATION": "36", "STRESS_CHUNK": "32",
     "STRESS_PLATFORM": "cpu"},
], ids=["defaults", "fastmotion", "fastmotion_override", "every_knob"])
def test_stress_knobs_match_the_jax_script(monkeypatch, capsys, env):
    """stress_knobs(env) gives the configurations, seeds, landmark seeds,
    photometric knobs, duration, chunk, method and generator that the JAX
    script passes to run_stress_gate under the same environment."""
    calls = _jax_script(monkeypatch, env)
    capsys.readouterr()
    knobs = tgate.stress_knobs(env)
    assert len(calls) == len(knobs.seeds)
    for seed, call in zip(knobs.seeds, calls):
        assert call["seed"] == seed and call["lm_seed"] == tstress.protocol_lm_seed(seed)
        assert dataclasses.asdict(knobs.fcfg) == dataclasses.asdict(call["fcfg"])
        assert dataclasses.asdict(knobs.mcfg) == dataclasses.asdict(call["mcfg"])
        assert knobs.events_kwargs == call["events_kwargs"]
        assert (knobs.duration, knobs.chunk, knobs.method, knobs.generator) == (
            call["duration"], call["chunk"], call["method"], call["generator"])
    if env.get("STRESS_GENERATOR") == "fastmotion":
        assert knobs.events_kwargs["blob_poor_depth"] == 0.4
        assert knobs.events_kwargs["tex_poor_depth"] == float(env.get("STRESS_TEX_POOR", 0.5))
    assert knobs.device == ("cpu" if env.get("STRESS_PLATFORM") == "cpu" else None)


def test_stress_refine_raises():
    """STRESS_REFINE=1 or ``--refine`` no longer raises: it builds the
    refinement tier with the JAX script's defaults (keyframes every 5
    frames, at most 60) and its STRESS_REFINE_STRIDE / STRESS_REFINE_KF
    knobs; without it there is no tier.  (The tier itself runs in
    tests/test_torch_refine.py.)"""
    knobs = tgate.stress_knobs({"STRESS_REFINE": "1"})
    assert (knobs.refine, knobs.refine_stride, knobs.refine_kf) == (True, 5, 60)
    assert tgate.stress_knobs({}, argv=["--refine"]).refine
    knobs = tgate.stress_knobs({"STRESS_REFINE": "1", "STRESS_REFINE_STRIDE": "3", "STRESS_REFINE_KF": "20"})
    assert (knobs.refine_stride, knobs.refine_kf) == (3, 20)
    assert not tgate.stress_knobs({}).refine and not tgate.stress_knobs({"STRESS_REFINE": "0"}).refine


def test_stress_script_prints_seed_lines_and_the_gate_line(capsys):
    """The script on the CPU, two seeds over 0.3 s with the JAX package's
    filter defaults (method 'qr', exact solves) through run_vio_batch: one
    line per seed, then the gate line judged on the worst seed."""
    env = dict(STRESS_PLATFORM="cpu", STRESS_DURATION="0.3", STRESS_SEEDS="2", STRESS_SEED="1",
               STRESS_METHOD="qr", STRESS_NS_ITERS="0")
    line = tgate.main(env, argv=[])
    out = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["seed"] for x in out[:2]] == [1, 2] and out[2] == line
    assert line["metric"] == "stress_ate_rmse_worst" and line["n_seeds"] == 2 and line["frames"] == 7
    assert line["value"] == max(x["ate_rmse"] for x in out[:2]) < 0.13
    assert line["device"] == "cpu" and line["gate"] == 0.13


_JAX_CLASSES = {
    cls.__name__: cls
    for cls in (jstate.FilterState, jstate.ImuState, jstate.CamStates, jstate.TrackMap, jprop.ImuBatch,
                jmsckf.FrameFeatures)
}


def _to_jax(tree):
    """The port's tree -> the JAX package's NamedTuples of jnp arrays."""
    if hasattr(tree, "_fields"):
        return _JAX_CLASSES[type(tree).__name__](*(_to_jax(v) for v in tree))
    return None if tree is None else jnp.asarray(np.asarray(tree))


INT_KEYS = ("candidate_idx", "candidate_fid", "candidate_use", "candidate_dof", "gate_pass_qr", "gate_pass_schur",
            "num_cams", "n_lost_short", "n_candidates", "obs_mask", "rows_valid")


def test_filter_internals_and_internals_at():
    """run_vio_sequence(internals_at=6) on 10 frames of a rendered circle
    scene whose texture goes flat from frame 6 (every track dies there, so
    frame 6 has a full candidate set), method 'qr', filter float64: the
    dump has the JAX package's keys and shapes; given the same state and
    frame, the JAX filter_internals gives equal integer and boolean
    entries, floats within 1e-9 of each entry's largest magnitude (H_o and
    r_o also through H_o^T H_o and H_o^T r_o), and gamma_qr equals
    gamma_schur on the used tracks within 1e-6 relative; the run's poses
    equal the run without internals_at, bit for bit."""
    fcfg = tconfig.FrontendConfig(max_features=48)
    mcfg = tconfig.FilterConfig(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=12)
    traj = make_circle_trajectory(duration=4.0)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    idx = 290 + 10 * np.arange(10)
    N = 6
    ev = StressEvents.nominal(len(idx))
    ev.tex_scale[N:] = 0.0
    ev.blob_scale[N:] = 0.0
    img0, img1 = TorchRenderer(make_wall_landmarks(num=300, radius=8.0, seed=1), r_wall=8.0,
                               device="cpu").render_sequence(traj, idx, ev)
    frame_t = traj.t[idx]
    kw = dict(image_dtype=torch.float32, filter_dtype=torch.float64, method="qr", chunk=4, device="cpu")
    args = (fcfg, mcfg, tconfig.EUROC_CALIB)
    res = tvio.run_vio_sequence(*args, frame_t, img0, img1, imu.t, imu.gyro, imu.acc, internals_at=N, **kw)
    plain = tvio.run_vio_sequence(*args, frame_t, img0, img1, imu.t, imu.gyro, imu.acc, **kw)
    np.testing.assert_array_equal(res.positions, plain.positions)
    assert plain.internals is None
    d = res.internals

    K, M = mcfg.max_update_tracks, mcfg.max_cam_state_size
    D = 21 + 6 * M
    assert d["H_x_blocks"].shape == (K, M, 4, 6) and d["H_f_blocks"].shape == (K, M, 4, 3)
    assert d["H_o"].shape == (K, 4 * M, D) and d["gamma_qr"].shape == (K,)
    used = d["candidate_use"]
    assert used.sum() >= 5 and not d["frontend_valid"].any()

    # The JAX package's dump from the state before frame N and the same frame.
    head = tvio.run_vio_sequence(*args, frame_t[:N], img0[:N], img1[:N], imu.t, imu.gyro, imu.acc, **kw)
    batches = trunner.pack_imu_batches(imu.t, imu.gyro, imu.acc, frame_t, mcfg.max_imu_per_frame)
    jcfg = jconfig.FilterConfig(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=12)
    frame = jmsckf.FrameFeatures(
        time=jnp.asarray(frame_t[N]), fid=jnp.asarray(d["frontend_fid"]),
        uv=jnp.asarray(d["frontend_uv"], jnp.float64), valid=jnp.asarray(d["frontend_valid"]),
        quality=jnp.zeros(d["frontend_valid"].shape),
    )
    want = jax.device_get(jax.jit(jmsckf.filter_internals, static_argnames=("cfg", "method"))(
        _to_jax(head.final_state.filt), frame, _to_jax(map_tree(lambda x: x[N], batches)),
        jmsckf.make_params(jcfg, jconfig.EUROC_CALIB, jnp.float64), cfg=jcfg,
    ))
    assert set(d) == set(want) | {"frontend_fid", "frontend_uv", "frontend_valid"}
    for key, w in want.items():
        got, w = d[key], np.asarray(w)
        assert got.shape == w.shape, key
        if key in INT_KEYS:
            np.testing.assert_array_equal(got, w, err_msg=key)
        else:
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-9 * max(np.abs(w).max(), 1e-300), err_msg=key)
    Ho, ro, wHo, wro = d["H_o"], d["r_o"], np.asarray(want["H_o"]), np.asarray(want["r_o"])
    gram = np.einsum("krd,kre->kde", wHo, wHo)
    np.testing.assert_allclose(np.einsum("krd,kre->kde", Ho, Ho), gram, rtol=0, atol=1e-9 * np.abs(gram).max())
    proj = np.einsum("krd,kr->kd", wHo, wro)
    np.testing.assert_allclose(np.einsum("krd,kr->kd", Ho, ro), proj, rtol=0, atol=1e-9 * np.abs(proj).max())
    np.testing.assert_allclose(d["gamma_qr"][used], d["gamma_schur"][used], rtol=1e-6, atol=1e-8)
    assert (d["gate_pass_qr"] == d["gate_pass_schur"])[used].all()
