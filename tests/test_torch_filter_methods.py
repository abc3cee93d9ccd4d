"""The port's exact filter paths against the JAX package's, in float64 on the
CPU: methods 'qr' and 'cholesky' (nullspace projection, gating and
compression), 'schur' with exact solves (``ns_iters=0``), the sequential
IMU propagation, ``run_sequence`` and ``reset_filter``.

The recorded frames are tests/test_torch_filter.py's (feature tracks of a
synthetic circle trajectory after its spin-up, with lost-track updates and
camera-window prunes on most frames).  Tolerances: pose position 1e-6 m,
quaternion 1e-8, covariance 1e-6 relative to its largest entry (the
implementations differ in summation order and in the propagation's
association); the update's inputs and outputs 1e-9 relative.

A complete QR's nullspace basis is not unique, so the projected rows are
compared through what does not depend on it (H_o^T H_o, H_o^T r_o; R_t^T
R_t, R_t^T r_t); the raw rows are compared too, since the port builds its
basis with LAPACK's Householder convention, which JAX's CPU QR uses."""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.config import EUROC_CALIB as T_CALIB
from msckf_stereo_c_torch.config import FilterConfig as TFilterConfig
from msckf_stereo_c_torch.models import msckf as tmsckf
from msckf_stereo_c_torch.models import propagation as tprop
from msckf_stereo_c_torch.models import runner as trunner
from msckf_stereo_c_torch.models import update as tupdate
from msckf_stereo_c_torch.ops import linalg as tlinalg
from msckf_stereo_c_tpu.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c_tpu.models import msckf as jmsckf
from msckf_stereo_c_tpu.models import propagation as jprop
from msckf_stereo_c_tpu.models import runner as jrunner
from msckf_stereo_c_tpu.models import update as jupdate
from msckf_stereo_c_tpu.models.state import init_filter_state
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_landmarks, project_tracks, synthesize_imu

torch.set_num_threads(1)

KW = dict(max_cam_state_size=6, max_tracks=48, max_imu_per_frame=12, ns_iters=0)
JCFG, TCFG = FilterConfig(**KW), TFilterConfig(**KW)
N_FRAMES = 24
METHODS = ("qr", "cholesky", "schur")


@pytest.fixture(scope="module")
def world():
    traj = make_circle_trajectory(duration=4.2)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    feats = project_tracks(traj, make_landmarks(num=300), max_features=32, pixel_noise=0.3)
    sl = slice(56, 56 + N_FRAMES)
    t = feats.t[sl]
    batches = jrunner.pack_imu_batches(
        imu.t, imu.gyro, imu.acc, t, JCFG.max_imu_per_frame, prev_frame_t=feats.t[55]
    )
    state = init_filter_state(JCFG, EUROC_CALIB, jnp.float64)
    state = jrunner.apply_gravity_init(state, imu.gyro[:200], imu.acc[:200])
    return dict(
        imu=imu, feats=feats, t=t, fid=feats.fid[sl], uv=feats.uv[sl], valid=feats.valid[sl],
        batches=jax.device_get(batches), state0=jax.device_get(state),
    )


@pytest.fixture(scope="module")
def jparams():
    return jmsckf.make_params(JCFG, EUROC_CALIB, jnp.float64)


@pytest.fixture(scope="module")
def tparams():
    return tmsckf.make_params(TCFG, T_CALIB, torch.float64, "cpu")


@pytest.fixture(scope="module")
def jstep(jparams):
    """The JAX filter_step, jitted once per method for the whole module."""
    steps = {}

    def get(method):
        if method not in steps:
            steps[method] = jax.jit(functools.partial(jmsckf.filter_step, params=jparams, cfg=JCFG, method=method))
        return steps[method]

    return get


def _frame(w, k, lib):
    if lib == "jax":
        return jmsckf.FrameFeatures(
            time=jnp.asarray(w["t"][k]), fid=jnp.asarray(w["fid"][k], jnp.int32),
            uv=jnp.asarray(w["uv"][k]), valid=jnp.asarray(w["valid"][k]),
        )
    return tmsckf.FrameFeatures(
        time=torch.as_tensor(w["t"][k]), fid=torch.as_tensor(w["fid"][k].astype(np.int32)),
        uv=torch.as_tensor(np.array(w["uv"][k])), valid=torch.as_tensor(np.array(w["valid"][k])),
    )


def _imu(w, k, lib):
    if lib == "jax":
        return jax.tree.map(lambda x: jnp.asarray(x[k]), w["batches"])
    return convert.from_numpy(jax.tree.map(lambda x: np.asarray(x[k]), w["batches"]))


def _assert_pose_and_cov(tpose, jpose, tstate, jstate):
    np.testing.assert_allclose(tpose.p.numpy(), np.asarray(jpose.p), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpose.q_xyzw.numpy(), np.asarray(jpose.q_xyzw), rtol=0, atol=1e-8)
    P = np.asarray(jstate.P)
    np.testing.assert_allclose(tstate.P.numpy(), P, rtol=0, atol=1e-6 * np.abs(P).max())


@pytest.mark.parametrize("method", METHODS)
def test_filter_step_methods_match_jax(world, jstep, tparams, method):
    """filter_step with exact solves under each method over the recorded
    frames, each implementation carrying its own state."""
    w = world
    step = jstep(method)
    jstate, tstate = w["state0"], convert.from_numpy(w["state0"])
    cams = []
    for k in range(N_FRAMES):
        jstate, jpose = step(jstate, _frame(w, k, "jax"), _imu(w, k, "jax"))
        tstate, tpose = tmsckf.filter_step(tstate, _frame(w, k, "torch"), _imu(w, k, "torch"), tparams, TCFG, method)
        _assert_pose_and_cov(tpose, jpose, tstate, jstate)
        assert int(tpose.num_cams) == int(jpose.num_cams)
        assert int(tpose.num_tracks) == int(jpose.num_tracks)
        np.testing.assert_array_equal(tstate.tracks.fid.numpy(), np.asarray(jstate.tracks.fid))
        np.testing.assert_array_equal(tstate.tracks.obs_valid.numpy(), np.asarray(jstate.tracks.obs_valid))
        cams.append(int(jpose.num_cams))
    assert sum(b < a for a, b in zip(cams, cams[1:])) >= 3  # the window was pruned


@pytest.fixture(scope="module")
def port_runs(world):
    """The port's run_sequence over the whole recorded sequence under each
    method (exact solves), and the Schur method with 10 Newton-Schulz
    iterations."""
    f, imu = world["feats"], world["imu"]
    out = {}
    for name, method, cfg in [(m, m, TCFG) for m in METHODS] + [("schur_ns10", "schur", TFilterConfig(**{**KW, "ns_iters": 10}))]:
        out[name] = trunner.run_sequence(
            cfg, T_CALIB, f.t, f.fid, f.uv, f.valid, imu.t, imu.gyro, imu.acc,
            method=method, chunk=30, device="cpu",
        )
    return out


def test_run_sequence_matches_jax(world, port_runs):
    """run_sequence (method 'qr', the default) over the whole sequence from
    a fresh state, against the JAX package's (chunked at 30 frames on both
    sides)."""
    f, imu = world["feats"], world["imu"]
    want = jrunner.run_sequence(JCFG, EUROC_CALIB, f.t, f.fid, f.uv, f.valid, imu.t, imu.gyro, imu.acc, chunk=30)
    got = port_runs["qr"]
    assert got.positions.shape == (len(f.t), 3)
    np.testing.assert_allclose(got.times, want.times, rtol=0, atol=0)
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.quats_xyzw, want.quats_xyzw, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.num_cams, want.num_cams)
    np.testing.assert_array_equal(got.num_tracks, want.num_tracks)
    P = np.asarray(want.final_state.P)
    np.testing.assert_allclose(got.final_state.P.numpy(), P, rtol=0, atol=1e-6 * np.abs(P).max())


def test_methods_agree_in_port(port_runs):
    """The port's methods against each other over the whole sequence,
    positions within 1e-4 m (tests/test_filter.py's bar)."""
    ref = port_runs["qr"].positions
    assert np.isfinite(ref).all()
    for name in ("cholesky", "schur", "schur_ns10"):
        diff = np.linalg.norm(port_runs[name].positions - ref, axis=1)
        assert diff.max() < 1e-4, (name, diff.max())


@pytest.fixture(scope="module")
def update_inputs(world, jparams, jstep):
    """Two lanes of lost-track update inputs: the JAX filter run to frames 10
    and 16, then propagated, augmented and observed for a frame that tracks
    nothing (so every track with three observations is a candidate), and
    the lost tracks selected and triangulated."""
    w = world

    @jax.jit
    def candidates(state, frame, imu):
        s = jmsckf._propagate_augment_observe(state, frame, imu, jparams)
        idx, obs_c, obs_valid_c, use, dof, pos, _, _ = jmsckf._lost_candidates(s, jparams, JCFG.max_update_tracks)
        return dict(state=s, pos=pos, obs=obs_c, mask=obs_valid_c & use[:, None], use=use, dof=dof)

    state, lanes = w["state0"], []
    for k in range(17):
        if k in (10, 16):
            blank = _frame(w, k, "jax")._replace(valid=jnp.zeros(w["valid"][k].shape, bool))
            lanes.append(jax.device_get(candidates(state, blank, _imu(w, k, "jax"))))
        state, _ = jstep("qr")(state, _frame(w, k, "jax"), _imu(w, k, "jax"))
    assert all(int(l["use"].sum()) >= 8 for l in lanes)
    return lanes


def _jac_args(lane, lib):
    s = lane["state"]
    if lib == "jax":
        return (jnp.asarray(lane["pos"]), jnp.asarray(lane["obs"]), jnp.asarray(lane["mask"]), s.cams,
                jnp.asarray(s.gravity))
    st = convert.from_numpy(s)
    return (torch.tensor(lane["pos"]), torch.tensor(lane["obs"]), torch.tensor(lane["mask"]), st.cams, st.gravity)


def _stack_lanes(lanes):
    """The port's (B, ...) arguments of the lanes."""
    per = [_jac_args(l, "torch") for l in lanes]
    out = []
    for i, first in enumerate(per[0]):
        items = [p[i] for p in per]
        if torch.is_tensor(first):
            out.append(torch.stack(items))
        else:
            out.append(type(first)(*(torch.stack(x) for x in zip(*items))))
    return out


def _close(got, want, what):
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale, err_msg=what)


def test_track_jacobians_gating_compression_match_jax(update_inputs, jparams, tparams):
    """track_jacobians, gating_scores and compress_measurements ('qr',
    'cholesky') of two lanes in one call against the JAX functions lane by
    lane, through the basis-free invariants, at 1e-9 relative; the raw
    projected rows equal too (same Householder convention)."""
    R, t = jparams.R_c0_c1, jparams.t_c0_c1
    pos, obs, mask, cams, grav = _stack_lanes(update_inputs)
    tj = tupdate.track_jacobians(pos, obs, mask, cams, grav, tparams.R_c0_c1, tparams.t_c0_c1)
    P = torch.stack([torch.as_tensor(np.asarray(l["state"].P)) for l in update_inputs])
    use = torch.stack([torch.tensor(l["use"]) for l in update_inputs])
    tgamma = tupdate.gating_scores(tj, P, tparams.sigma2).numpy()
    tcomp = {m: tupdate.compress_measurements(tj, use, m) for m in ("qr", "cholesky")}
    for b, lane in enumerate(update_inputs):
        jj = jupdate.track_jacobians(*_jac_args(lane, "jax"), R, t)
        H_o, r_o = np.asarray(jj.H_o), np.asarray(jj.r_o)
        gH_o, gr_o = tj.H_o[b].numpy(), tj.r_o[b].numpy()
        np.testing.assert_array_equal(tj.rows_valid[b].numpy(), np.asarray(jj.rows_valid))
        _close(np.einsum("krd,kre->kde", gH_o, gH_o), np.einsum("krd,kre->kde", H_o, H_o), "H_o^T H_o")
        _close(np.einsum("krd,kr->kd", gH_o, gr_o), np.einsum("krd,kr->kd", H_o, r_o), "H_o^T r_o")
        _close(gH_o, H_o, "raw H_o")
        _close(gr_o, r_o, "raw r_o")
        jgamma = np.asarray(jupdate.gating_scores(jj, jnp.asarray(lane["state"].P), jparams.sigma2))
        u = lane["use"]
        _close(tgamma[b][u], jgamma[u], "gamma")
        for m, (R_t, r_t) in tcomp.items():
            jR, jr = (np.asarray(x) for x in jupdate.compress_measurements(jj, jnp.asarray(u), m))
            gR, gr = R_t[b].numpy(), r_t[b].numpy()
            _close(gR.T @ gR, jR.T @ jR, f"{m}: R_t^T R_t")
            _close(gR.T @ gr, jR.T @ jr, f"{m}: R_t^T r_t")


@pytest.mark.parametrize("method", METHODS)
def test_gate_and_update_matches_jax(update_inputs, jparams, tparams, method):
    """One gate and update (exact solves) of the two lanes in one call, with
    the candidate cap ``max_update`` at 4 tracks, against the JAX function
    lane by lane: updated state and covariance at 1e-9 relative."""
    pos, obs, mask, cams, grav = _stack_lanes(update_inputs)
    tstate = convert.from_numpy(jax.tree.map(lambda *x: np.stack(x), *[l["state"] for l in update_inputs]))
    use = torch.stack([torch.tensor(l["use"]) for l in update_inputs])
    dof = torch.stack([torch.tensor(l["dof"]) for l in update_inputs])
    got = tmsckf._gate_and_update(tstate, tparams, method, pos, obs, mask, use, dof, max_update=4)
    for b, lane in enumerate(update_inputs):
        want = jmsckf._gate_and_update(
            lane["state"], jparams, method, jnp.asarray(lane["pos"]), jnp.asarray(lane["obs"]),
            jnp.asarray(lane["mask"]), jnp.asarray(lane["use"]), jnp.asarray(lane["dof"]), max_update=4,
        )
        P0 = np.asarray(lane["state"].P)
        _close(got.P[b].numpy(), np.asarray(want.P), "P")
        assert np.abs(np.asarray(want.P) - P0).max() > 1e-6 * np.abs(P0).max()  # an update happened
        for name in ("q", "p", "v", "bg", "ba"):
            _close(getattr(got.imu, name)[b].numpy(), np.asarray(getattr(want.imu, name)), name)
        _close(got.cams.p[b].numpy(), np.asarray(want.cams.p), "cams.p")


def test_not_positive_definite_gates_out():
    """A gating system that is not positive definite (a negative noise
    variance) gives gamma NaN in both packages and a gated-out track, and
    no exception in the port; lanes that factor are unaffected."""
    rng = np.random.default_rng(7)
    K, R, D = 5, 8, 27
    H = rng.normal(size=(K, R, D)) * 0.1
    r = rng.normal(size=(K, R))
    P = np.eye(D)
    jj = jupdate.TrackJacobians(H_o=jnp.asarray(H), r_o=jnp.asarray(r), rows_valid=jnp.ones((K, R), bool))
    want_bad = np.asarray(jupdate.gating_scores(jj, jnp.asarray(P), -1.0))
    tj = tupdate.TrackJacobians(torch.as_tensor(H)[None], torch.as_tensor(r)[None], torch.ones((1, K, R), dtype=torch.bool))
    got_bad = tupdate.gating_scores(tj, torch.as_tensor(P)[None], -1.0).numpy()[0]
    assert np.isnan(want_bad).all() and np.isnan(got_bad).all()
    thr = 10.0
    assert not (got_bad < thr).any() and not (want_bad < thr).any()
    good = tupdate.gating_scores(tj, torch.as_tensor(P)[None], 0.5).numpy()[0]
    _close(good, np.asarray(jupdate.gating_scores(jj, jnp.asarray(P), 0.5)), "gamma")
    # Lane by lane: a factor is NaN exactly where its matrix does not factor.
    A = torch.as_tensor(np.stack([np.eye(3), -np.eye(3), np.diag([1.0, 0.0, 1.0])]))
    L = tlinalg.cholesky_nan(A)
    assert torch.equal(L[0], torch.eye(3, dtype=torch.float64))
    assert torch.isnan(L[1]).all() and torch.isnan(L[2]).all()
    X = tlinalg.solve_nan(torch.stack([torch.eye(2, dtype=torch.float64), torch.zeros(2, 2, dtype=torch.float64)]),
                          torch.ones(2, 2, 1, dtype=torch.float64))
    assert torch.equal(X[0], torch.ones(2, 1, dtype=torch.float64)) and torch.isnan(X[1]).all()


def _random_state(rng):
    """tests/test_propagation_parallel.py's random state: a diverged FEJ
    shadow and a dense covariance."""
    cfg = FilterConfig(max_cam_state_size=8, max_tracks=16, max_imu_per_frame=16)
    state = init_filter_state(cfg, EUROC_CALIB, jnp.float64)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    qn = q + rng.normal(size=4) * 0.01
    qn /= np.linalg.norm(qn)
    imu = state.imu._replace(
        q=jnp.asarray(q), v=jnp.asarray(rng.normal(size=3)), p=jnp.asarray(rng.normal(size=3)),
        bg=jnp.asarray(rng.normal(size=3) * 0.01), ba=jnp.asarray(rng.normal(size=3) * 0.05),
        q_null=jnp.asarray(qn), v_null=jnp.asarray(rng.normal(size=3)), p_null=jnp.asarray(rng.normal(size=3)),
        time=jnp.asarray(10.0),
    )
    D = state.P.shape[0]
    A = rng.normal(size=(D, D)) * 0.01
    return cfg, state._replace(imu=imu, P=jnp.asarray(A @ A.T + np.eye(D) * 0.1),
                               gravity=jnp.asarray([0.0, 0.0, -9.81]))


def _random_batch(rng, pattern, L=16):
    t = 10.0 + np.cumsum(rng.uniform(0.003, 0.007, L))
    valid = np.ones(L, bool)
    if pattern == "trailing":
        valid[L - 4:] = False
    elif pattern == "interleaved":
        valid[[2, 5, 9]] = False
    elif pattern == "nonincreasing":
        t[3] = t[2] - 0.001
    elif pattern == "all_masked":
        valid[:] = False
    return jprop.ImuBatch(time=jnp.asarray(t), gyro=jnp.asarray(rng.normal(size=(L, 3)) * 0.3),
                          acc=jnp.asarray(rng.normal(size=(L, 3)) + [0, 0, 9.81]), valid=jnp.asarray(valid))


def _assert_propagated(got, want, what):
    for name in ("q", "v", "p", "q_null", "v_null", "p_null", "time"):
        np.testing.assert_allclose(getattr(got.imu, name).numpy(), np.asarray(getattr(want.imu, name)),
                                   rtol=1e-11, atol=1e-11, err_msg=f"{what}:{name}")
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), rtol=1e-9, atol=1e-11, err_msg=f"{what}:P")


@pytest.mark.parametrize("pattern", ["full", "trailing", "interleaved", "nonincreasing", "all_masked"])
def test_propagate_sequential_matches_jax(pattern):
    """The port's sample-by-sample propagation against JAX's
    propagate_sequential, and against the port's own prefix-scan
    propagate, with tests/test_propagation_parallel.py's patterns and
    tolerances (1e-11 on the IMU state, covariance rtol 1e-9 atol 1e-11);
    process_model_step against JAX's on the first sample."""
    rng = np.random.default_rng(["full", "trailing", "interleaved", "nonincreasing", "all_masked"].index(pattern) + 3)
    cfg, state = _random_state(rng)
    batch = _random_batch(rng, pattern)
    Q = jmsckf.make_params(cfg, EUROC_CALIB, jnp.float64).Q_imu
    tstate, tbatch, tQ = convert.from_numpy(jax.device_get(state)), convert.from_numpy(jax.device_get(batch)), \
        torch.as_tensor(np.asarray(Q))
    want = jax.jit(jprop.propagate_sequential)(state, batch, Q)
    seq = tprop.propagate_sequential(tstate, tbatch, tQ)
    _assert_propagated(seq, want, f"{pattern} vs JAX")
    _assert_propagated(tprop.propagate(tstate, tbatch, tQ), convert.to_numpy(seq), f"{pattern} scan vs sequential")
    one = jprop.process_model_step(state, batch.time[0], batch.gyro[0], batch.acc[0], Q, batch.valid[0])
    got = tprop.process_model_step(tstate, tbatch.time[0], tbatch.gyro[0], tbatch.acc[0], tQ, tbatch.valid[0])
    _assert_propagated(got, one, f"{pattern} process_model_step")


def test_reset_filter(world, tparams):
    """reset_filter (tests/test_recovery.py's check) on a state the port's
    filter has driven away from its start: everything but gravity equals a
    fresh init_state and the JAX package's reset of the same state, and
    the reset state steps cleanly under 'cholesky'."""
    w = world
    tstate = convert.from_numpy(w["state0"])
    for k in range(8):
        tstate, _ = tmsckf.filter_step(tstate, _frame(w, k, "torch"), _imu(w, k, "torch"), tparams, TCFG, "cholesky")
    tstate = tstate._replace(gravity=torch.tensor([0.01, -0.02, -9.79], dtype=torch.float64))
    assert int(tstate.num_cams) > 0 and int((tstate.tracks.fid >= 0).sum()) > 0
    r = tmsckf.reset_filter(tstate, TCFG, T_CALIB)
    fresh = tmsckf.init_state(TCFG, T_CALIB, torch.float64, device="cpu")._replace(gravity=r.gravity)
    np.testing.assert_array_equal(r.gravity.numpy(), [0.01, -0.02, -9.79])
    jr = jmsckf.reset_filter(jax.tree.map(jnp.asarray, convert.to_numpy(tstate)), JCFG, EUROC_CALIB)
    for a, b, c in zip(jax.tree.leaves(convert.to_numpy(r)), jax.tree.leaves(convert.to_numpy(fresh)),
                       jax.tree.leaves(jax.device_get(jr))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    r2, pose = tmsckf.filter_step(r, _frame(w, 8, "torch"), _imu(w, 8, "torch"), tparams, TCFG, "cholesky")
    assert np.isfinite(pose.p.numpy()).all() and int(r2.num_cams) == 1


def test_method_defaults_match_jax():
    """Every ported driver's ``method`` default is the JAX function's."""
    from msckf_stereo_c_torch.models import vio as tvio
    from msckf_stereo_c_torch.parallel import vio_multiseq as tmulti
    from msckf_stereo_c_torch.sim import stress as tstress
    from msckf_stereo_c_tpu.models import vio as jvio
    from msckf_stereo_c_tpu.parallel import vio_multiseq as jmulti
    from msckf_stereo_c_tpu.sim import stress as jstress

    pairs = [
        (tmsckf.filter_step, jmsckf.filter_step), (tmsckf.filter_internals, jmsckf.filter_internals),
        (tvio.vio_step, jvio.vio_step), (tvio.vio_step_internals, jvio.vio_step_internals),
        (tvio.run_vio_sequence, jvio.run_vio_sequence), (trunner.run_sequence, jrunner.run_sequence),
        (tstress.run_stress_gate, jstress.run_stress_gate), (tmulti.run_vio_batch, jmulti.make_sharded_vio_runner),
    ]
    for mine, theirs in pairs:
        got = inspect.signature(mine).parameters["method"].default
        assert got == inspect.signature(theirs).parameters["method"].default, mine.__name__


def test_new_entry_points_need_a_device_or_cuda(monkeypatch, world):
    """run_sequence, init_state, run_stress_lanes and the stress script
    default to the card; without CUDA they raise unless the caller names a
    device (the script: STRESS_PLATFORM=cpu)."""
    from msckf_stereo_c_torch.scripts import stress_gate as tgate
    from msckf_stereo_c_torch.sim import stress as tstress

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f, imu = world["feats"], world["imu"]
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run_sequence(TCFG, T_CALIB, f.t[:2], f.fid[:2], f.uv[:2], f.valid[:2], imu.t, imu.gyro, imu.acc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmsckf.init_state(TCFG, T_CALIB)
    assert tmsckf.init_state(TCFG, T_CALIB, device="cpu").P.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        tstress.run_stress_lanes([0, 1], duration=0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgate.main({"STRESS_DURATION": "0.3"}, argv=[])
