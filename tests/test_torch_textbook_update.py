"""The port's textbook update (``method='qr'``: null-space projection,
chi-square gate, QR compression and exact gain) against its plain reference
``msckf_stereo_c_torch/reference/textbook_update.py``, written out lane by
lane and track by track in float64; the compression's plain path and the
``qr_compress`` kernel's arithmetic (in numpy); and the textbook update's
spans.

The states are seeded and random at a small size: B=3 lanes of M=4 camera
slots (4, 3 and 4 of them active), K=5 tracks a lane observed from 2 to 4
cameras looking at points 3-6 m ahead, with 1e-3 noise on the normalised
observations.  Lane 1 selects no track, and one track of lane 0 carries
0.2-sized observation errors that its gate rejects.  Both of the port's
calls are held: the lost-track update (each track's observations, dof
n - 1) and the camera prune's full-width one (the observations in the two
pruned slots, dof 2)."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from msckf_stereo_c_torch.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c_torch.models import msckf as tmsckf
from msckf_stereo_c_torch.models import update as tupdate
from msckf_stereo_c_torch.models.state import init_filter_state
from msckf_stereo_c_torch.ops import linalg as tlinalg
from msckf_stereo_c_torch.reference import textbook_update as ref
from msckf_stereo_c_torch.utils.lanes import map_tree, stack_lanes
from msckf_stereo_c_torch.utils.quaternion import jpl_to_rot, quat_multiply, small_angle_quaternion

torch.set_num_threads(1)

B, M, K = 3, 4, 5
NUM_CAMS = (4, 3, 4)
EMPTY_LANE, REJECTED = 1, (0, 4)
SEEDS = (0, 1, 2)
# Float64: the port and the reference compute the same quantities in other
# orders (batched einsums, Householder null-space bases against complete
# QRs, a square-root gain against (I - KH)P): rounding, far below 1e-9 of
# each quantity's scale.
F64_RTOL = 1e-9
# Float32 port against the float64 reference on the same (float32) inputs:
# the widest gaps over seeds 0-5 and the three calls read 1.2e-7 (P, over
# its largest entry) and 2.0e-6 (state, over each quantity's largest
# entry); the limits keep about 16x and 10x of room, and stay far under a
# wrong update's gap (order 1: the update moves P by more than 1e-3).
F32_RTOL = {"P": 2e-6, "state": 2e-5}


def _small_angle(rng, scale):
    return small_angle_quaternion(torch.as_tensor(rng.normal(size=3) * scale))


def _project(q, p, p_w, R01, t01):
    R_w_c0 = jpl_to_rot(q)
    R_w_c1 = R01 @ R_w_c0
    p_c0 = R_w_c0 @ (p_w - p)
    p_c1 = R_w_c1 @ (p_w - (p - R_w_c1.T @ t01))
    return torch.cat([p_c0[:2] / p_c0[2], p_c1[:2] / p_c1[2]])


def _problem(seed, call):
    """(state, params, pos, obs, obs_mask, use, dof, weight) of one seeded
    gate-and-update call in float64."""
    rng = np.random.default_rng(seed)
    cfg = FilterConfig(max_cam_state_size=M, max_tracks=K, ns_iters=0)
    params = tmsckf.make_params(cfg, EUROC_CALIB, torch.float64, "cpu")
    R01, t01 = params.R_c0_c1, params.t_c0_c1
    D = 21 + 6 * M
    lanes, pos, obs, mask, use, dof = [], [], [], [], [], []
    for b in range(B):
        N = NUM_CAMS[b]
        s = init_filter_state(cfg, EUROC_CALIB, torch.float64, "cpu")
        q = torch.stack([_small_angle(rng, 0.05) for _ in range(M)])
        p = torch.as_tensor(np.c_[0.2 * np.arange(M), 0.05 * rng.normal(size=(M, 2))])
        cams = s.cams._replace(
            q=q, p=p, q_null=torch.stack([quat_multiply(_small_angle(rng, 0.01), q[i]) for i in range(M)]),
            p_null=p + torch.as_tensor(0.01 * rng.normal(size=(M, 3))))
        imu = s.imu._replace(
            q=_small_angle(rng, 0.6), bg=torch.as_tensor(1e-3 * rng.normal(size=3)),
            v=torch.as_tensor(rng.normal(size=3)), ba=torch.as_tensor(1e-2 * rng.normal(size=3)),
            p=torch.as_tensor(rng.normal(size=3)), R_imu_cam0=jpl_to_rot(_small_angle(rng, 0.1)) @ s.imu.R_imu_cam0,
            t_cam0_imu=torch.as_tensor(0.05 * rng.normal(size=3)))
        Da = 21 + 6 * N
        A = rng.normal(size=(Da, Da))
        P = torch.zeros((D, D), dtype=torch.float64)
        P[:Da, :Da] = torch.as_tensor(1e-4 * A @ A.T / Da + 1e-6 * np.eye(Da))
        lanes.append(s._replace(imu=imu, cams=cams, num_cams=torch.tensor(N, dtype=torch.int32), P=P))

        p_w = torch.as_tensor(np.c_[rng.uniform(-1, 1, (K, 2)), rng.uniform(3, 6, K)])
        o = torch.zeros((K, M, 4), dtype=torch.float64)
        m = torch.zeros((K, M), dtype=torch.bool)
        for k in range(K):
            if call == "prune":
                slots = [0, 1]
            else:
                slots = sorted(rng.choice(N, size=int(rng.integers(2, min(4, N) + 1)), replace=False))
            for i in slots:
                o[k, i] = _project(q[i], p[i], p_w[k], R01, t01) + torch.as_tensor(1e-3 * rng.normal(size=4))
                m[k, i] = True
            if (b, k) == REJECTED:
                o[k] += torch.as_tensor(0.2 * rng.normal(size=(M, 4)))
        u = torch.ones(K, dtype=torch.bool) if b != EMPTY_LANE else torch.zeros(K, dtype=torch.bool)
        pos.append(p_w + torch.as_tensor(0.01 * rng.normal(size=(K, 3))))
        obs.append(o)
        mask.append(m & u[:, None])
        use.append(u)
        n = m.sum(1)
        dof.append(torch.clamp(n - 1, 1, 99) if call != "prune" else n)
    weight = None
    if call == "weighted":
        weight = torch.as_tensor(rng.uniform(0.2, 1.0, (B, K)))
    return (stack_lanes(lanes), params, torch.stack(pos), torch.stack(obs), torch.stack(mask), torch.stack(use),
            torch.stack(dof), weight)


def _cast(tree, dtype):
    return map_tree(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def _reference(state, params, pos, obs, mask, use, dof, weight):
    f = state.imu
    return ref.textbook_update(
        state.P, dict(q=f.q, bg=f.bg, v=f.v, ba=f.ba, p=f.p, R_imu_cam0=f.R_imu_cam0, t_cam0_imu=f.t_cam0_imu),
        dict(q=state.cams.q, p=state.cams.p, q_null=state.cams.q_null, p_null=state.cams.p_null), state.num_cams,
        state.gravity, params.R_c0_c1, params.t_c0_c1, params.sigma2, pos, obs, mask, use,
        params.chi2_table[dof], weight)


def _gap(got, want):
    """Widest gap over the largest entry of ``want``."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _gaps(seed, call, dtype):
    """Per compared quantity, the port's (in ``dtype``) widest gap to the
    reference (float64, on the port's inputs) over its scale; and the
    reference's result."""
    state, params, pos, obs, mask, use, dof, weight = _problem(seed, call)
    state, params, pos, obs = (_cast(x, dtype) for x in (state, params, pos, obs))
    w = None if weight is None else weight.to(dtype)
    got = tmsckf._gate_and_update(state, params, "qr", pos, obs, mask, use, dof, w=w)
    want = _reference(state, params, pos, obs, mask, use, dof, w)
    jacs = tupdate.track_jacobians(pos, obs, mask, state.cams, state.gravity, params.R_c0_c1, params.t_c0_c1)
    if w is not None:
        sw = torch.sqrt(w)
        jacs = jacs._replace(H_o=jacs.H_o * sw[..., None, None], r_o=jacs.r_o * sw[..., None])
    gamma = tupdate.gating_scores(jacs, state.P, params.sigma2)
    gaps = {"gamma": _gap(gamma[use], want["gamma"][use])}
    for b in range(B):
        Da = 21 + 6 * NUM_CAMS[b]
        gaps[f"P{b}"] = _gap(got.P[b, :Da, :Da], want["P"][b, :Da, :Da])
        for name in ("q", "bg", "v", "ba", "p", "R_imu_cam0", "t_cam0_imu"):
            gaps[f"{name}{b}"] = _gap(getattr(got.imu, name)[b], want["imu"][name][b])
        for name in ("q", "p"):
            gaps[f"cam_{name}{b}"] = _gap(getattr(got.cams, name)[b, :NUM_CAMS[b]],
                                          want["cams"][name][b, :NUM_CAMS[b]])
    passed = (gamma < params.chi2_table[dof]) & use
    return gaps, want, passed, state


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("call,dtype", [("lost", torch.float64), ("prune", torch.float64),
                                        ("weighted", torch.float64), ("lost", torch.float32),
                                        ("prune", torch.float32)])
def test_gate_and_update_matches_the_textbook_update(seed, call, dtype):
    """``_gate_and_update(method='qr')`` of three lanes in one call against
    the reference lane by lane: the gating scores, the gate's decisions, the
    posterior covariance over each lane's active block and the corrected
    nominal state; the empty lane unchanged and the bad track rejected in
    both."""
    gaps, want, passed, state = _gaps(seed, call, dtype)
    rtol = F64_RTOL if dtype == torch.float64 else None
    for name, gap in gaps.items():
        limit = rtol or (F32_RTOL["P"] if name[0] == "P" else F32_RTOL["state"])
        assert gap <= limit, (name, gap)
    assert torch.equal(passed, want["passed"])
    assert not bool(want["passed"][REJECTED]) and torch.isfinite(want["gamma"][REJECTED])
    assert not bool(want["passed"][EMPTY_LANE].any())
    assert bool(want["passed"].sum(1)[[0, 2]].ge(1).all())
    P0 = state.P.double()
    moved = (want["P"] - P0).abs().amax((-2, -1)) / P0.abs().amax((-2, -1))
    assert float(moved[EMPTY_LANE]) == 0.0 and bool((moved[[0, 2]] > 1e-3).all())


def _jacs(seed, rows=12, D=10, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    H = torch.randn((B, K, rows, D), generator=g, dtype=dtype)
    H[..., 2] = 0.0  # a column no row reaches
    H[..., 5] = H[..., 4]  # a rank-deficient pair
    H[:, :, rows - 3:] = 0.0  # zero padding rows
    r = torch.randn((B, K, rows), generator=g, dtype=dtype)
    r[:, :, rows - 3:] = 0.0
    use = torch.ones((B, K), dtype=torch.bool)
    use[EMPTY_LANE] = False
    use[0, 1] = False
    return tupdate.TrackJacobians(H_o=H, r_o=r, rows_valid=torch.ones((B, K, rows), dtype=torch.bool)), use


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_plain_compression_keeps_the_normal_equations(dtype, rtol):
    """``compress_measurements('qr')`` on the CPU (``torch.linalg.qr``, the
    kernel's plain version): R_t^T R_t = H^T H and R_t^T r_t = H^T r over
    the selected tracks, with zero rows, a zero column and a rank-deficient
    pair of columns; a lane that selects nothing gives R_t = 0 and r_t = 0.
    Tolerances: a few eps of float64, and of float32 times sqrt(m)."""
    jacs, use = _jacs(3, dtype=dtype)
    R_t, r_t = tupdate.compress_measurements(jacs, use, "qr")
    m = use.to(dtype)[..., None, None]
    H = (jacs.H_o * m).flatten(1, 2).double()
    r = (jacs.r_o * m[..., 0]).flatten(1, 2).double()
    R_t, r_t = R_t.double(), r_t.double()
    HtH = H.transpose(-1, -2) @ H
    Htr = (H.transpose(-1, -2) @ r[..., None])[..., 0]
    scale = HtH.abs().amax((-2, -1), keepdim=True).clamp_min(1e-300)
    assert float(((R_t.transpose(-1, -2) @ R_t - HtH).abs() / scale).max()) <= rtol
    got = (R_t.transpose(-1, -2) @ r_t[..., None])[..., 0]
    assert float(((got - Htr).abs() / scale[..., 0]).max()) <= rtol
    assert bool((R_t[EMPTY_LANE] == 0).all()) and bool((r_t[EMPTY_LANE] == 0).all())
    assert bool((R_t[:, :, 2].abs() <= rtol * scale[:, :, 0]).all())  # the unreached column


def _kernel_in_numpy(A, chunk):
    """``csrc/qr_compress.cu``'s arithmetic on one (m, n) matrix, in the
    matrix's dtype: R grown by ``chunk`` rows at a time, one dlarfg
    reflector per column over R[j][j] and the chunk's column j."""
    dt = A.dtype.type
    m, n = A.shape
    R = np.zeros((n, n), A.dtype)
    for r0 in range(0, m, chunk):
        X = np.zeros((chunk, n), A.dtype)
        X[: min(chunk, m - r0)] = A[r0: r0 + chunk]
        for j in range(n):
            x, alpha = X[:, j], R[j, j]
            ss = dt(np.sum(x * x))
            if not ss == 0:  # a NaN sum forms a NaN reflector
                nrm = np.sqrt(alpha * alpha + ss)
                beta = -nrm if alpha >= 0 else nrm
                tau = (beta - alpha) / beta
                v = x * (dt(1) / (alpha - beta))
                R[j, j] = beta
                tw = tau * (R[j, j + 1:] + v @ X[:, j + 1:])
                R[j, j + 1:] -= tw
                X[:, j + 1:] -= np.outer(v, tw)
    return R


@pytest.mark.parametrize("dtype,chunk,rtol", [(np.float32, 64, 2e-6), (np.float64, 32, 1e-13)])
def test_qr_compress_arithmetic_keeps_the_normal_equations(dtype, chunk, rtol):
    """The kernel's algorithm in numpy on ``chip_smoke.qr_problem`` rows
    (80 rows: a last chunk that is partly past the matrix in float32, two
    and a half in float64): R upper triangular with R^T R = A^T A to
    rounding (eps times sqrt(m) in float32, a few eps in float64), the
    empty lane's R exactly zero, and R^T R as the plain version's."""
    A = chip_smoke.qr_problem(3, 5, 4, seed=5, dtype=torch.float64)
    plain = tlinalg.qr_r_reference(A)
    for b in range(3):
        Ab = A[b].numpy()
        R = _kernel_in_numpy(Ab.astype(dtype), chunk)
        assert np.array_equal(R, np.triu(R))
        G = Ab.T @ Ab
        scale = max(np.abs(G).max(), 1e-300)
        assert np.abs(R.T.astype(np.float64) @ R - G).max() <= rtol * scale
        Rp = plain[b].numpy()
        assert np.abs(R.T.astype(np.float64) @ R - Rp.T @ Rp).max() <= rtol * scale
        if b == 0:
            assert not R.any()


def test_qr_compress_arithmetic_spreads_nan_as_its_plain_version():
    """A NaN in a lane's rows makes that lane's R non-finite, in the
    kernel's arithmetic (in numpy) as in the plain version (LAPACK), and
    leaves every other lane finite: a row of NaN, a single NaN entry in the
    last chunk, and a NaN row in a lane that is otherwise empty."""
    A = chip_smoke.qr_problem(5, 5, 4, seed=7, dtype=torch.float64)
    A[1, 3, :] = float("nan")
    A[2, 70, 30] = float("nan")
    A[0, 5, :] = float("nan")
    plain = tlinalg.qr_r_reference(A)
    want = [bool(torch.isfinite(plain[b]).all()) for b in range(5)]
    assert want == [False, False, False, True, True]
    with np.errstate(invalid="ignore"):
        got = [bool(np.isfinite(_kernel_in_numpy(A[b].numpy().astype(np.float32), 64)).all()) for b in range(5)]
    assert got == want


def _nonzero_counts(A):
    nz = (A != 0).numpy()
    return np.stack([nz.any(-1).sum(-1), nz.any(-2).sum(-1)], -1)


def test_qr_r_logs_its_work_only_while_a_profiler_records():
    """On the CPU ``qr_r`` logs each call's per-lane rows and columns that
    hold a nonzero (or NaN) entry, with the element size, while a profiler
    records, and nothing otherwise; R is the same either way."""
    A = chip_smoke.qr_problem(4, 5, 4, seed=3, dtype=torch.float64)
    A[2, 78, 0] = float("nan")  # a zero row and an IMU column gain a NaN
    before = len(tlinalg.qr_work_log)
    plain = tlinalg.qr_r(A)
    assert len(tlinalg.qr_work_log) == before
    with profile(activities=[ProfilerActivity.CPU]):
        R = tlinalg.qr_r(A)
        tlinalg.qr_r(A[1:3].float())
    assert torch.equal(R.nan_to_num(), plain.nan_to_num())
    (W, elem), (W2, elem2) = list(tlinalg.qr_work_log)[-2:]
    want = _nonzero_counts(A)
    assert W.dtype == torch.int32 and (elem, elem2) == (8, 4)
    assert np.array_equal(W.numpy(), want) and np.array_equal(W2.numpy(), want[1:3])
    assert want[0].tolist() == [0, 0] and want[2, 1] == _nonzero_counts(A[2:3].nan_to_num())[0, 1] + 1


def _span_names(method):
    state, params, pos, obs, mask, use, dof, _ = _problem(0, "lost")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tmsckf._gate_and_update(state, params, method, pos, obs, mask, use, dof)
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith("filter.")]


def test_the_textbook_update_opens_its_spans():
    """Under a profiler the 'qr' update opens ``filter.nullspace``, then
    ``filter.gating``, then ``filter.update`` with ``filter.compress``
    inside it, once each; the Schur update opens none of the three new
    ones."""
    names = _span_names("qr")
    assert [n for n, _, _ in names] == ["filter.nullspace", "filter.gating", "filter.update", "filter.compress"]
    (_, n0, n1), (_, g0, g1), (_, u0, u1), (_, c0, c1) = names
    assert n1 <= g0 and g1 <= u0 and u0 <= c0 and c1 <= u1
    schur = {n for n, _, _ in _span_names("schur")}
    assert schur == {"filter.schur_gating", "filter.update"}
