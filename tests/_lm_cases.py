"""Windows of triangulation problems, and the comparison that holds the
hand kernel ``lm_triangulate`` to its plain version
(``models/triangulation.py:triangulate_tracks_reference``).  Shared by the
CPU tests, the card tests and ``chip_smoke.py``.

The kernel runs over at least ``LM_POOL_TRACKS`` tracks, one call per B
lanes of a larger window at a small B (``lm_pool``, ``lm_kernel_calls``),
so no share is read from a few dozen tracks.  The plain version moved by
one machine epsilon of its observations (``lm_nudged``) is the yardstick
for what rounding alone does; on the H100 over 16,384-track windows of
M = 20 and 40 it reads, against itself (PERF.md §6):

- float64: steps and ``valid`` equal on every track, but 0.03-0.25 % of
  the positions more than 1e-8 m apart and up to 4.8e-7 m (the least
  determined tracks amplify rounding);
- float32: the loop's end sits at rounding (|delta| <= 5e-7 against a
  rounding floor of about 1e-7 in inverse depth, and a step rejected at
  rounding raises lambda until the step is that small), so the steps
  differ on 3-9 % of the tracks, 0.06-0.5 % of the converged positions lie
  more than 1e-4 m apart, and the widest converged gap is 0.6 mm to 15 cm.

So the kernel is held, in float64, to base slots, ``valid`` and steps
equal on every track, positions within 1e-8 m on ``LM_F64_NEAR`` of the
tracks valid in both and within ``LM_F64_WIDEST_M`` on every one; in
float32, to base slots exact, ``valid`` on ``LM_VALID_AGREE`` of the
tracks, and no more than twice the nudged spread plus ``LM_SLACK`` in the
share of tracks whose steps differ, in the share of converged positions
beyond 1e-4 m, and in the widest converged gap (against the widest of
``LM_NUDGES`` nudges, as one nudge's widest is a single draw from a heavy
tail)."""
from __future__ import annotations

LM_CAP = 30  # the LM loop's step cap (models/triangulation.py:_LM_ITERS)
LM_POS_TOL = {"float32": 1e-4, "float64": 1e-8}
LM_F64_NEAR = 0.99  # float64: the share of positions within 1e-8 m (the kernel read 99.56 % or more)
LM_F64_WIDEST_M = 1e-6  # float64: every position (the kernel read 1.4e-7 m at most, the nudged plain 4.8e-7)
LM_VALID_AGREE = 0.999
LM_SLACK = {"steps": 0.01, "far": 0.001, "widest_m": 0.01}
LM_NUDGES = 3
LM_POOL_TRACKS = 16384  # the 512-lane cells' tracks a call


def lm_problem(B: int, K0: int, M: int, seed: int = 0, dtype=None, device=None, hard: bool = True):
    """(obs, obs_valid, cam_q, cam_p, R_c0_c1, t_c0_c1, active) of B lanes
    of K0 tracks over windows of M cameras walking about 0.1 m a slot: each
    track a landmark 1.5-8 m ahead seen in a random 2..M of the slots, its
    stereo-normalized observations with 1e-3 noise.  With ``hard`` also:
    tracks with one observation and with none, landmarks behind the
    cameras, NaN observations on valid slots, NaN observations on every
    slot without one, and every fourth lane outside ``active`` (as the
    camera prune passes the lanes it keeps)."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.utils.lie import so3_exp
    from msckf_stereo_c_torch.utils.quaternion import rot_to_jpl

    rng = np.random.default_rng(seed)
    C = so3_exp(torch.as_tensor(rng.normal(0, 0.05, (B, M, 3)))).numpy()  # world -> camera
    p = np.cumsum(rng.normal(0, 0.06, (B, M, 3)) + [0.08, 0.0, 0.0], axis=1)
    R01 = so3_exp(torch.as_tensor([0.002, -0.003, 0.001])).numpy()
    t01 = np.array([-0.11, 0.0005, 0.0])
    lm = p[:, :1, :] + np.stack([rng.uniform(-1.5, 1.5, (B, K0)), rng.uniform(-1.0, 1.0, (B, K0)),
                                 rng.uniform(1.5, 8.0, (B, K0))], -1)  # (B, K0, 3)
    pc0 = np.einsum("bmij,bkmj->bkmi", C, lm[:, :, None, :] - p[:, None, :, :])  # (B, K0, M, 3)
    pc1 = pc0 @ R01.T + t01
    obs = np.concatenate([pc0[..., :2] / pc0[..., 2:], pc1[..., :2] / pc1[..., 2:]], -1)
    obs = obs + rng.normal(0, 1e-3, obs.shape)
    valid = np.zeros((B, K0, M), bool)
    n = rng.integers(2, M + 1, (B, K0))
    for b in range(B):
        for k in range(K0):
            valid[b, k, rng.choice(M, size=n[b, k], replace=False)] = True
    active = np.ones(B, bool)
    if hard:
        kind = rng.integers(0, 40, (B, K0))
        one = kind == 0  # a single observation
        valid[one] = False
        valid[one, rng.integers(0, M, int(one.sum()))] = True
        valid[kind == 1] = False  # no observation
        behind = kind == 2  # a landmark behind the window: projected with the sign of its depth
        obs[behind] = -obs[behind]
        nan = (kind == 3)[..., None] & valid & (rng.uniform(size=valid.shape) < 0.3)
        obs[nan] = np.nan
        obs[(kind == 4)[..., None] & ~valid] = np.nan  # NaN where the slot holds no observation
        active[3::4] = False
    dtype = dtype or torch.float32
    q = rot_to_jpl(torch.as_tensor(C)).numpy()

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    return (t(obs), t(valid, torch.bool), t(q), t(p), t(R01), t(t01), t(active, torch.bool))


def lm_pool(B: int, K0: int, M: int, seed: int = 0, dtype=None, device=None):
    """``lm_problem`` of a whole number of B-lane calls holding at least
    ``LM_POOL_TRACKS`` tracks (B lanes when B * K0 reaches it)."""
    calls = max(1, -(-LM_POOL_TRACKS // (B * K0)))
    return lm_problem(B * calls, K0, M, seed=seed, dtype=dtype, device=device)


def lm_kernel_calls(args, B: int):
    """``triangulate_tracks`` on the window ``args``, one call per B lanes,
    while a profiler records: (the calls' results joined along the lanes,
    their per-track steps from ``lm_work_log`` joined, the number of
    calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from msckf_stereo_c_torch.models import triangulation as tri

    lanes = args[0].shape[0]
    parts, steps = [], []
    with profile(activities=[ProfilerActivity.CPU]):
        for b in range(0, lanes, B):
            sub = tuple(x if i in (4, 5) else x[b:b + B] for i, x in enumerate(args))
            parts.append(tri.triangulate_tracks(*sub))
            steps.append(tri.lm_work_log[-1])
    got = tri.TriangulationResult(*(torch.cat(xs) for xs in zip(*parts)))
    return got, torch.cat(steps), len(parts)


def lm_compare(a, b, a_steps, b_steps, tol: float) -> dict:
    """Two triangulations of the same tracks: {tracks, held (the tracks
    valid and under the step cap in both), valid_agree, steps_agree,
    base_slot_equal, far_share (of the held tracks, those whose positions
    lie more than ``tol`` apart), max_pos_gap_m (over the held tracks),
    max_gap_valid_m (over every track valid in both), max_steps}."""
    import torch

    n = a.valid.numel()
    both = a.valid & b.valid
    held = both & (a_steps < LM_CAP) & (b_steps < LM_CAP)
    gaps = (a.pos_w.double() - b.pos_w.double()).norm(dim=-1)
    gap, gap_valid = gaps[held], gaps[both]
    return dict(
        tracks=n, held=gap.numel(), valid_agree=float((a.valid == b.valid).sum()) / max(n, 1),
        steps_agree=float((a_steps == b_steps).sum()) / max(n, 1),
        base_slot_equal=bool(torch.equal(a.base_slot, b.base_slot)),
        far_share=float((gap > tol).sum()) / max(gap.numel(), 1),
        max_pos_gap_m=float(gap.max()) if gap.numel() else 0.0,
        max_gap_valid_m=float(gap_valid.max()) if gap_valid.numel() else 0.0,
        max_steps=int(torch.maximum(a_steps, b_steps).max()) if n else 0)


def lm_nudged(obs, seed: int = 0):
    """``obs`` moved by one machine epsilon, relative, with a random sign
    an entry drawn from ``seed``."""
    import torch

    g = torch.Generator(device=obs.device).manual_seed(seed)
    sign = torch.randint(0, 2, obs.shape, generator=g, device=obs.device).to(obs.dtype) * 2 - 1
    return obs * (1 + sign * torch.finfo(obs.dtype).eps)


def lm_hold(args, got, got_steps):
    """The kernel's ``got`` and its per-track steps on ``args`` against the
    plain version, beside the plain version against itself on ``lm_nudged``
    observations, by the bars of the module's docstring.  Returns (kernel
    row, nudge row: the first nudge's, with ``widest_of_nudges_m``,
    failures: a list of what missed)."""
    import torch

    from msckf_stereo_c_torch.models import triangulation as tri

    dname = str(args[0].dtype).split(".")[-1]
    tol = LM_POS_TOL[dname]
    steps = torch.empty_like(got_steps)
    plain = tri.triangulate_tracks_reference(*args, iters=steps)
    k = lm_compare(got, plain, got_steps, steps, tol)
    rows = []
    for seed in range(LM_NUDGES if dname == "float32" else 1):
        n_steps = torch.empty_like(got_steps)
        nudged = tri.triangulate_tracks_reference(lm_nudged(args[0], seed), *args[1:], iters=n_steps)
        rows.append(lm_compare(nudged, plain, n_steps, steps, tol))
    n = dict(rows[0], widest_of_nudges_m=max(r["max_pos_gap_m"] for r in rows))
    missed = []
    if not k["base_slot_equal"]:
        missed.append("base slots differ")
    if dname == "float64":
        both = got.valid & plain.valid
        gap = (got.pos_w - plain.pos_w).norm(dim=-1)[both]
        near = float((gap <= tol).sum()) / max(gap.numel(), 1)
        if k["valid_agree"] < 1:
            missed.append(f"valid agrees on {k['valid_agree']:.6f} of the tracks")
        if k["steps_agree"] < 1:
            missed.append(f"steps agree on {k['steps_agree']:.6f} of the tracks")
        if near < LM_F64_NEAR:
            missed.append(f"{near:.5f} of the positions within {tol:g} m")
        if k["max_gap_valid_m"] > LM_F64_WIDEST_M:
            missed.append(f"positions {k['max_gap_valid_m']:.3g} m apart (bar {LM_F64_WIDEST_M:g} m)")
        return k, n, missed
    if k["valid_agree"] < LM_VALID_AGREE:
        missed.append(f"valid agrees on {k['valid_agree']:.5f} of the tracks")
    if 1 - k["steps_agree"] > 2 * (1 - n["steps_agree"]) + LM_SLACK["steps"]:
        missed.append(f"steps agree on {k['steps_agree']:.4f} (nudged plain {n['steps_agree']:.4f})")
    if k["far_share"] > 2 * n["far_share"] + LM_SLACK["far"]:
        missed.append(f"{k['far_share']:.5f} of the positions beyond {tol:g} m (nudged plain {n['far_share']:.5f})")
    if k["max_pos_gap_m"] > 2 * n["widest_of_nudges_m"] + LM_SLACK["widest_m"]:
        missed.append(f"converged positions up to {k['max_pos_gap_m']:.3g} m apart (nudged plain up to "
                      f"{n['widest_of_nudges_m']:.3g} m)")
    return k, n, missed
