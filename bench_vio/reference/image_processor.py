# Frozen copy of msckf_stereo_c_torch/reference/image_processor.py as first written, on top of commit 8b8c4e2930d5.
"""What msckf_vio's image processor adds to the port's tracker, written out
per lane, per point and per hypothesis with loops and no batching: the plain
reference of the port's untemplated pyramidal LK level loop
(``ops/klt_corr.py:optical_flow_pyr_lk_corr``), its rotation-only temporal
prediction (``models/frontend.py:_rotation_warp``), the stereo guess of the
new candidates (``_stereo_match_merged``) and the two-point RANSAC
(``ops/ransac.py``), in the points' dtype (float32 as the port runs it).

It follows msckf_vio (Sun et al., RA-L 2018), ``image_processor.cpp``:

- ``trackFeatures`` and ``stereoMatch`` call OpenCV's
  ``calcOpticalFlowPyrLK`` with an initial flow: the guess is scaled by
  2^-(L-1) to the top level, each level is solved from the one above, the
  result doubled on the way down, and a feature is kept where every level
  kept it (``pyramid_lk``);
- ``predictFeatureTracking``: the temporal guess is the gyro rotation's
  homography K R K^-1 applied to the previous pixel (``temporal_guess``);
- ``stereoMatch``: a new feature's guess in cam1 is its cam0 pixel
  undistorted, rotated by the cam0-to-cam1 extrinsic rotation and
  distorted with cam1's model (``stereo_guess``);
- ``twoPointRansac``: both point sets undistorted, the previous ones
  rotated by R_p_c (homogeneous, not re-normalised), both scaled so their
  mean norm is sqrt(2) and the pixel unit with them, matches that moved
  more than 50 pixel units out, all out below 3 raw inliers, a distance
  gate where the mean motion is below one pixel unit (no translation),
  else translation hypotheses from pairs of raw inliers, each the null
  vector of two epipolar rows [dy, -dx, x1 y2 - y1 x2] with the column of
  the smallest l1 norm set to 1, and a match an inlier of a hypothesis
  where |row . t| < threshold x pixel unit (``two_point_ransac``).

Departures from msckf_vio, each on purpose (the port's):

- the one-level solve is the port's correlation LK (``level_solve``, an
  argument here), where msckf_vio runs OpenCV's gradient LK; this file
  writes out only the level loop around it;
- ``pyramid_levels`` 3 in msckf_vio's ``app_imgproc.yaml`` is read as
  OpenCV's maxLevel, so four levels (0-3);
- the RANSAC draws ``NUM_HYPOTHESES`` = 16 hypotheses up front from a
  counter hash of (17, the lane's next feature id, camera, hypothesis)
  (``ransac_draws``), each pair an index into the raw inliers and a
  nonzero offset from it, where msckf_vio draws from ``cv::RNG`` over an
  iteration count it adapts to the raw inliers;
- the hypothesis with the most inliers wins (the first of equal counts),
  with no least-squares refit: msckf_vio refits each model over its
  inlier set and keeps the least-error refined model;
- a hypothesis counts only with at least 20 % of the track pool's slots
  (``N``, 96 in the port) as inliers, where msckf_vio takes 20 % of the
  points it was given;
- the undistortion is the port's 20 fixed-point radtan iterations
  (``undistort_radtan``), where OpenCV's ``undistortPoints`` runs its own
  iteration count.

It imports nothing but ``torch`` and ``math``: no kernel and no module of
the port."""
from __future__ import annotations

import math

import torch

NUM_HYPOTHESES = 16
UNDISTORT_ITERS = 20
_MASK32 = 0xFFFFFFFF


# --- The camera model, one point at a time -------------------------------


def undistort_radtan(u, v, K, D, R=None):
    """Pixel (u, v) (0-d tensors) -> undistorted normalized (x, y): the
    radtan model inverted by ``UNDISTORT_ITERS`` fixed-point iterations,
    then, with ``R`` (3, 3), the ray rotated by R and divided by its z."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd, yd
    for _ in range(UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    if R is None:
        return x, y
    rx = R[0, 0] * x + R[0, 1] * y + R[0, 2]
    ry = R[1, 0] * x + R[1, 1] * y + R[1, 2]
    rz = R[2, 0] * x + R[2, 1] * y + R[2, 2]
    return rx / rz, ry / rz


def distort_radtan(x, y, K, D):
    """Normalized (x, y) -> distorted pixel (u, v) under the radtan model."""
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd * K[0] + K[2], yd * K[1] + K[3]


# --- The guesses ----------------------------------------------------------


def _mat3(A, B):
    """A B for 3x3 tensors, each entry a sum of three products."""
    return torch.stack([torch.stack([A[i, 0] * B[0, j] + A[i, 1] * B[1, j] + A[i, 2] * B[2, j] for j in range(3)])
                        for i in range(3)])


def temporal_guess(pts, K, R_p_c):
    """The gyro-only prediction of each previous pixel (B, N, 2) in the
    current frame: H = K R_p_c K^-1 of each lane's rotation previous ->
    current camera R_p_c (B, 3, 3), applied to [u, v, 1] and divided by
    its third entry."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    Km = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]), torch.stack([zero, zero, one])])
    Kinv = torch.stack([torch.stack([1 / fx, zero, -cx / fx]), torch.stack([zero, 1 / fy, -cy / fy]),
                        torch.stack([zero, zero, one])])
    out = torch.zeros_like(pts)
    for b in range(pts.shape[0]):
        H = _mat3(_mat3(Km, R_p_c[b]), Kinv)
        for i in range(pts.shape[1]):
            u, v = pts[b, i, 0], pts[b, i, 1]
            w = [H[r, 0] * u + H[r, 1] * v + H[r, 2] for r in range(3)]
            out[b, i, 0] = w[0] / w[2]
            out[b, i, 1] = w[1] / w[2]
    return out


def stereo_guess(pts, K0, D0, K1, D1, R_c0_c1):
    """Each cam0 pixel (B, N, 2) undistorted, rotated into cam1 by the
    extrinsic rotation and distorted by cam1's model: the cam1 guess at
    infinite depth."""
    out = torch.zeros_like(pts)
    for b in range(pts.shape[0]):
        for i in range(pts.shape[1]):
            x, y = undistort_radtan(pts[b, i, 0], pts[b, i, 1], K0, D0, R_c0_c1)
            out[b, i, 0], out[b, i, 1] = distort_radtan(x, y, K1, D1)
    return out


# --- The level loop -----------------------------------------------------


def pyramid_lk(level_solve, pyr_prev, pyr_curr, pts_prev, guess, valid):
    """Coarse-to-fine LK of each lane with an initial flow.  ``pyr_prev``
    and ``pyr_curr`` are the levels (B, h, w), finest first; ``pts_prev``,
    ``guess`` (B, N, 2) level-0 pixels, ``valid`` (B, N).
    ``level_solve(img_prev, img_curr, pts_prev, start, final)`` solves one
    level of one lane's (h, w) images for its (N, 2) points from the (N, 2)
    start and returns (points, ok); ``final`` is True at level 0.  The
    guess is scaled by 2^-(L-1), each level's result doubled for the next,
    and ``ok`` ANDed over the levels.  Returns ((B, N, 2) level-0 points,
    (B, N) validity)."""
    L = len(pyr_prev)
    out_pts = torch.zeros_like(guess)
    out_ok = torch.zeros_like(valid)
    for b in range(guess.shape[0]):
        pts = guess[b] / 2.0 ** (L - 1)
        ok_all = valid[b].clone()
        for lvl in range(L - 1, -1, -1):
            s = 2.0**lvl
            pts, ok = level_solve(pyr_prev[lvl][b], pyr_curr[lvl][b], pts_prev[b] / s, pts, lvl == 0)
            ok_all = ok_all & ok
            if lvl > 0:
                pts = pts * 2.0
        out_pts[b] = pts
        out_ok[b] = ok_all
    return out_pts, out_ok


# --- The two-point RANSAC -------------------------------------------------


def hash32(x: int) -> int:
    """A 32-bit avalanche hash of an integer in [0, 2^32)."""
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _MASK32
    x ^= x >> 15
    x = (x * 0x5BD1E995) & _MASK32
    return x ^ (x >> 16)


def ransac_draws(next_fid: int, camera: int, n: int = NUM_HYPOTHESES):
    """The two lists of ``n`` raw draws in [0, 2^30) of one lane: a
    counter hash of (17, next_fid, camera, h) for h < 2n, the first n the
    pairs' first indices, the last n their offsets."""
    s = hash32(17)
    s = hash32(s ^ (int(next_fid) & _MASK32))
    s = hash32(s ^ camera)
    x = [hash32(s ^ h) >> 2 for h in range(2 * n)]
    return x[:n], x[n:]


def _hypothesis(c1, c2):
    """The translation (a list of three 0-d tensors) that zeroes the two
    epipolar rows ``c1`` and ``c2``: the column of the smallest l1 norm
    over the two rows (the first of equal norms) set to 1, the other two
    solved from the 2x2 system by its closed-form inverse."""
    norms = [abs(c1[k]) + abs(c2[k]) for k in range(3)]
    base = 0
    for k in (1, 2):
        if norms[k] < norms[base]:
            base = k
    a, b = [k for k in range(3) if k != base]
    A00, A01, A10, A11 = c1[a], c1[b], c2[a], c2[b]
    det = A00 * A11 - A01 * A10
    if not abs(det) > 1e-30:
        det = torch.full_like(det, 1e-30)
    inv_det = 1.0 / det
    r0, r1 = -c1[base], -c2[base]
    t = [None, None, None]
    t[base] = torch.ones_like(det)
    t[a] = (A11 * r0 - A01 * r1) * inv_det
    t[b] = (-A10 * r0 + A00 * r1) * inv_det
    return t


def ransac_lane(pts1, pts2, valid, R_p_c, K, D, draw1, draw2, inlier_error=3.0, steps=None):
    """The inlier mask (a list of N bools) of one lane: previous pixels
    ``pts1`` and current ones ``pts2`` (N, 2), ``valid`` (N,), the rotation
    previous -> current camera ``R_p_c`` (3, 3), the raw draws (two lists).
    With ``steps`` a dict, records the branch taken (``branch``: 'too few',
    'degenerate' or 'hypotheses'), the threshold the final test used
    (``threshold``), each point's value under that test (``value``: its
    motion on the degenerate branch, its error under the winning model on
    the hypotheses' branch, None for a point the test did not see) and the
    winning hypothesis (``best``)."""
    N = pts1.shape[0]
    npu = 2.0 / (K[0] + K[1])
    p1r, p2 = [], []
    for i in range(N):
        x1, y1 = undistort_radtan(pts1[i, 0], pts1[i, 1], K, D)
        p1r.append((R_p_c[0, 0] * x1 + R_p_c[0, 1] * y1 + R_p_c[0, 2],
                    R_p_c[1, 0] * x1 + R_p_c[1, 1] * y1 + R_p_c[1, 2]))
        p2.append(undistort_radtan(pts2[i, 0], pts2[i, 1], K, D))

    # Mean norm sqrt(2) over the valid points; the pixel unit scaled too.
    total = torch.zeros_like(npu)
    n_valid = 0
    for i in range(N):
        if valid[i]:
            total = total + (torch.sqrt(p1r[i][0] ** 2 + p1r[i][1] ** 2) + torch.sqrt(p2[i][0] ** 2 + p2[i][1] ** 2))
            n_valid += 1
    sf = (2.0 * max(n_valid, 1)) / torch.clamp(total, min=1e-12) * math.sqrt(2.0)
    p1s = [(x * sf, y * sf) for x, y in p1r]
    p2s = [(x * sf, y * sf) for x, y in p2]
    npu = npu * sf

    # Matches that moved more than 50 pixel units are out from the start.
    diff = [(p1s[i][0] - p2s[i][0], p1s[i][1] - p2s[i][1]) for i in range(N)]
    dist = [torch.sqrt(dx * dx + dy * dy) for dx, dy in diff]
    raw = [bool(valid[i]) and bool(dist[i] <= 50.0 * npu) for i in range(N)]
    raw_idx = [i for i in range(N) if raw[i]]
    if steps is not None:
        steps.update(branch=None, threshold=None, value=[None] * N, best=None)
    if len(raw_idx) < 3:
        if steps is not None:
            steps["branch"] = "too few"
        return [False] * N
    mean_dist = sum((dist[i] for i in raw_idx), torch.zeros_like(npu)) / len(raw_idx)

    # No translation: a distance gate.
    if mean_dist < npu:
        thr = inlier_error * npu
        if steps is not None:
            steps.update(branch="degenerate", threshold=thr, value=[dist[i] if raw[i] else None for i in range(N)])
        return [raw[i] and bool(dist[i] <= thr) for i in range(N)]

    coeff = [(diff[i][1], -diff[i][0], p1s[i][0] * p2s[i][1] - p1s[i][1] * p2s[i][0]) for i in range(N)]
    cnt = len(raw_idx)
    thr = inlier_error * npu
    best, best_count, best_errors = None, 0, None
    for h in range(len(draw1)):
        u1 = draw1[h] % cnt
        u2 = (u1 + 1 + draw2[h] % max(cnt - 1, 1)) % cnt
        t = _hypothesis(coeff[raw_idx[u1]], coeff[raw_idx[u2]])
        errors = [abs(coeff[i][0] * t[0] + coeff[i][1] * t[1] + coeff[i][2] * t[2]) if raw[i] else None
                  for i in range(N)]
        count = sum(1 for i in raw_idx if errors[i] < thr)
        if count < 0.2 * N:
            count = 0
        if count > best_count:
            best, best_count, best_errors = h, count, errors
    if steps is not None:
        steps.update(branch="hypotheses", threshold=thr, best=best,
                     value=best_errors if best_errors is not None else [None] * N)
    if best is None:
        return [False] * N
    return [raw[i] and bool(best_errors[i] < thr) for i in range(N)]


def two_point_ransac(pts1, pts2, valid, R_p_c, K, D, next_fid, camera, inlier_error=3.0, steps=None):
    """The inlier masks (B, N) of B lanes: ``pts1``, ``pts2`` (B, N, 2),
    ``valid`` (B, N), ``R_p_c`` (B, 3, 3), each lane's next feature id
    ``next_fid`` (B,) and the camera (0 or 1) for its draws.  With
    ``steps`` a list, one dict of ``ransac_lane``'s record a lane is
    appended."""
    out = torch.zeros(valid.shape, dtype=torch.bool)
    for b in range(valid.shape[0]):
        d1, d2 = ransac_draws(int(next_fid[b]), camera)
        lane_steps = None if steps is None else {}
        mask = ransac_lane(pts1[b], pts2[b], valid[b], R_p_c[b], K, D, d1, d2, inlier_error, lane_steps)
        out[b] = torch.tensor(mask, dtype=torch.bool)
        if steps is not None:
            steps.append(lane_steps)
    return out
