#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``msckf_stereo_c_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (exit code 1) if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every ``msckf_stereo_c_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a`` (into ``build/torch_kernels/``);
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it, with inputs cut from real
   frames of the bench scene; kernel, plain and library-call times (CUDA
   events) beside the least time the card could take;
4. main path: ``run_vio_sequence`` over the bench scene (752x480 stereo,
   the configuration ``bench.py`` runs, B=1) with the kernel launch counts
   zeroed just before and read just after; frames/s, ATE, tracks, host syncs;
5. profile: the last frames again, from the state the frames before them
   leave, under ``torch.profiler``: device busy share and the kernels that
   take the device time (``<out>/profile.txt``); then once more with each
   stage of a frame timed;
6. the ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` as
   the last line.

Details go to ``<out>/chip_smoke.json``.  The script imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Floating-point operations of one K1 Gauss-Newton step of one feature:
# 4 bilinear weights (8), two 4-tap sums (16), residuals (2), 2x2 solve (6),
# update and clamps (6), convergence test (4).
K1_OPS_PER_STEP = 42
K1_TOL = 0.02  # 2 * eps: a lane may freeze one (sub-eps) step apart
SECTOR_BYTES = 32  # the least the card reads from memory at once
FRAMES = 60  # main-path frames, 752x480 stereo (bench.py's scene)
N_TAIL = 20  # last frames of the scene run again by the profile phase

KERNEL_SOURCES = {
    "lk_corr_iterate": (
        "msckf_stereo_c_torch/csrc/lk_corr_iterate.cu",
        "msckf_stereo_c_tpu/ops/klt_corr.py:85",
    ),
    "extract_windows": (
        "msckf_stereo_c_torch/csrc/extract_windows.cu",
        "msckf_stereo_c_tpu/ops/patch_extract.py:28",
    ),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 50):
    """Mean device time in ms of the CUDA kernels whose name contains
    ``kernel``, per call of ``fn``, as torch.profiler (CUPTI) records them;
    None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bench_scene(n_frames: int):
    """The scene ``bench.py`` renders: circle trajectory, 600 wall
    landmarks, IMU noise 5e-4 / 5e-3, one frame every 10 IMU samples."""
    import numpy as np

    from msckf_stereo_c_torch.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from msckf_stereo_c_torch.sim.render import render_stereo_sequence

    traj = make_circle_trajectory(duration=max(4.0, n_frames * 0.05 + 2.0))
    landmarks = make_wall_landmarks(num=600, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    frame_idx = np.arange(0, traj.t.shape[0], 10)[:n_frames]
    img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
    return traj, imu, frame_idx, img0, img1


def k1_trace(sc, cx, cy, iters: int, eps: float, hi: float):
    """K1's algorithm in numpy float64: four bilinear taps per surface and
    step, each lane stopping on its own.

    Returns the final points (N, 2), the Gauss-Newton steps of each lane,
    and the distinct 32-byte sectors of one (N, K, K) float32 surface that
    those steps read (the same cells of Cx and of Cy).  What K1 must read
    and compute on given inputs depends on where and how long each lane
    walks: a lane that starts frozen reads no surface at all."""
    import numpy as np

    sc = sc.astype(np.float64)
    cx, cy = cx.astype(np.float64), cy.astype(np.float64)
    n, K, _ = cx.shape
    gxx, gxy, gyy, tgx, tgy = (sc[:, i] for i in range(5))
    fx, fy = sc[:, 5].copy(), sc[:, 6].copy()
    conv = sc[:, 7] > 0.5
    det = gxx * gyy - gxy * gxy
    inv_det = 1.0 / np.where(np.abs(det) > 1e-30, det, 1e-30)
    steps = np.zeros(n, np.int64)
    lanes = np.arange(n)
    touched = [np.zeros(0, np.int64)]
    for _ in range(iters):
        act = ~conv
        if not act.any():
            break
        steps += act
        fxs, fys = np.clip(fx, 0, hi), np.clip(fy, 0, hi)
        x0, y0 = np.floor(fxs).astype(int), np.floor(fys).astype(int)
        ax, ay = fxs - x0, fys - y0
        cell = (lanes * K + y0) * K + x0
        touched += [cell[act] + d for d in (0, 1, K, K + 1)]

        def tap(c):
            return ((1 - ay) * (1 - ax) * c[lanes, y0, x0] + (1 - ay) * ax * c[lanes, y0, x0 + 1]
                    + ay * (1 - ax) * c[lanes, y0 + 1, x0] + ay * ax * c[lanes, y0 + 1, x0 + 1])

        bx, by = tgx - tap(cx), tgy - tap(cy)
        dx = (gyy * bx - gxy * by) * inv_det
        dy = (-gxy * bx + gxx * by) * inv_det
        fx = np.where(act, np.clip(fx + dx, 0, hi), fx)
        fy = np.where(act, np.clip(fy + dy, 0, hi), fy)
        conv = conv | (act & (np.hypot(dx, dy) < eps))
    sectors = np.unique(np.concatenate(touched) * 4 // SECTOR_BYTES).size
    return np.stack([fx, fy], -1), steps, sectors


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "unknown"
    name = torch.cuda.get_device_name(0)
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {torch.cuda.get_device_capability(0)} count {torch.cuda.device_count()}")
    check(torch.cuda.get_device_capability(0) == (9, 0), "the kernels are built for sm_90a (Hopper)")
    return card, name


def phase_build():
    from msckf_stereo_c_torch.ops import _cuda

    t0 = time.time()
    logs = _cuda.build_kernels()
    secs = time.time() - t0
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {src}: {line.strip()}")
    print(f"[build] {len(logs)} kernel sources compiled in {secs:.2f} s")
    for name in KERNEL_SOURCES:
        _cuda.kernel_function(name)
    return {"seconds": secs, "logs": logs}


def phase_kernels(img0, img1, fcfg):
    """K2 bit-exact and K1 within K1_TOL against their plain versions."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.models.frontend import pyramids_for
    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.ops.fast import detect_grid_corners
    from msckf_stereo_c_torch.ops.patch_extract import extract_windows, extract_windows_reference

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    # The last two frames: the trajectory starts at rest for 1.5 s.
    pyr_a = pyramids_for(torch.as_tensor(img0[-2], device=dev), fcfg)
    pyr_b = pyramids_for(torch.as_tensor(img0[-1], device=dev), fcfg)
    rows = []

    # K2 on every pyramid level at the three window sizes of the main path,
    # origins drawn across the valid range plus out-of-range ones that the
    # kernel must clamp.
    N = 144
    for lvl, img in enumerate(pyr_a):
        H, W = img.shape
        for S in (18, 35, 37):
            org = np.stack([rng.integers(0, W - S + 1, N), rng.integers(0, H - S + 1, N)], 1)
            org[:6] = [[-5, 0], [W, H], [W - S, H - S], [0, H - S + 3], [-40, -40], [W - S + 1, 0]]
            org_t = torch.as_tensor(org, dtype=torch.int32, device=dev)
            got = extract_windows(img, org_t, S)
            want = extract_windows_reference(img, org_t, S)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.equal(got, want), f"extract_windows differs from its plain version at level {lvl}, S={S}")
            ox = org_t[:, 0].long().clamp(0, W - S)
            oy = org_t[:, 1].long().clamp(0, H - S)
            ms = cuda_ms(lambda: extract_windows(img, org_t, S), reps=200)
            plain = cuda_ms(lambda: extract_windows_reference(img, org_t, S), reps=50)
            lib = cuda_ms(lambda: img.unfold(0, S, 1).unfold(1, S, 1)[oy, ox], reps=50)
            dev_ms = device_ms(lambda: extract_windows(img, org_t, S), "extract_windows_kernel")
            b, by = bound_ms(2 * N * S * S * 4 + N * 2 * 4, 0)
            rows.append(dict(name="extract_windows", level=lvl, H=H, W=W, S=S, N=N, max_abs_err=err,
                             ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                             bound_by=by))
            print(f"[K2] level {lvl} {W}x{H} S={S} N={N}: bit-exact; per call {ms:.4f} ms (device "
                  f"{_fmt(dev_ms)}), plain {plain:.4f} ms, unfold+index {lib:.4f} ms, bound {b:.5f} ms ({by})")

    # K1 on correlation surfaces of real features: FAST corners of one frame
    # tracked into the next frame at full resolution.
    P, iters, eps = fcfg.patch_size, fcfg.max_iteration, fcfg.track_precision
    img_a, img_b = pyr_a[0], pyr_b[0]
    H, W = img_a.shape
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    corners = detect_grid_corners(img_a, float(fcfg.fast_threshold), fcfg.detector_cell)
    order = torch.argsort(torch.where(corners.valid, corners.score, -1.0), descending=True)
    for N in (48, 96, 144):
        pts = corners.xy[order[:N]]
        sp = kc._interp_template(img_a, pts, P)
        tq = kc._template_quantities(sp, P)
        sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
        spatch = kc._extract_at_origins(img_b, sorg, S)
        Cx, Cy = kc._corr_surfaces(spatch, tq.gx, tq.gy, P)
        c_off = (P - 1) / 2.0
        f0 = pts - c_off - sorg
        sc = torch.stack([tq.G[:, 0, 0], tq.G[:, 0, 1], tq.G[:, 1, 1], tq.tgx, tq.tgy,
                          f0[:, 0], f0[:, 1], (~tq.good).to(torch.float32)], dim=-1).contiguous()
        hi = float(S - P - 1)
        got = kc.lk_corr_iterate(sc, Cx, Cy, iters, eps, hi)
        want = kc.lk_corr_iterate_reference(sc, Cx, Cy, iters, eps, hi)
        torch.cuda.synchronize()
        r = P // 2 + 1

        def ok_mask(f):
            p = f + c_off + sorg
            return tq.good & (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

        m_got, m_want = ok_mask(got), ok_mask(want)
        check(torch.equal(m_got, m_want), f"lk_corr_iterate valid mask differs at N={N}")
        check(bool(torch.isfinite(got).all()), f"lk_corr_iterate gave non-finite output at N={N}")
        err = float((got - want)[m_want].abs().max()) if bool(m_want.any()) else 0.0
        check(err <= K1_TOL, f"lk_corr_iterate differs by {err} px (> {K1_TOL}) at N={N}")
        K = Cx.shape[-1]
        _, steps, sectors = k1_trace(sc.cpu().numpy(), Cx.cpu().numpy(), Cy.cpu().numpy(), iters, eps, hi)
        # sc read, f written, and the sectors of Cx and Cy the steps visit.
        n_bytes = N * 8 * 4 + N * 2 * 4 + 2 * sectors * SECTOR_BYTES
        ms = cuda_ms(lambda: kc.lk_corr_iterate(sc, Cx, Cy, iters, eps, hi), reps=200)
        plain = cuda_ms(lambda: kc.lk_corr_iterate_reference(sc, Cx, Cy, iters, eps, hi), reps=10)
        dev_ms = device_ms(lambda: kc.lk_corr_iterate(sc, Cx, Cy, iters, eps, hi), "lk_corr_iterate_kernel")
        b, by = bound_ms(n_bytes, int(steps.sum()) * K1_OPS_PER_STEP)
        rows.append(dict(name="lk_corr_iterate", N=N, K=K, valid=int(m_want.sum()),
                         lane_steps=int(steps.sum()), max_steps=int(steps.max()), bound_bytes=n_bytes,
                         surface_bytes=N * 2 * K * K * 4, max_abs_err=err,
                         ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=None, bound_ms=b,
                         bound_by=by))
        print(f"[K1] N={N} K={K}: {int(m_want.sum())} valid lanes, masks equal, max |df| {err:.2e} px "
              f"(tol {K1_TOL}); {int(steps.sum())} lane steps (max {int(steps.max())}) touching {n_bytes} B "
              f"of {N * 2 * K * K * 4} B of surfaces; per call {ms:.4f} ms (device {_fmt(dev_ms)}), "
              f"plain {plain:.4f} ms, bound {b:.6f} ms ({by})")
    return rows


def phase_main_path(traj, imu, frame_idx, img0, img1, fcfg, mcfg, card):
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB
    from msckf_stereo_c_torch.io.tum import evaluate_ate
    from msckf_stereo_c_torch.models.vio import run_vio_sequence
    from msckf_stereo_c_torch.ops import _cuda

    frame_t = traj.t[frame_idx]
    T = frame_t.shape[0]

    def run(n):
        return run_vio_sequence(
            fcfg, mcfg, EUROC_CALIB, frame_t[:n], img0[:n], img1[:n], imu.t, imu.gyro, imu.acc,
            image_dtype=torch.float32, filter_dtype=torch.float32, method="schur", device="cuda",
        )

    run(3)  # warm-up: library handles, cuDNN plans, kernel loads
    torch.cuda.synchronize()

    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(T)  # ends in a device-to-host copy of the outputs
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)

    # Every synchronising call of one more run, as torch's sync debug mode
    # reports it (the run above is timed without the mode's overhead).
    sites = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(T)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    syncs = sum(sites.values())

    pos = res.positions
    check(pos.shape == (T, 3) and bool(np.isfinite(pos).all()), "non-finite or misshapen poses")
    check(bool(np.isfinite(res.quats_xyzw).all()), "non-finite orientations")
    ate = float(evaluate_ate(frame_t, pos, frame_t, traj.p[frame_idx]).rmse)
    tracks = res.tracking["after_ransac"]
    out = dict(frames=T, seconds=secs, fps=T / secs, ate_rmse_m=ate,
               tracks_per_frame_mean=float(np.mean(tracks)), tracks_per_frame_min=int(np.min(tracks[1:])),
               syncs_per_frame=syncs / T,
               sync_sites={k: v / T for k, v in sorted(sites.items(), key=lambda kv: -kv[1])},
               launches=counts)
    print(f"[main] {T} frames in {secs:.3f} s: {T / secs:.2f} frames/s (B=1) on {card}")
    print(f"[main] ATE RMSE {ate:.5f} m (pass bar 0.13 m)")
    print(f"[main] features tracked per frame: mean {np.mean(tracks):.1f}, min after frame 0 {np.min(tracks[1:])}")
    print(f"[main] host syncs per frame: {syncs / T:.2f} (torch sync debug mode), by call site:")
    for site, per_frame in list(out["sync_sites"].items())[:6]:
        print(f"[main]   {per_frame:.2f}/frame at {site}")
    print(f"[main] launches: {counts}")
    check(ate < 0.13, f"ATE {ate} m is above the 0.13 m pass bar")
    check(np.min(tracks[1:]) >= 10, "the tracker lost the scene")
    check(counts["lk_corr_iterate"] == 7 * T, f"lk_corr_iterate launched {counts['lk_corr_iterate']} times, expected 7/frame")
    check(counts["extract_windows"] == 10 * T, f"extract_windows launched {counts['extract_windows']} times, expected 10/frame")
    return out


def _resume_split(traj, imu, frame_idx, img0, img1, fcfg, mcfg, n_tail):
    """Runs all but the last ``n_tail`` frames and returns a function that
    runs those last frames from the state they leave (the tracker and the
    filter then in steady state, the camera window full); the head runs
    once, the tail as often as it is called."""
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB
    from msckf_stereo_c_torch.models.vio import run_vio_sequence

    frame_t = traj.t[frame_idx]
    k0 = frame_t.shape[0] - n_tail
    kw = dict(image_dtype=torch.float32, filter_dtype=torch.float32, method="schur", device="cuda")
    head = run_vio_sequence(fcfg, mcfg, EUROC_CALIB, frame_t[:k0], img0[:k0], img1[:k0],
                            imu.t, imu.gyro, imu.acc, **kw)

    def tail():
        run_vio_sequence(fcfg, mcfg, EUROC_CALIB, frame_t[k0:], img0[k0:], img1[k0:], imu.t, imu.gyro,
                         imu.acc, state=head.final_state, prev_frame_t=float(frame_t[k0 - 1]), **kw)
        torch.cuda.synchronize()

    return tail


def phase_profile(tail, n_tail, out_dir):
    """Device busy time per frame and the kernels that take it, as
    torch.profiler (CUPTI, device activity only) records them over one run
    of the ``n_tail`` last frames; the table goes to
    ``<out_dir>/profile.txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tail()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    calls = sum(e.count for e in events)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=50, max_name_column_width=120))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(frames=n_tail, wall_ms_per_frame=wall * 1e3 / n_tail, device_ms_per_frame=dev_us / 1e3 / n_tail,
               device_ops_per_frame=calls / n_tail,
               top=[dict(name=e.key, calls_per_frame=e.count / n_tail,
                         device_ms_per_frame=e.self_device_time_total / 1e3 / n_tail) for e in top])
    if dev_us > 0:
        print(f"[profile] {n_tail} frames, device activity traced: wall {out['wall_ms_per_frame']:.2f} ms/frame, "
              f"device busy {out['device_ms_per_frame']:.3f} ms/frame ({100 * dev_us / 1e6 / wall:.1f}% of wall), "
              f"{calls / n_tail:.0f} kernels and copies per frame")
        for e in out["top"]:
            print(f"[profile]   {e['device_ms_per_frame']:.4f} ms/frame, {e['calls_per_frame']:.0f} calls/frame: {e['name'][:80]}")
    else:
        print("[profile] the profiler recorded no device time: device busy share not measured")
    return out


# Stages of one frame timed by phase_stages: (module, attribute, label), in
# the order a frame runs them.
STAGES = (
    ("msckf_stereo_c_torch.models.vio", "pyramids_for", "frontend: pyramids"),
    ("msckf_stereo_c_torch.models.frontend", "optical_flow_lk_corr_l0", "frontend: temporal LK"),
    ("msckf_stereo_c_torch.models.frontend", "_detect_candidates", "frontend: FAST candidates"),
    ("msckf_stereo_c_torch.models.frontend", "optical_flow_pyr_lk_corr", "frontend: candidate coarse walk"),
    ("msckf_stereo_c_torch.models.frontend", "stereo_anchor_lr_fused", "frontend: fused stereo fine level"),
    ("msckf_stereo_c_torch.models.frontend", "_allocate_new_features", "frontend: allocate"),
    ("msckf_stereo_c_torch.models.frontend", "_prune_grid_features", "frontend: prune"),
    ("msckf_stereo_c_torch.models.frontend", "_publish", "frontend: publish"),
    ("msckf_stereo_c_torch.models.msckf", "propagate", "filter: propagate"),
    ("msckf_stereo_c_torch.models.msckf", "augment_state", "filter: augment"),
    ("msckf_stereo_c_torch.models.msckf", "add_feature_observations", "filter: observe"),
    ("msckf_stereo_c_torch.models.msckf", "_remove_lost_features", "filter: lost-track update"),
    ("msckf_stereo_c_torch.models.msckf", "_prune_cam_states", "filter: camera prune"),
    ("msckf_stereo_c_torch.models.msckf", "_online_reset", "filter: online reset"),
    ("msckf_stereo_c_torch.models.vio", "_run_frontend", "frontend total"),
    ("msckf_stereo_c_torch.models.vio", "filter_step", "filter total"),
)


def phase_stages(tail, n_tail):
    """Wall time of each stage of a frame over one run of the ``n_tail``
    last frames: each stage function is wrapped for this phase by one that
    synchronises the card before and after it (which adds those syncs to
    the run)."""
    import importlib

    import torch

    spent = {label: 0.0 for _, _, label in STAGES}
    saved = []

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t0
            return out
        return wrapper

    for mod_name, attr, label in STAGES:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(getattr(mod, attr), label))
    try:
        t0 = time.perf_counter()
        tail()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out = {label: secs * 1e3 / n_tail for label, secs in spent.items()}
    out["frame"] = wall * 1e3 / n_tail
    print(f"[stages] {n_tail} frames, each stage synchronised: {out['frame']:.2f} ms/frame")
    for label, ms in out.items():
        if label != "frame":
            print(f"[stages]   {ms:8.3f} ms/frame  {label}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke"),
                    help="directory for chip_smoke.json and profile.txt (default build/chip_smoke)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "msckf_stereo_c_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(msckf_stereo_c_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no result", file=sys.stderr)
        return 1

    from msckf_stereo_c_torch.config import FilterConfig, FrontendConfig

    t_start = time.time()
    card, name = phase_device()
    build = phase_build()

    # The bench configuration (bench.py): FrontendConfig defaults with one
    # temporal level; Schur filter in f32 with 10 Newton-Schulz iterations
    # and the 'tensorfloat32' name, which the port maps to full f32.
    fcfg = FrontendConfig(temporal_levels=1)
    mcfg = FilterConfig(ns_iters=10, matmul_precision="tensorfloat32")
    t0 = time.time()
    traj, imu, frame_idx, img0, img1 = bench_scene(FRAMES)
    print(f"[scene] {FRAMES} stereo frames {img0.shape[2]}x{img0.shape[1]} rendered in {time.time() - t0:.1f} s")

    rows = phase_kernels(img0, img1, fcfg)
    main_out = phase_main_path(traj, imu, frame_idx, img0, img1, fcfg, mcfg, card)
    os.makedirs(args.out, exist_ok=True)
    tail = _resume_split(traj, imu, frame_idx, img0, img1, fcfg, mcfg, N_TAIL)
    prof_out = phase_profile(tail, N_TAIL, args.out)
    stage_out = phase_stages(tail, N_TAIL)

    pick = {
        "lk_corr_iterate": next(r for r in rows if r["name"] == "lk_corr_iterate" and r["N"] == 144),
        "extract_windows": next(r for r in rows if r["name"] == "extract_windows" and r["level"] == 0
                                and r["S"] == 37),
    }
    kernels = []
    for kname, (source, replaces) in KERNEL_SOURCES.items():
        r = pick[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_out["launches"][kname], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": name, "build_seconds": build["seconds"],
                   "build_logs": build["logs"], "kernel_rows": rows, "main_path": main_out,
                   "profile": prof_out, "stages": stage_out, "seconds": time.time() - t_start},
                  f, indent=1)
    print(f"[done] {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
