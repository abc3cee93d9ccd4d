#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``msckf_stereo_c_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (exit code 1) if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every ``msckf_stereo_c_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a`` (into ``build/torch_kernels/``), all sources at once;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the shapes the main paths give it, with inputs cut from real
   frames (K1 and K2 from the bench scene; K3 from the stress scene, with
   'gain' and with 'offset' surfaces); kernel, plain and library-call times
   (CUDA events) beside the least time the card could take;
4. main path: ``run_vio_sequence`` over the bench scene (752x480 stereo,
   the configuration ``bench.py`` runs, B=1) with the kernel launch counts
   zeroed just before and read just after; frames/s, ATE, tracks, host syncs;
5. mode sweep: each ``klt_norm`` mode over 20 bench frames, with the exact
   K1 / K3 / K2 launch split per frame it must give;
6. profile: the last bench frames again, from the state the frames before
   them leave, under ``torch.profiler``: device busy share and the kernels
   that take the device time (``<out>/profile.txt``); then once more with
   each stage of a frame timed;
7. stress path: ``sim/stress.py:run_stress_gate`` over the 36 s stress scene
   (721 stereo frames rendered on the card with every stress channel on,
   ``klt_norm='gain'``), launch counts zeroed just before and read just
   after (7 K3, 0 K1, 10 K2 per frame), the gate's ATE and track bars,
   frames/s and render time; then the same run with each stage timed and
   its host syncs counted;
8. the card's name and power limit, the ``{"kernels": [...]}`` line, then
   ``{"ok": true, "device": ...}`` as the last line.

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
# One K3 step: 4 bilinear weights (8), three 4-tap sums (24), residuals (3),
# the 2x3 product (10), update and clamps (6), convergence test (4).
K3_OPS_PER_STEP = 55
K1_TOL = 0.02  # 2 * eps: a lane may freeze one (sub-eps) step apart
SECTOR_BYTES = 32  # the least the card reads from memory at once
FRAMES = 60  # main-path frames, 752x480 stereo (bench.py's scene)
N_TAIL = 20  # last frames of the scene run again by the profile phase
SWEEP_FRAMES = 20  # bench frames per photometric mode in the mode sweep
STRESS_SECONDS = 36.0  # the stress gate's short run (721 stereo frames)
# K1, K3 and K2 launches per frame for each klt_norm mode.
MODE_SPLIT = {
    "zeromean": (7, 0), "offset": (0, 7), "gain": (0, 7), "mixed": (0, 7), "anchor_gain": (6, 1),
}

KERNEL_SOURCES = {
    "lk_corr_iterate": (
        "msckf_stereo_c_torch/csrc/lk_corr_iterate.cu",
        "msckf_stereo_c_tpu/ops/klt_corr.py:85",
    ),
    "extract_windows": (
        "msckf_stereo_c_torch/csrc/extract_windows.cu",
        "msckf_stereo_c_tpu/ops/patch_extract.py:28",
    ),
    "lk_corr_iterate_gain": (
        "msckf_stereo_c_torch/csrc/lk_corr_iterate_gain.cu",
        "msckf_stereo_c_tpu/ops/klt_corr.py:144",
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
    """Mean device time in ms of one launch of the CUDA kernel whose name
    contains ``kernel``, over the launches of ``reps`` calls of ``fn`` that
    torch.profiler (CUPTI) records (divided by the launches it recorded, so
    a dropped record does not lower the mean); None when it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(e.self_device_time_total for e in events)
    n = sum(e.count for e in events)
    return us / n / 1e3 if us > 0 else None


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


def lk_trace(sc, surfaces, iters: int, eps: float, hi: float):
    """The algorithm of K1 (two surfaces, sc (N, 8)) or K3 (three surfaces,
    sc (N, 12)) in numpy float64: four bilinear taps per surface and step,
    each lane stopping on its own.

    Returns the final points (N, 2), the Gauss-Newton steps of each lane,
    and the distinct 32-byte sectors of one (N, K, K) float32 surface that
    those steps read (the same cells of every surface).  What the kernel
    must read and compute on given inputs depends on where and how long
    each lane walks: a lane that starts frozen reads no surface at all."""
    import numpy as np

    sc = sc.astype(np.float64)
    surf = [c.astype(np.float64) for c in surfaces]
    n, K, _ = surf[0].shape
    if len(surf) == 2:
        gxx, gxy, gyy = sc[:, 0], sc[:, 1], sc[:, 2]
        det = gxx * gyy - gxy * gxy
        inv_det = 1.0 / np.where(np.abs(det) > 1e-30, det, 1e-30)
        B = np.stack([np.stack([gyy, -gxy], -1), np.stack([-gxy, gxx], -1)], -2) * inv_det[:, None, None]
        t, f0 = sc[:, 3:5], 5
    else:
        B = sc[:, 0:6].reshape(n, 2, 3)
        t, f0 = sc[:, 6:9], 9
    fx, fy = sc[:, f0].copy(), sc[:, f0 + 1].copy()
    conv = sc[:, f0 + 2] > 0.5
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

        b = t - np.stack([tap(c) for c in surf], -1)
        d = np.einsum("nij,nj->ni", B, b)
        fx = np.where(act, np.clip(fx + d[:, 0], 0, hi), fx)
        fy = np.where(act, np.clip(fy + d[:, 1], 0, hi), fy)
        conv = conv | (act & (np.hypot(d[:, 0], d[:, 1]) < eps))
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
    return rows + lk_rows("K1", pyr_a[0], pyr_b[0], fcfg, "none")


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

    # Every synchronising call of one more run (the run above is timed
    # without the sync debug mode's overhead).
    sites = count_syncs(lambda: run(T))
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
    check(counts["lk_corr_iterate_gain"] == 0, "lk_corr_iterate_gain launched under klt_norm='none'")
    return out


def count_syncs(fn):
    """{call site: count} of every synchronising call that ``fn`` makes, as
    torch's sync debug mode reports them."""
    import torch

    sites = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def phase_k3(fcfg):
    """K3 within K1_TOL of its plain version on inputs cut from two frames
    of the stress scene rendered on the card (exposure drift, vignette,
    blur and noise on): FAST corners of one frame tracked into the next at
    full resolution, once with 'gain' and once with 'offset' surfaces."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.models.frontend import pyramids_for
    from msckf_stereo_c_torch.sim.render_torch import TorchRenderer, make_stress_events
    from msckf_stereo_c_torch.sim.trajectory import make_room_landmarks, make_stress_trajectory

    dev = torch.device("cuda")
    traj = make_stress_trajectory(duration=STRESS_SECONDS)
    idx = np.arange(0, traj.t.shape[0], 10)
    lms = make_room_landmarks(num=900, radius=7.0, z_cap=3.5, seed=1)
    k = 60  # 3 s in: the drift is on, the texture-poor windows are not
    img, _ = TorchRenderer(lms, r_wall=7.0, z_cap=3.5, device=dev).render_sequence(
        traj, idx[k:k + 2], make_stress_events(traj, idx).slice(k, k + 2))
    img_a, img_b = pyramids_for(img[0], fcfg)[0], pyramids_for(img[1], fcfg)[0]
    return lk_rows("K3", img_a, img_b, fcfg, "gain") + lk_rows("K3", img_a, img_b, fcfg, "offset")


def lk_rows(tag, img_a, img_b, fcfg, norm):
    """K1 (norm 'none') or K3 ('gain', 'offset') within K1_TOL of its plain
    version at N = 48 / 96 / 144 FAST corners of ``img_a`` tracked into
    ``img_b``, the surfaces built as the main path builds them; per-call,
    device, plain and bound times."""
    import torch

    from msckf_stereo_c_torch.config import matmul_precision_scope
    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.ops.fast import detect_grid_corners

    P, iters, eps = fcfg.patch_size, fcfg.max_iteration, fcfg.track_precision
    H, W = img_a.shape
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    hi = float(S - P - 1)
    c_off = (P - 1) / 2.0
    r = P // 2 + 1
    corners = detect_grid_corners(img_a, float(fcfg.fast_threshold), fcfg.detector_cell)
    order = torch.argsort(torch.where(corners.valid, corners.score, -1.0), descending=True)
    rows = []
    for N in (48, 96, 144):
        pts = corners.xy[order[:N]]
        with matmul_precision_scope(fcfg.matmul_precision):
            tq = kc._template_quantities(kc._interp_template(img_a, pts, P), P, norm)
            sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
            Cx, Cy, Ct = kc._surfaces_for_norm(kc._extract_at_origins(img_b, sorg, S), tq, P, norm)
        f0 = pts - c_off - sorg
        conv0 = (~tq.good).float()
        if Ct is None:
            name, fn, ref, ops_per_step = "lk_corr_iterate", kc.lk_corr_iterate, kc.lk_corr_iterate_reference, K1_OPS_PER_STEP
            surfaces = (Cx, Cy)
            sc = torch.stack([tq.G[:, 0, 0], tq.G[:, 0, 1], tq.G[:, 1, 1], tq.tgx, tq.tgy,
                              f0[:, 0], f0[:, 1], conv0], -1)
        else:
            name, fn, ref, ops_per_step = ("lk_corr_iterate_gain", kc.lk_corr_iterate_gain,
                                           kc.lk_corr_iterate_gain_reference, K3_OPS_PER_STEP)
            surfaces = (Cx, Cy, Ct)
            B = tq.Binv
            sc = torch.stack([B[:, 0, 0], B[:, 0, 1], B[:, 0, 2], B[:, 1, 0], B[:, 1, 1], B[:, 1, 2],
                              tq.tgx, tq.tgy, tq.st2, f0[:, 0], f0[:, 1], conv0], -1)
        args = (sc.contiguous(), *surfaces, iters, eps, hi)
        got = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()

        def ok_mask(f):
            p = f + c_off + sorg
            return tq.good & (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

        m_want = ok_mask(want)
        check(torch.equal(ok_mask(got), m_want), f"{name} valid mask differs at N={N} ({norm})")
        check(bool(torch.isfinite(got).all()), f"{name} gave non-finite output at N={N} ({norm})")
        err = float((got - want)[m_want].abs().max()) if bool(m_want.any()) else 0.0
        check(err <= K1_TOL, f"{name} differs by {err} px (> {K1_TOL}) at N={N} ({norm})")
        K, ns = Cx.shape[-1], len(surfaces)
        _, steps, sectors = lk_trace(args[0].cpu().numpy(), tuple(c.cpu().numpy() for c in surfaces),
                                     iters, eps, hi)
        # sc read, f written, and the sectors of each surface the steps visit.
        n_bytes = sc.numel() * 4 + N * 2 * 4 + ns * sectors * SECTOR_BYTES
        ms = cuda_ms(lambda: fn(*args), reps=200)
        plain = cuda_ms(lambda: ref(*args), reps=10)
        dev_ms = device_ms(lambda: fn(*args), f"{name}_kernel")
        b, by = bound_ms(n_bytes, int(steps.sum()) * ops_per_step)
        rows.append(dict(name=name, norm=norm, N=N, K=K, valid=int(m_want.sum()),
                         lane_steps=int(steps.sum()), max_steps=int(steps.max()), bound_bytes=n_bytes,
                         surface_bytes=N * ns * K * K * 4, max_abs_err=err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain, library_ms=None, bound_ms=b, bound_by=by))
        print(f"[{tag}] {norm} N={N} K={K}: {int(m_want.sum())} valid lanes, masks equal, max |df| {err:.2e} px "
              f"(tol {K1_TOL}); {int(steps.sum())} lane steps (max {int(steps.max())}) touching {n_bytes} B "
              f"of {N * ns * K * K * 4} B of surfaces; per call {ms:.4f} ms (device {_fmt(dev_ms)}), "
              f"plain {plain:.4f} ms, bound {b:.7f} ms ({by})")
    return rows


def phase_mode_sweep(traj, imu, frame_idx, img0, img1, mcfg):
    """Each photometric mode over the first SWEEP_FRAMES bench frames: the
    exact K1 / K3 / K2 launch split per frame (MODE_SPLIT), and finite
    poses."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB, FrontendConfig
    from msckf_stereo_c_torch.models.vio import run_vio_sequence
    from msckf_stereo_c_torch.ops import _cuda

    T = SWEEP_FRAMES
    frame_t = traj.t[frame_idx[:T]]
    out = {}
    for mode, (k1, k3) in MODE_SPLIT.items():
        fcfg = FrontendConfig(temporal_levels=1, klt_norm=mode)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_vio_sequence(fcfg, mcfg, EUROC_CALIB, frame_t, img0[:T], img1[:T], imu.t, imu.gyro, imu.acc,
                               image_dtype=torch.float32, filter_dtype=torch.float32, method="schur",
                               device="cuda")
        secs = time.perf_counter() - t0
        c = dict(_cuda.launch_counts)
        per = (c["lk_corr_iterate"] / T, c["lk_corr_iterate_gain"] / T, c["extract_windows"] / T)
        out[mode] = dict(launches=c, seconds=secs, tracks_per_frame_mean=float(np.mean(res.tracking["after_ransac"])))
        print(f"[modes] {mode:11s}: K1 {per[0]:.0f}, K3 {per[1]:.0f}, K2 {per[2]:.0f} launches/frame over {T} "
              f"frames ({secs:.2f} s incl. first-call set-up), {out[mode]['tracks_per_frame_mean']:.1f} tracks/frame")
        check(bool(np.isfinite(res.positions).all()), f"non-finite poses under klt_norm={mode!r}")
        check(c["lk_corr_iterate"] == k1 * T and c["lk_corr_iterate_gain"] == k3 * T
              and c["extract_windows"] == 10 * T,
              f"klt_norm={mode!r}: launches {c}, expected K1 {k1}, K3 {k3}, K2 10 per frame")
    return out


def phase_stress(card):
    """The stress path: ``run_stress_gate`` over the 36 s stress scene with
    klt_norm='gain', rendered on the card in chunks (752x480 stereo, 900
    room landmarks, every stress channel on), with the launch counts zeroed
    just before and read just after; then the same run once more with each
    stage timed and its host syncs counted."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import FilterConfig, FrontendConfig
    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.sim import render_torch, stress

    kw = dict(fcfg=FrontendConfig(klt_norm="gain"),
              mcfg=FilterConfig(ns_iters=10, matmul_precision="tensorfloat32"), method="schur", seed=0)
    render_s = [0.0]
    render = render_torch.TorchRenderer.render_sequence

    def timed_render(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render(self, *args, **kwargs)
        torch.cuda.synchronize()
        render_s[0] += time.perf_counter() - t0
        return out

    stress.run_stress_gate(duration=3.0, **kw)  # warm-up: first-call set-up of the stress shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render_torch.TorchRenderer.render_sequence = timed_render
    try:
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        gate = stress.run_stress_gate(duration=STRESS_SECONDS, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_cuda.launch_counts)
    finally:
        render_torch.TorchRenderer.render_sequence = render
    T = gate.n_frames
    tracks = np.asarray(gate.result.tracking["after_ransac"][5:])
    out = dict(frames=T, seconds=secs, render_seconds=render_s[0], fps=T / secs,
               fps_without_render=T / (secs - render_s[0]), ate_rmse_m=gate.ate_rmse, ate_max_m=gate.ate_max,
               min_tracks_after_ransac=gate.min_tracks_after_ransac, tracks_per_frame_mean=float(tracks.mean()),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    print(f"[stress] {T} stereo frames 752x480 (36 s stress scene, klt_norm='gain') in {secs:.3f} s: "
          f"{T / secs:.2f} frames/s with rendering, {out['fps_without_render']:.2f} frames/s without "
          f"(rendering {render_s[0]:.3f} s on the card) on {card}")
    print(f"[stress] ATE RMSE {gate.ate_rmse:.5f} m (bar 0.13 m), max {gate.ate_max:.5f} m; tracks per frame "
          f"mean {tracks.mean():.1f} (bar 30), min {gate.min_tracks_after_ransac} (bar > 3)")
    print(f"[stress] launches: {counts}; peak device memory {out['peak_memory_gb']:.2f} GB")
    check(bool(np.isfinite(gate.result.positions).all()), "non-finite poses on the stress path")
    check(counts["lk_corr_iterate_gain"] == 7 * T and counts["lk_corr_iterate"] == 0
          and counts["extract_windows"] == 10 * T,
          f"stress path launches {counts}, expected K3 7, K1 0, K2 10 per frame")
    check(gate.ate_rmse < 0.13, f"stress ATE {gate.ate_rmse} m is above the 0.13 m bar")
    check(gate.min_tracks_after_ransac > 3, f"stress min tracks {gate.min_tracks_after_ransac} (bar > 3)")
    check(tracks.mean() > 30, f"stress mean tracks {tracks.mean()} (bar > 30)")

    # One more run, each stage timed and every synchronising call counted;
    # only the package's call sites count (the stage timer's own
    # synchronise calls are not the program's).
    stages = []
    sites = count_syncs(lambda: stages.append(phase_stages(
        lambda: stress.run_stress_gate(duration=STRESS_SECONDS, **kw), T, tag="stress stages")))
    sites = {k: v for k, v in sites.items() if k.startswith("msckf_stereo_c_torch/")}
    out.update(stages=stages[0], syncs_per_frame=sum(sites.values()) / T,
               sync_sites={k: v / T for k, v in sorted(sites.items(), key=lambda kv: -kv[1])})
    print(f"[stress] host syncs per frame: {out['syncs_per_frame']:.2f} over the {T} frames "
          f"(torch sync debug mode, the stage-timed run), by call site:")
    for site, per_frame in list(out["sync_sites"].items())[:4]:
        print(f"[stress]   {per_frame:.2f}/frame at {site}")
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


def phase_stages(tail, n_tail, tag="stages"):
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
    print(f"[{tag}] {n_tail} frames, each stage synchronised: {out['frame']:.2f} ms/frame")
    for label, ms in out.items():
        if label != "frame":
            print(f"[{tag}]   {ms:8.3f} ms/frame  {label}")
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

    rows = phase_kernels(img0, img1, fcfg) + phase_k3(fcfg)
    main_out = phase_main_path(traj, imu, frame_idx, img0, img1, fcfg, mcfg, card)
    sweep_out = phase_mode_sweep(traj, imu, frame_idx, img0, img1, mcfg)
    os.makedirs(args.out, exist_ok=True)
    tail = _resume_split(traj, imu, frame_idx, img0, img1, fcfg, mcfg, N_TAIL)
    prof_out = phase_profile(tail, N_TAIL, args.out)
    stage_out = phase_stages(tail, N_TAIL)
    stress_out = phase_stress(card)

    pick = {
        "lk_corr_iterate": next(r for r in rows if r["name"] == "lk_corr_iterate" and r["N"] == 144),
        "extract_windows": next(r for r in rows if r["name"] == "extract_windows" and r["level"] == 0
                                and r["S"] == 37),
        "lk_corr_iterate_gain": next(r for r in rows if r["name"] == "lk_corr_iterate_gain" and r["N"] == 144
                                     and r["norm"] == "gain"),
    }
    # K1 and K2 launch counts come from the bench path, K3's from the stress
    # path (the bench path runs klt_norm='none', which never launches K3).
    launches = dict(main_out["launches"], lk_corr_iterate_gain=stress_out["launches"]["lk_corr_iterate_gain"])
    kernels = []
    for kname, (source, replaces) in KERNEL_SOURCES.items():
        r = pick[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": name, "build_seconds": build["seconds"],
                   "build_logs": build["logs"], "kernel_rows": rows, "main_path": main_out,
                   "mode_sweep": sweep_out, "profile": prof_out, "stages": stage_out,
                   "stress_path": stress_out, "seconds": time.time() - t_start},
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
