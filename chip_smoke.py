#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``msckf_stereo_c_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases (``PHASES``, in this order), each of which fails the run (exit code 1)
if it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every ``msckf_stereo_c_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a`` (into ``build/torch_kernels/``), all sources at once;
3. scene: the FRAMES stereo frames of the bench scene (``bench.bench_scene``),
   rendered on the host;
4. kernels, and kernels on stress inputs (``phase_k3``): each hand-written
   kernel against its plain PyTorch version on the
   card, at the shapes the main paths give it, with inputs cut from real
   frames (K2, ``extract_template``, ``resample_template``, the loop-only K1
   and ``lk_corr_align`` from the bench scene; ``lk_corr_align_gain`` and
   the loop-only K3 from the stress scene, with 'gain' and with 'offset'
   filters); kernel, device, plain and library-call times (CUDA events,
   torch.profiler) beside the least time the card could take, and for the
   redesigned kernels the kernel chains they replace, timed in the same
   run; ``lk_corr_align``, ``lk_corr_align_gain`` (N=144) and
   ``resample_template`` again at one and three bf16 passes against their
   plain versions at the same passes, with the same bars, and their
   device times; ``fast_grid_corners`` on B = 1 and 512 presmoothed bench
   frames against its plain version (``fast_rows``); ``qr_compress`` on
   stacked textbook-update rows at the eval cell's (512, 2560, 142) in
   float32 and at B=4 in float64 against ``torch.linalg.qr`` (``qr_rows``);
   ``lm_triangulate`` at the cells' (B, 32, 20) for B = 1, 5, 512 in
   float32 and B=1 in float64 against its plain version, the masked LM
   loop, over windows of 16,384 tracks launched B lanes a call
   (``lm_rows``, by tests/_lm_cases.py:lm_hold);
5. kernels on a stack: the four kernels of the main path on a B=4 image stack
   with a per-window image index, against their plain versions and against
   one launch per lane (bit-equal);
6. main path: ``run_vio_sequence`` over the bench scene (752x480 stereo,
   the configuration ``bench.py`` runs, B=1) with the kernel launch counts
   zeroed just before and read just after (7 ``lk_corr_align``, 4
   ``extract_template``, 1 ``resample_template``, 1 ``fast_grid_corners``
   and none of the others per frame: "7 / 4 / 1 / 1" below; here and in
   every later phase also the filter's ``lm_triangulate``, once a
   lost-track update and once a camera prune: T to 2T over T frames,
   ``launches_match``); frames/s, ATE, tracks, host syncs;
7. mode sweep: each ``klt_norm`` mode over 20 bench frames, with the exact
   launch split per frame it must give (``launches_per_frame``);
8. methods: the last METHOD_FRAMES bench frames from the state the frames
   before them leave, under each filter method (``METHOD_RUNS``: 'qr',
   'cholesky' and 'schur' with exact solves and 'schur' with 10
   Newton-Schulz iterations in float32, 'qr' and 'cholesky' in float64):
   ATE under 0.13 m, frames/s, host syncs by call site, launches exactly
   7 / 4 / 1 / 1 a frame (and under 'qr' one ``qr_compress`` a lost-track
   update and a camera prune: T to 2T), the float64 methods within 1e-4 m
   of each other, and
   ``run_vio_sequence(internals_at=INTERNALS_AT)`` with every key of the
   dump and the poses of the run without it;
9. distinct lanes: B=4 sequences of the bench scene, each starting at its
   own trajectory offset (rendered on the card), stepped together over
   DISTINCT_FRAMES frames by ``parallel/vio_multiseq.py:run_vio_batch``
   with the launch counts zeroed just before and read just after (the same
   7 / 4 / 1 / 1 per batched frame), against four one-lane runs: feature ids
   and validity equal on the first 10 frames, each lane's ATE within
   2e-4 m of its one-lane run;
10. stage split: the last N_TAIL bench frames from the state the frames
   before them leave, broadcast to B lanes in SPLIT_BATCHES that share the
   images and the IMU, under the profiler, read by the spans the program
   opens around each stage of a frame (``scripts/stage_split.py``:
   ``LABELS``, the parts of both updates keyed by their parent) and nothing
   synchronised: host and device ms, device ops and share of the step's
   device time per stage; every label with device events, each
   sub-phase's device time within its parent's, the front end's and the
   filter's totals plus the device time in no stage equal to the step's
   device total within 1 %, launches exact;
11. precision: the bf16 precision names (``phase_precision``): the
   filter/front-end specs of PRECISION_SPECS over the first
   PRECISION_FRAMES bench frames at B=1 through ``run_vio_sequence``, each
   with its launches exact, frames/s, host syncs and ATE (under 0.13 m
   for the three-pass specs and the bench's; the one-pass specs recorded
   as found, a non-finite ATE included), and every spec's positions apart
   from the bench spec's;
12. euroc: the bench scene's frames written as a EuRoC ``mav0/`` directory
   (PNGs whose rows use all five filters) and read back through the
   package's apps: the decoder exact, ``apps/run_euroc.py`` with the three
   in-repo YAMLs (launches per frame from the loaded config's pyramid
   levels, TUM rows at epoch times, ATE, poses equal to
   ``run_vio_sequence``'s, frames/s, decode time, host syncs), a checkpoint
   save and resume, ``apps/run_euroc_batch.py`` with B=2 (one lane padded)
   against one-lane runs, and ``entry.entry()``'s step on the card
   (``phase_euroc``);
13. frontend paths: the tracker's paths off the bench configuration at
   752x480 through ``run_vio_sequence`` (``phase_frontend_paths``): the
   fast-motion scene at temporal LK depths 2 and 4, and 1 where the
   phase's 100 s allow it, with tests/test_fast_motion.py's bars, the reference's own tracker
   (``REFERENCE_TRACKER``) over the 60 bench frames with its RANSAC
   rejections counted, and ``BENCH_PATHS`` over 20 bench frames each; every
   run's launches exact (``launches_per_frame``), frames/s, ATE, and its
   host syncs by site, every site one the bench configuration has; then
   ``lk_corr_align`` and ``extract_template`` on the new call patterns
   (temporal levels 2 and 3 with two lanes folded in, the standalone anchor
   call) against their plain versions;
14. stress path: ``sim/stress.py:run_stress_gate`` over the 36 s stress scene
   (721 stereo frames rendered on the card with every stress channel on,
   ``klt_norm='gain'``), launch counts zeroed just before and read just
   after (7 ``lk_corr_align_gain``, 4 ``extract_template``, 1
   ``resample_template`` and none of the others per frame), the gate's ATE
   and track bars, frames/s and render time;
15. stress lanes: robustness seeds STRESS_LANE_SEEDS as the lanes of one
   ``sim/stress.py:run_stress_lanes`` run over STRESS_LANE_SECONDS of the
   stress scene (``klt_norm='none'``; each lane its own landmarks, IMU
   noise, photometric draws and images), launches 7 / 4 / 1 / 1 per batched
   frame, against each seed's one-lane ``run_stress_gate``: ids and
   validity equal on the first 10 frames; with the filter in float64 the
   ATEs within 2e-4 m, in float32 (the stress script's dtype, whose batched
   products round by batch shape; over STRESS_LANE_F32_SECONDS) the ATE
   gap recorded;
16. backend: the refinement back end on the card in float64
   (``phase_backend``): (a) the main path's VioResult through
   ``parallel/refine.py:build_ba_problem`` (keyframes every 5 frames) and
   ``refine_trajectory(iters=8)``, held to the same call on CPU tensors
   (BA_CARD_TOL), costs falling, keyframe ATE before and after, ms a
   Gauss-Newton step, and one synthetic problem at the 40 s gate's size
   (BA_GATE_SIZE) timed; (b) ``STRESS_REFINE``'s tier on the stress
   path's run (``scripts/stress_gate.py:refine_stats``); (c) the
   multi-session gate at MS_SECONDS with its sessions as two lanes of one
   run, launch counts zeroed just before and read just after (exact per
   batched frame), tests/test_multisession.py's bars, wall time split; (d)
   the sharded BA and pose graph over ``gloo`` in DIST_WORLD processes on
   the one card (CUDA tensors), each rank equal to the one-process solve
   within DIST_TOL;
17. multiproc: the multi-process tier on the card (``phase_multiproc``):
   (a) ``entry.dryrun_multichip(2)``, the bench configuration at 752x480,
   2 lanes x 22 frames in one process and then as 2 ranks over ``gloo``
   on the one card; (b) the ``vio`` workers (half resolution, 4 lanes over
   2 ranks, 8 frames) and the ``ba`` workers in float64; (c) the ``bench``
   workers, one lane a rank, timed against the one-process 2-lane chunk.
   Every rank's launches exactly 7 / 4 / 1 / 1 per batched frame, each rank's
   lanes against a one-process run of its own block (ids and validity on
   the first 10 frames, positions within 2e-4 m), the all-reduced
   ``total_tracks`` equal to the sum of the ranks' own totals, the BA
   ranks within 1e-9 of the one-process solve;
18. the card's name and power limit, the ``{"kernels": [...]}`` line, then
   ``{"ok": true, "device": ...}`` as the last line.

Details go to ``<out>/chip_smoke.json``, one record per phase under its
label, with each phase's seconds.  The script imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

from bench_vio.roofline.lk import (
    F32_OPS_PER_S, K1_OPS_PER_STEP, K3_OPS_PER_STEP, SECTOR_BYTES, bound_ms, footprint_sectors, lk_trace,
    window_sectors)
from bench_vio.trace.syncs import count_syncs, package_sites

ROOT = os.path.dirname(os.path.abspath(__file__))

K1_TOL = 0.02  # 2 * eps: a lane may freeze one (sub-eps) step apart
FRAMES = 60  # main-path frames, 752x480 stereo (bench.py's scene)
N_TAIL = 8  # last bench frames of the stage split, from the state the frames before them leave
SWEEP_FRAMES = 20  # bench frames per photometric mode in the mode sweep
STRESS_SECONDS = 36.0  # the stress gate's short run (721 stereo frames)
STACK_LANES = 4  # images in the stack of the batched-kernel checks
DISTINCT_FRAMES = 30  # frames of the distinct-lane run
# The filter methods over the last METHOD_FRAMES bench frames, from the state
# the frames before them leave: the camera window is full there, so every
# frame prunes, and lost tracks update the filter (the first 20 frames are
# the 1.5 s rest, where neither runs).  (label, method, ns_iters, filter dtype)
METHOD_FRAMES = 20
METHOD_RUNS = (
    ("qr", "qr", 0, "float32"), ("cholesky", "cholesky", 0, "float32"), ("schur ns0", "schur", 0, "float32"),
    ("schur ns10", "schur", 10, "float32"), ("qr f64", "qr", 0, "float64"), ("cholesky f64", "cholesky", 0, "float64"),
)
INTERNALS_AT = 15  # the frame of the methods' run_vio_sequence(internals_at=...)
# The keys of the JAX package's filter_internals, and the frontend's.
INTERNAL_KEYS = (
    "num_cams", "cam_q", "cam_p", "cov_diag", "candidate_idx", "candidate_fid", "candidate_use", "candidate_dof",
    "n_lost_short", "n_candidates", "pos_w", "obs", "obs_mask", "H_x_blocks", "H_f_blocks", "r_blocks", "H_o",
    "r_o", "rows_valid", "gamma_qr", "gamma_schur", "chi2_threshold", "gate_pass_qr", "gate_pass_schur",
    "frontend_fid", "frontend_uv", "frontend_valid",
)
STRESS_LANE_SEEDS = (0, 1)  # robustness seeds of the stress-lane run
STRESS_LANE_SECONDS = 4.0  # its length in float64 (81 stereo frames; 6 s before the [multiproc] phase)
STRESS_LANE_F32_SECONDS = 3.0  # its length in float32 (61 stereo frames)
SPLIT_BATCHES = (1, 16, 1024)  # B of the stage split phase
# The [precision] phase: filter/front-end specs over the first
# PRECISION_FRAMES bench frames, each with whether its ATE is held under
# 0.13 m (the one-pass specs are recorded as found).
PRECISION_FRAMES = 30
PRECISION_SPECS = (
    ("tensorfloat32/tensorfloat32", True),  # the bench configuration
    ("bfloat16_3x/bfloat16_3x", True),
    ("float32/bfloat16_3x", True),
    ("float32/bfloat16", False),
    ("bfloat16/tensorfloat32", False),
)
# The back end (phase_backend).  Card against CPU for the main path's BA:
# costs within BA_CARD_TOL relative, positions and landmarks within
# BA_CARD_TOL m; the distributed ranks against the one-process solve on the
# card: tests/test_ba.py's and tests/test_posegraph.py's tolerances for the
# sharded forms (costs rtol 1e-6; BA poses 1e-9 m, pose-graph poses 1e-8),
# landmarks within 1e-8 m.
BA_CARD_TOL = 1e-6
BA_GATE_SIZE = (160, 400)  # keyframes x landmarks of the 40 s multi-session gate's BA problems
MS_SECONDS = 12.0  # the multi-session gate's sessions (tests/test_multisession.py:136)
MS_CHUNK = 48
DIST_WORLD = 2
DIST_TOL = dict(costs_rtol=1e-6, ba_poses_m=1e-9, landmarks_m=1e-8, graph_poses_m=1e-8)
# The [frontend-paths] phase (ported in slice 8): the fast-motion scene
# (tests/test_fast_motion.py) at each temporal LK depth with its ATE bar,
# the reference's own tracker over the FRAMES bench frames, and the bench
# scene's other paths over PATH_FRAMES frames each; host syncs counted over
# SYNC_FRAMES frames of each.  The FAST_LAST depth runs last, and only if
# the phase, at its pace so far, ends within PATHS_SECONDS.
FAST_TLEVELS = ((2, 0.13), (4, 0.25))
FAST_LAST = (1, 0.13)
PATHS_SECONDS = 100.0
PATH_FRAMES = 20
SYNC_FRAMES = 10
REFERENCE_TRACKER = dict(
    pyramid_levels=4, temporal_levels=4, stereo_levels=4, tmpl_carry=False, anchor_refine=False,
    translation_seed=False, stereo_lr_threshold=0.0, presmooth=False, fast_threshold=10, cand_budget=0,
    ransac_enabled=True,
)
BENCH_PATHS = {
    "unfused, carried templates, standalone anchor": dict(stereo_lr_threshold=0.0),
    "left-right check on candidates only": dict(stereo_lr_survivors=False),
    "two temporal levels, 'gain'": dict(temporal_levels=2, klt_norm="gain"),
    "gather LK": dict(klt_impl="gather"),
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
    "lk_corr_align": (
        "msckf_stereo_c_torch/csrc/lk_corr_align.cu",
        "msckf_stereo_c_tpu/ops/klt_corr.py:85",
    ),
    "extract_template": (
        "msckf_stereo_c_torch/csrc/extract_template.cu",
        "msckf_stereo_c_tpu/ops/patch_extract.py:28",
    ),
    "lk_corr_align_gain": (
        "msckf_stereo_c_torch/csrc/lk_corr_align_gain.cu",
        "msckf_stereo_c_tpu/ops/klt_corr.py:144",
    ),
    "resample_template": (
        "msckf_stereo_c_torch/csrc/resample_template.cu",
        "msckf_stereo_c_tpu/ops/patch_extract.py:28",
    ),
    # No Pallas kernel: the jnp fast_score_map and detect_grid_corners that
    # XLA fused on the TPU.
    "fast_grid_corners": (
        "msckf_stereo_c_torch/csrc/fast_grid_corners.cu",
        "msckf_stereo_c_tpu/ops/fast.py:28",
    ),
    # No Pallas kernel: the jnp.linalg.qr of the textbook update's
    # compression, which XLA lowered on the TPU.
    "qr_compress": (
        "msckf_stereo_c_torch/csrc/qr_compress.cu",
        "msckf_stereo_c_tpu/models/update.py:compress_measurements",
    ),
    # No Pallas kernel: the per-track lax.while_loop of triangulate_track,
    # which XLA vmapped over the track pool.
    "lm_triangulate": (
        "msckf_stereo_c_torch/csrc/lm_triangulate.cu",
        "msckf_stereo_c_tpu/models/triangulation.py:triangulate_track",
    ),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def profiled_twice(take, tag: str):
    """``take()`` -> (result, number of device events in its profile); taken
    once more when the profile is empty, and the run fails if it is empty
    again.  Returns (result, attempts)."""
    for attempt in (1, 2):
        result, n_events = take()
        if n_events:
            return result, attempt
        print(f"{tag} attempt {attempt}: the profiler recorded no device event")
    check(False, f"{tag} the profiler recorded no device event in two runs")


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


def device_ms_per_call(fn, reps: int = 50):
    """Mean device time in ms of one call of ``fn``: every kernel and copy
    it launches, as torch.profiler records them over ``reps`` calls; None
    when it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    device = dict(card=card, kind=name, count=torch.cuda.device_count())
    return device, device


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


def phase_scene():
    """The FRAMES stereo frames of the bench scene (``bench.bench_scene``),
    rendered on the host; hands on the scene and its fields."""
    from msckf_stereo_c_torch.bench import bench_scene

    scene = bench_scene(FRAMES)
    print(f"[scene] {FRAMES} stereo frames {scene.img0.shape[2]}x{scene.img0.shape[1]} rendered")
    return dict(frames=FRAMES, height=scene.img0.shape[1], width=scene.img0.shape[2]), \
        dict(scene=scene, **scene._asdict())


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

    # The template kernel, K1 and lk_corr_align on real features: FAST
    # corners of one frame tracked into the next.
    corners = _best_corners(pyr_a[0], fcfg, 144)
    rows += template_rows(pyr_a, corners, fcfg.patch_size)
    rows += resample_rows(pyr_a[0], pyr_b[0], corners, fcfg)
    rows += lk_rows("K1", pyr_a[0], pyr_b[0], fcfg, "none")
    rows += align_rows(pyr_a, pyr_b, corners, fcfg, "none")
    return rows + fast_rows(img0, fcfg) + qr_rows() + lm_rows()


FAST_BATCHES = (1, 512)  # the live cell's lanes and the eval cell's
FAST_RTOL = 1e-4  # the plain version's torch.sum adds the 16 circle terms in another order


def fast_rows(img0, fcfg):
    """``fast_grid_corners`` against its plain version at the main path's
    shapes: B presmoothed 480x752 bench frames (frame b mod T at lane b),
    the front end's threshold and cell.  The corner mask exact and the score
    map within FAST_RTOL (``score_out``); the cell picks equal outside
    near-tie cells (top two plain scores within FAST_RTOL); one launch a
    call.  Per-call and device time; the bound, one read of the images and
    13 bytes a cell written; the plain version's per-call and device time,
    which is the chain the kernel replaces (``fast_score_map``'s 16-plane
    tensors and rolls, then ``argmax`` and ``gather``)."""
    import torch

    from msckf_stereo_c_torch.models.frontend import pyramids_for
    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.ops.fast import detect_grid_corners, detect_grid_corners_reference, fast_score_map

    dev = torch.device("cuda")
    thr, cell = float(fcfg.fast_threshold), fcfg.detector_cell
    frames = torch.as_tensor(img0, device=dev)
    rows = []
    for B in FAST_BATCHES:
        imgs = pyramids_for(frames[torch.arange(B, device=dev) % frames.shape[0]].contiguous(), fcfg)[0]
        _, H, W = imgs.shape
        Gy, Gx = H // cell, W // cell
        score_out = torch.zeros_like(imgs)
        before = _cuda.launch_counts["fast_grid_corners"]
        got = detect_grid_corners(imgs, thr, cell, score_out=score_out)
        check(_cuda.launch_counts["fast_grid_corners"] == before + 1, "fast_grid_corners: not one launch a call")
        want = detect_grid_corners_reference(imgs, thr, cell)
        smap = fast_score_map(imgs, thr)[:, : Gy * cell, : Gx * cell]
        kmap = score_out[:, : Gy * cell, : Gx * cell]
        torch.cuda.synchronize()
        check(torch.equal(kmap > 0, smap > 0), f"fast_grid_corners B={B}: corner mask differs from the plain map")
        gap = (kmap - smap).abs()
        rel = float((gap / smap.clamp_min(torch.finfo(torch.float32).tiny)).max())
        abs_err = float(gap.max())
        check(rel <= FAST_RTOL, f"fast_grid_corners B={B}: score {rel:.3g} relative from the plain map")
        tiles = smap.reshape(B, Gy, cell, Gx, cell).transpose(2, 3).reshape(B, Gy * Gx, cell * cell)
        top = torch.topk(tiles, 2, dim=-1).values
        near = (top[..., 0] > 0) & (top[..., 0] - top[..., 1] <= FAST_RTOL * top[..., 0])
        same = (got.valid == want.valid) & (got.xy == want.xy).all(-1)
        check(bool((same | near).all()), f"fast_grid_corners B={B}: {int((~same & ~near).sum())} cell picks differ")
        n_near, n_corners, n_valid = int(near.sum()), int((smap > 0).sum()), int(want.valid.sum())
        del want, smap, kmap, tiles, top, gap, score_out
        torch.cuda.empty_cache()

        def kernel():
            return detect_grid_corners(imgs, thr, cell)

        def plain():
            return detect_grid_corners_reference(imgs, thr, cell)

        reps = 50 if B == 1 else 10
        plain_reps = 20 if B == 1 else 2
        ms = cuda_ms(kernel, reps=reps)
        dev_ms = device_ms(kernel, "fast_grid_corners_kernel", reps=reps)
        plain_ms = cuda_ms(plain, reps=plain_reps, warmup=1)
        chain_ms = device_ms_per_call(plain, reps=plain_reps)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernel()
        kernel_mem = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        plain()
        plain_mem = torch.cuda.max_memory_allocated() - base
        torch.cuda.empty_cache()
        b, by = bound_ms(imgs.numel() * 4 + B * Gy * Gx * 13, 0)
        rows.append(dict(name="fast_grid_corners", B=B, H=H, W=W, cell=cell, threshold=thr, corners=n_corners,
                         valid_cells=n_valid, near_ties=n_near, max_rel_err=rel, max_abs_err=abs_err,
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms, chain_device_ms=chain_ms, library_ms=None,
                         bound_ms=b, bound_by=by, kernel_peak_bytes=kernel_mem, plain_peak_bytes=plain_mem))
        print(f"[fast] B={B} {W}x{H} cell={cell} t={thr:g}: {n_corners} corners, {n_valid} valid cells, "
              f"{n_near} near ties, score within {rel:.3g} relative, picks equal; per call {ms:.4f} ms (device "
              f"{_fmt(dev_ms)}), plain {plain_ms:.4f} ms (device {_fmt(chain_ms)}), bound {b:.5f} ms ({by}); "
              f"peak {kernel_mem / 2**30:.4f} GiB against the plain version's {plain_mem / 2**30:.4f} GiB")
        del imgs
    return rows


# The eval cell's compression: B lanes of K = 32 tracks of 4M = 80 rows
# (M = 20 camera slots), n = 21 + 6M + 1 = 142 columns.
QR_SHAPE = (512, 32, 20)
# R^T R against A^T A (float64), over max |A^T A| of each lane, at the eval
# cell's (512, 2560, 142): the kernel read 6.9e-7 in float32 and 2.2e-15 in
# float64, torch.linalg.qr 3.3e-7 and 1.7e-15; the limits keep over 10x of
# room, and Householder's worst-case growth, sqrt(m n) eps (7e-5 in
# float32), lies past the float32 one.
QR_RTOL = {"float32": 1e-5, "float64": 1e-12}


def qr_problem(B: int, K: int, M: int, seed: int = 0, dtype=None, device=None):
    """Stacked rows (B, K * 4M, 22 + 6M) shaped as the textbook update's
    [H | r]: the 21 IMU columns zero, each lane's first 1..K tracks with
    4n - 3 nonzero rows over its n in 2..M observed camera slots, the other
    tracks' rows zero, lane 0 with no track at all."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    D = 21 + 6 * M
    A = np.zeros((B, K, 4 * M, D + 1))
    for b in range(1, B):
        for k in range(int(rng.integers(1, K + 1))):
            slots = np.sort(rng.choice(M, size=int(rng.integers(2, M + 1)), replace=False))
            rows = 4 * slots.size - 3
            for s_ in slots:
                A[b, k, :rows, 21 + 6 * s_: 27 + 6 * s_] = rng.normal(size=(rows, 6))
            A[b, k, :rows, D] = 1e-3 * rng.normal(size=rows)
    return torch.as_tensor(A.reshape(B, K * 4 * M, D + 1), dtype=dtype or torch.float32, device=device)


def qr_gram_gap(A, R):
    """Per lane, max |R^T R - A^T A| over max |A^T A| (float64; 0 for an
    empty lane)."""
    import torch

    A64, R64 = A.double(), R.double()
    G = A64.transpose(-1, -2) @ A64
    gap = (R64.transpose(-1, -2) @ R64 - G).abs().amax((-2, -1))
    return gap / G.abs().amax((-2, -1)).clamp_min(1e-300)


def qr_rows(shape=QR_SHAPE):
    """``qr_compress`` against ``torch.linalg.qr`` (its plain version) on
    ``qr_problem`` rows: in float32 at the eval cell's (B, K, M), and in
    float64 at B=4; R^T R within QR_RTOL of A^T A for both, the empty lane
    exactly 0, one launch a call.  Per-call and device time; the bound,
    Householder's 2mn^2 - 2n^3/3 operations a lane against one read of A
    and R written; the plain version's per-call and device time (one
    cuSOLVER geqrf per lane, launched from the host)."""
    import torch

    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.ops.linalg import qr_r, qr_r_reference

    dev = torch.device("cuda")
    B, K, M = shape
    rows = []
    for dname, lanes in (("float32", B), ("float64", 4)):
        A = qr_problem(lanes, K, M, seed=lanes, dtype=getattr(torch, dname), device=dev)
        _, m, n = A.shape
        before = _cuda.launch_counts["qr_compress"]
        R = qr_r(A)
        check(_cuda.launch_counts["qr_compress"] == before + 1, "qr_compress: not one launch a call")
        R_plain = qr_r_reference(A)
        torch.cuda.synchronize()
        gap = float(qr_gram_gap(A, R).max())
        plain_gap = float(qr_gram_gap(A, R_plain).max())
        check(gap <= QR_RTOL[dname], f"qr_compress {dname}: R^T R {gap:.3g} from A^T A (limit {QR_RTOL[dname]})")
        check(bool((R[0] == 0).all()), f"qr_compress {dname}: the empty lane's R is not 0")
        check(bool(torch.equal(R, R.triu())), f"qr_compress {dname}: R is not upper triangular")
        del R, R_plain
        ms = cuda_ms(lambda: qr_r(A), reps=10)
        dev_ms = device_ms(lambda: qr_r(A), "qr_compress_kernel", reps=10)
        plain_ms = cuda_ms(lambda: qr_r_reference(A), reps=2, warmup=1)
        plain_dev = device_ms_per_call(lambda: qr_r_reference(A), reps=2)
        size = A.element_size()
        b, by = bound_ms(lanes * (m * n + n * n) * size, lanes * (2.0 * m * n * n - 2.0 * n ** 3 / 3.0))
        rows.append(dict(name="qr_compress", dtype=dname, B=lanes, m=m, n=n, max_rel_gram_gap=gap,
                         plain_max_rel_gram_gap=plain_gap, max_abs_err=gap, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, plain_device_ms=plain_dev, library_ms=None, bound_ms=b, bound_by=by))
        print(f"[qr] {dname} B={lanes} m={m} n={n}: R^T R within {gap:.3g} of A^T A (plain {plain_gap:.3g}), "
              f"empty lane 0; per call {ms:.4f} ms (device {_fmt(dev_ms)}), plain {plain_ms:.4f} ms (device "
              f"{_fmt(plain_dev)}), bound {b:.5f} ms ({by})")
        del A
        torch.cuda.empty_cache()
    return rows


# The cells' triangulations: B lanes of K0 = 32 tracks over M = 20 camera
# slots (the lost-track update's and the camera prune's compacted tracks).
# The kernel is held to its plain version by tests/_lm_cases.py:lm_hold.
LM_SHAPES = ((1, 32, 20), (5, 32, 20), (512, 32, 20))
# Floating-point operations of one LM step per observation: its projection
# and Jacobian rows, Huber weight and J^T J, J^T r terms (~90), the trial
# cost's projection and residual (~20), twice a slot for its two views.
LM_OPS_PER_OBS_STEP = 110


def _lm_cases():
    """tests/_lm_cases.py, the triangulation problems and comparison the
    card tests share."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _lm_cases

    return _lm_cases


def lm_rows(shapes=LM_SHAPES):
    """``lm_triangulate`` against its plain version
    (``triangulate_tracks_reference``, the masked loop with its host read
    an iteration) at the cells' shapes, in float32, and in float64 at the
    first, by ``tests/_lm_cases.py:lm_hold`` on ``lm_pool``'s window of
    16,384 tracks, one launch per B lanes.  Per-call and device time at the
    shape; the bound, one read of the inputs and the outputs written
    against LM_OPS_PER_OBS_STEP operations an observation and step of the
    steps run; the plain version's per-call and device time and its device
    events (one kernel or copy each)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from msckf_stereo_c_torch.models import triangulation as tri
    from msckf_stereo_c_torch.ops import _cuda

    cases = _lm_cases()
    dev = torch.device("cuda")
    rows = []
    for dname, (B, K0, M) in [("float32", s) for s in shapes] + [("float64", shapes[0])]:
        pool = cases.lm_pool(B, K0, M, seed=B + M, dtype=getattr(torch, dname), device=dev)
        before = _cuda.launch_counts["lm_triangulate"]
        got, pool_steps, calls = cases.lm_kernel_calls(pool, B)
        check(_cuda.launch_counts["lm_triangulate"] == before + calls, "lm_triangulate: not one launch a call")
        k, n, missed = cases.lm_hold(pool, got, pool_steps)
        torch.cuda.synchronize()
        check(not missed, f"lm_triangulate {dname} B={B}: " + "; ".join(missed))
        args = tuple(x if i in (4, 5) else x[:B] for i, x in enumerate(pool))
        steps = pool_steps[:B]
        ms = cuda_ms(lambda: tri.triangulate_tracks(*args), reps=50)
        dev_ms = device_ms(lambda: tri.triangulate_tracks(*args), "lm_triangulate_kernel", reps=50)
        plain_ms = cuda_ms(lambda: tri.triangulate_tracks_reference(*args), reps=5, warmup=1)
        plain_dev = device_ms_per_call(lambda: tri.triangulate_tracks_reference(*args), reps=5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tri.triangulate_tracks_reference(*args)
            torch.cuda.synchronize()
        plain_events = sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA)
        obs, valid = args[0], args[1]
        size = obs.element_size()
        n_bytes = (obs.numel() + args[2].numel() + args[3].numel() + B * K0 * 3) * size + valid.numel() + B * K0 * 9
        work = float((steps.double() * (2 * valid.sum(-1)).double()).sum())
        b, by = bound_ms(n_bytes, work * LM_OPS_PER_OBS_STEP)
        rows.append(dict(name="lm_triangulate", dtype=dname, B=B, K0=K0, M=M, pool_tracks=k["tracks"], kernel=k,
                         nudged_plain=n, max_abs_err=k["max_gap_valid_m"], ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, plain_device_ms=plain_dev, plain_device_events=plain_events,
                         library_ms=None, bound_ms=b, bound_by=by))
        print(f"[lm] {dname} B={B} K0={K0} M={M}, {k['tracks']} tracks in {calls} calls: kernel against plain "
              f"(nudged plain against plain): steps agree {k['steps_agree']:.4f} ({n['steps_agree']:.4f}), valid "
              f"{k['valid_agree']:.5f} ({n['valid_agree']:.5f}), beyond {cases.LM_POS_TOL[dname]:g} m "
              f"{k['far_share']:.5f} ({n['far_share']:.5f}), widest converged {k['max_pos_gap_m']:.3g} m "
              f"({n['max_pos_gap_m']:.3g}), widest valid {k['max_gap_valid_m']:.3g} m ({n['max_gap_valid_m']:.3g}), "
              f"most steps {k['max_steps']}; per call {ms:.4f} ms (device {_fmt(dev_ms)}), plain {plain_ms:.4f} ms "
              f"(device {_fmt(plain_dev)}, {plain_events} device events), bound {b:.3g} ms ({by})")
    return rows


def _best_corners(img, fcfg, n):
    """The ``n`` strongest FAST grid corners of ``img`` (N, 2) [x, y]."""
    import torch

    from msckf_stereo_c_torch.ops.fast import detect_grid_corners

    corners = detect_grid_corners(img, float(fcfg.fast_threshold), fcfg.detector_cell)
    order = torch.argsort(torch.where(corners.valid, corners.score, -1.0), descending=True)
    return corners.xy[order[:n]].contiguous()


def template_rows(pyr, corners, P):
    """``extract_template`` bit-exact against its plain version on every
    pyramid level: 138 corners of level 0 scaled to the level, plus six
    points at and past the image edges that the kernel must clamp; per-call,
    device, plain, library (``grid_sample``) and bound times, beside the
    pair it replaces (origins and offsets, K2, the four-slice blend)."""
    import torch
    import torch.nn.functional as F

    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.ops.patch_extract import extract_windows

    rows = []
    q, Tq = P + 2, P + 3
    for lvl, img in enumerate(pyr):
        H, W = img.shape
        edge = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [-3.2, 5.5], [W + 2.7, H / 2.0],
                             [0.4, H - 0.6], [W - 1.5, 0.25]], device=img.device)
        pts = torch.cat([corners[:138] / 2.0**lvl, edge]).contiguous()
        N = pts.shape[0]
        got = kc.extract_template(img, pts, P)
        want = kc.extract_template_reference(img, pts, P)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"extract_template differs from its plain version at level {lvl}")

        def before():
            torg, a = kc._template_geometry(pts, P, H, W)
            return kc._blend_template(extract_windows(img, torg.to(torch.int32), Tq), a, P)

        check(torch.equal(before(), want), f"the K2 + blend template pair differs at level {lvl}")
        c = torch.arange(q, device=img.device, dtype=torch.float32)
        x = (pts[:, 0, None, None] - (P + 1) / 2.0 + c[None, None, :]).expand(N, q, q)
        y = (pts[:, 1, None, None] - (P + 1) / 2.0 + c[None, :, None]).expand(N, q, q)
        grid = torch.stack([2.0 * x / (W - 1) - 1.0, 2.0 * y / (H - 1) - 1.0], -1).reshape(1, N * q, q, 2)
        ms = cuda_ms(lambda: kc.extract_template(img, pts, P), reps=200)
        plain = cuda_ms(lambda: kc.extract_template_reference(img, pts, P), reps=50)
        lib = cuda_ms(lambda: F.grid_sample(img[None, None], grid, mode="bilinear", align_corners=True), reps=200)
        before_ms = cuda_ms(before, reps=200)
        dev_ms = device_ms(lambda: kc.extract_template(img, pts, P), "extract_template_kernel")
        before_dev = device_ms_per_call(before)
        torg, _ = kc._template_geometry(pts, P, H, W)
        n_bytes = window_sectors(torg.long().cpu().numpy(), Tq, H, W) * SECTOR_BYTES + N * q * q * 4 + N * 2 * 4
        b, by = bound_ms(n_bytes, 0)
        rows.append(dict(name="extract_template", level=lvl, H=H, W=W, N=N, max_abs_err=err, ms=ms,
                         device_ms=dev_ms, plain_ms=plain, library_ms=lib, before_ms=before_ms,
                         before_device_ms=before_dev, bound_bytes=n_bytes, bound_ms=b, bound_by=by))
        print(f"[template] level {lvl} {W}x{H} N={N}: bit-exact; per call {ms:.4f} ms (device {_fmt(dev_ms)}), "
              f"before (K2 + blend) {before_ms:.4f} ms (device {_fmt(before_dev)}), plain {plain:.4f} ms, "
              f"grid_sample {lib:.4f} ms, bound {b:.6f} ms ({by}, {n_bytes} B)")
    return rows


def align_rows(pyr_a, pyr_b, corners, fcfg, norm):
    """``lk_corr_align`` (norm 'none', bench features) or
    ``lk_corr_align_gain`` ('gain', 'offset', stress features) against its
    plain version (the composition it replaces): at level 0 for N = 48 / 96
    / 144, timed beside the chain it replaces (K2 + weight stack +
    ``conv2d`` + the loop-only K1 or K3) and ``conv2d`` alone; at levels 1-3
    (N=48, the corners scaled as the coarse walk scales them; level 3's
    94-pixel rows take the 4-byte copies) as a check.  Each surface within
    1e-5 x its own max|C| of ``conv2d``'s; final points within K1_TOL; valid
    masks equal except lanes whose point lies within K1_TOL of the
    in-bounds border; frozen lanes unmoved."""
    import torch
    import torch.nn.functional as F

    from msckf_stereo_c_torch.config import matmul_precision_scope
    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.ops.patch_extract import extract_windows, extract_windows_reference

    P, iters, eps = fcfg.patch_size, fcfg.max_iteration, fcfg.track_precision
    c_off = (P - 1) / 2.0
    r = P // 2 + 1
    if norm in ("none", "zeromean"):
        name, tag, fn, ref, loop, ops_per_step, make_sc, f0_col = (
            "lk_corr_align", "align", kc.lk_corr_align, kc.lk_corr_align_reference, kc.lk_corr_iterate,
            K1_OPS_PER_STEP, kc._k1_sc, 5)
    else:
        name, tag, fn, ref, loop, ops_per_step, make_sc, f0_col = (
            "lk_corr_align_gain", f"align_gain {norm}", kc.lk_corr_align_gain, kc.lk_corr_align_gain_reference,
            kc.lk_corr_iterate_gain, K3_OPS_PER_STEP, kc._k3_sc, 9)
    rows = []
    for lvl, N in ((0, 48), (0, 96), (0, 144), (1, 48), (2, 48), (3, 48)):
        img_a, img_b = pyr_a[lvl], pyr_b[lvl]
        H, W = img_a.shape
        S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
        K, hi = S - P + 1, float(S - P - 1)
        pts = (corners[:N] / 2.0**lvl).contiguous()
        with matmul_precision_scope(fcfg.matmul_precision):
            tq = kc._template_quantities(kc.extract_template(img_a, pts, P), P, norm)
        sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
        org = sorg.to(torch.int32)
        f0 = pts - c_off - sorg
        filters = kc._filters_for_norm(tq, P, norm)
        nf = len(filters)
        sc = make_sc(tq, f0, ~tq.good)
        args = (img_b, org, S, *filters, sc, iters, eps, hi)
        surf = torch.empty((N, nf, K, K), device=img_b.device)
        surf_ref = torch.empty_like(surf)
        got = fn(*args, surfaces_out=surf)
        with matmul_precision_scope(fcfg.matmul_precision):
            want = ref(*args, surfaces_out=surf_ref)
        # The variant the main path launches (no surfaces out: frozen lanes
        # return before any copy) gives the same points, so every check on
        # ``got`` below holds for it.
        check(torch.equal(fn(*args), got),
              f"{name} without surfaces_out differs from the launch with it at level {lvl}, N={N} ({norm})")
        torch.cuda.synchronize()
        cmax = [float(surf_ref[:, i].abs().max()) for i in range(nf)]
        serr = [float((surf[:, i] - surf_ref[:, i]).abs().max()) for i in range(nf)]
        for i in range(nf):
            check(serr[i] <= 1e-5 * cmax[i], f"{name} surface {i} differs by {serr[i]} (> 1e-5 x {cmax[i]}) "
                                             f"at level {lvl}, N={N} ({norm})")

        def pts_of(f):
            return f + c_off + sorg

        def ok_mask(p):
            return tq.good & (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

        pw = pts_of(want)
        border = torch.stack([pw[:, 0] - r, (W - r) - pw[:, 0], pw[:, 1] - r, (H - r) - pw[:, 1]], -1)
        near = border.abs().min(-1).values < K1_TOL
        m_want = ok_mask(pw)
        check(torch.equal(ok_mask(pts_of(got))[~near], m_want[~near]),
              f"{name} valid mask differs at level {lvl}, N={N} ({norm})")
        check(bool(torch.isfinite(got).all()), f"{name} gave non-finite output at level {lvl}, N={N} ({norm})")
        check(torch.equal(got[~tq.good], f0[~tq.good]), f"{name} moved a frozen lane at level {lvl}, N={N} ({norm})")
        err = float((got - want)[m_want].abs().max()) if bool(m_want.any()) else 0.0
        check(err <= K1_TOL, f"{name} differs by {err} px (> {K1_TOL}) at level {lvl}, N={N} ({norm})")
        row = dict(name=name, norm=norm, level=lvl, W=W, H=H, N=N, S=S, K=K, valid=int(m_want.sum()),
                   near_border=int(near.sum()), max_abs_err=err, surface_err=serr, surface_max=cmax)
        rows.append(row)
        msg = (f"[{tag}] level {lvl} {W}x{H} N={N}: {int(m_want.sum())} valid lanes, masks equal "
               f"({int(near.sum())} lanes within {K1_TOL} px of the border exempt), max |df| {err:.2e} px "
               f"(tol {K1_TOL}), surfaces within "
               + ", ".join(f"{e:.3g} of max |C| {m:.4g}" for e, m in zip(serr, cmax)))
        if lvl:
            print(msg)
            continue

        _, steps, _, cells = lk_trace(sc.cpu().numpy(), tuple(surf_ref[:, i].cpu().numpy() for i in range(nf)),
                                      iters, eps, hi)
        n_step = int((steps > 0).sum())
        # sc read, f written, each stepping lane's filters, and the image
        # pixels under the (P, P) footprints of the surface cells the steps
        # touch: the result depends on nothing else.
        n_bytes = (footprint_sectors(org.cpu().numpy(), cells, S, P, H, W) * SECTOR_BYTES
                   + nf * n_step * P * P * 4 + N * 4 * nf * 4 + N * 2 * 4)
        n_ops = int(steps.sum()) * ops_per_step + cells.size * nf * P * P * 2
        b, by = bound_ms(n_bytes, n_ops)
        full_ms = nf * N * K * K * P * P * 2 / F32_OPS_PER_S * 1e3
        spatch = extract_windows_reference(img_b, org, S)
        weight = torch.stack(filters, 1).reshape(nf * N, 1, P, P)

        def chain():
            surfaces = kc._corr_surfaces(extract_windows(img_b, org, S), *filters[:2], P, extra=filters[2:])
            return loop(sc, *surfaces, iters, eps, hi)

        with matmul_precision_scope(fcfg.matmul_precision):
            ms = cuda_ms(lambda: fn(*args), reps=200)
            before_ms = cuda_ms(chain, reps=200)
            lib = cuda_ms(lambda: F.conv2d(spatch[None], weight, groups=N), reps=200)
            plain = cuda_ms(lambda: ref(*args), reps=10)
            dev_ms = device_ms(lambda: fn(*args), f"{name}_kernel")
            # The same launch with no LK step: window copies and surfaces only.
            dev0_ms = device_ms(lambda: fn(*args[:-3], 0, eps, hi), f"{name}_kernel")
            before_dev = device_ms_per_call(chain)
        row.update(lane_steps=int(steps.sum()), max_steps=int(steps.max()), stepping_lanes=n_step,
                   touched_cells=int(cells.size), bound_bytes=n_bytes, bound_ops=n_ops, ms=ms, device_ms=dev_ms,
                   device_ms_no_steps=dev0_ms, plain_ms=plain, library_ms=lib, before_ms=before_ms,
                   before_device_ms=before_dev, bound_ms=b, bound_by=by, full_surface_ms=full_ms)
        print(msg)
        loop_name = "K1" if nf == 2 else "K3"
        print(f"[{tag}]   {int(steps.sum())} lane steps (max {int(steps.max())}) over {n_step} stepping lanes, "
              f"{int(cells.size)} cells touched; per call {ms:.4f} ms (device {_fmt(dev_ms)}, "
              f"{_fmt(dev0_ms)} with no step); before (K2 + conv2d + {loop_name}) {before_ms:.4f} ms (device "
              f"{_fmt(before_dev)}); conv2d alone {lib:.4f} ms; plain {plain:.4f} ms; bound {b:.7f} ms "
              f"({by}: {n_bytes} B, {n_ops} flops); whole surfaces {full_ms:.6f} ms")
        if N == 144:
            row["passes"] = align_passes(name, tag, fn, ref, args, surf, nf, tq, f0, sc, pts_of, ok_mask)
    return rows


def align_passes(name, tag, fn, ref, args, surf_f32, nf, tq, f0, sc, pts_of, ok_mask):
    """The bf16 passes (1 and 3) of one ``align_rows`` problem: the kernel
    against its plain version (the surfaces by the bf16 GEMMs of
    ``ops/precision.py``, the float32 loop) with the float32 rows' bars,
    each on the part it holds: every surface within 1e-5 x its max|C| of
    the plain version's; the points within K1_TOL of the plain loop run on
    the kernel's own surfaces; frozen lanes unmoved; the surfaces moved
    from the float32 ones.  The float32 rows hold K1_TOL end to end because
    their surfaces are bit-equal to the plain ``conv2d``'s; the bf16 GEMMs
    sum in another order, and a lane near a degenerate step takes another
    path on surfaces a rounding apart, so the points' distance to the
    plain version end to end is recorded, not held.  Device time a launch
    with and without LK steps (the surface phase's cost), per call and
    plain times."""
    import torch

    from msckf_stereo_c_torch.ops import klt_corr as kc

    loop = kc.lk_corr_iterate_reference if nf == 2 else kc.lk_corr_iterate_gain_reference
    iters, eps, hi = args[-3:]
    # How far the plain loop moves on the float32 surfaces nudged by 1e-6 x
    # max|C| (normal noise, seed 0): the spread a rounding apart allows.
    g = torch.Generator(device=surf_f32.device).manual_seed(0)
    base = loop(sc, *(surf_f32[:, i] for i in range(nf)), iters, eps, hi)
    nudged = loop(sc, *(surf_f32[:, i] + 1e-6 * surf_f32[:, i].abs().max()
                        * torch.randn(surf_f32[:, i].shape, generator=g, device=surf_f32.device)
                        for i in range(nf)), iters, eps, hi)
    m_base = ok_mask(pts_of(base))
    nudge = float((nudged - base)[m_base].abs().max()) if bool(m_base.any()) else 0.0
    print(f"[{tag}] the plain loop on the float32 surfaces nudged by 1e-6 x max|C|: points move up to {nudge:.3g} px")
    out = {"f32_nudge_px": nudge}
    for p in (1, 3):
        surf = torch.empty_like(surf_f32)
        surf_ref = torch.empty_like(surf_f32)
        got = fn(*args, surfaces_out=surf, passes=p)
        want = ref(*args, surfaces_out=surf_ref, passes=p)
        torch.cuda.synchronize()
        cmax = [float(surf_ref[:, i].abs().max()) for i in range(nf)]
        serr = [float((surf[:, i] - surf_ref[:, i]).abs().max()) for i in range(nf)]
        for i in range(nf):
            check(serr[i] <= 1e-5 * cmax[i], f"{name} passes={p}: surface {i} differs by {serr[i]} (> 1e-5 x {cmax[i]})")
        check(not torch.equal(surf, surf_f32), f"{name} passes={p}: the surfaces are the float32 ones")
        on_surf = loop(sc, *(surf[:, i] for i in range(nf)), iters, eps, hi)
        m_loop = ok_mask(pts_of(on_surf))
        check(bool(torch.isfinite(got).all()), f"{name} passes={p}: non-finite output")
        check(torch.equal(got[~tq.good], f0[~tq.good]), f"{name} passes={p}: a frozen lane moved")
        err = float((got - on_surf)[m_loop].abs().max()) if bool(m_loop.any()) else 0.0
        check(err <= K1_TOL, f"{name} passes={p}: differs by {err} px (> {K1_TOL}) from the plain loop on its "
                             f"surfaces")
        m_want = ok_mask(pts_of(want))
        d = (got - want)[m_want].abs().amax(-1)
        e2e = float(d.max()) if bool(m_want.any()) else 0.0
        apart = int((d > K1_TOL).sum())
        dev = device_ms(lambda: fn(*args, passes=p), f"{name}_kernel")
        dev0 = device_ms(lambda: fn(*args[:-3], 0, args[-2], args[-1], passes=p), f"{name}_kernel")
        ms = cuda_ms(lambda: fn(*args, passes=p), reps=200)
        plain = cuda_ms(lambda: ref(*args, passes=p), reps=10)
        out[p] = dict(max_abs_err=err, end_to_end_err=e2e, lanes_apart=apart, surface_err=serr, surface_max=cmax,
                      device_ms=dev, device_ms_no_steps=dev0, ms=ms, plain_ms=plain)
        print(f"[{tag}] passes={p} N={sc.shape[0]}: max |df| {err:.2e} px from the plain loop on the kernel's "
              f"surfaces (tol {K1_TOL}), {e2e:.3g} px end to end ({apart} of {int(m_want.sum())} lanes over "
              f"{K1_TOL}), surfaces within "
              + ", ".join(f"{e:.3g} of max |C| {m:.4g}" for e, m in zip(serr, cmax))
              + f"; device {_fmt(dev)} ({_fmt(dev0)} with no step), per call {ms:.4f} ms, plain {plain:.4f} ms")
    return out


def resample_rows(img_a, img_b, corners, fcfg):
    """``resample_template`` against its plain version at the forward
    results of the bench features (level 0: 138 corners tracked as the
    fused call's forward problem tracks them, plus six lanes whose offsets
    clamp at both ends of [0, Sb - (P+3)], sit on its ends or on integers,
    or lie just below an integer).  Within 2e-6 x max|sp_b| (the
    plain einsum's GEMM association is not specified) and the templates'
    quality gate equal; per-call, device, plain, library (``grid_sample`` at
    the same positions) and bound times beside the chain it replaces (K2's
    (Sb, Sb) block, the tent weights and the ``einsum``)."""
    import torch
    import torch.nn.functional as F

    from msckf_stereo_c_torch.config import matmul_precision_scope
    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.ops.patch_extract import extract_windows

    P, iters, eps = fcfg.patch_size, fcfg.max_iteration, fcfg.track_precision
    H, W = img_a.shape
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    Sb, q, Tq = S + 2, P + 2, P + 3
    c_off, half, top = (P - 1) / 2.0, (P + 1) / 2.0, float(Sb - Tq)
    pts0 = corners[:138].contiguous()
    with matmul_precision_scope(fcfg.matmul_precision):
        tq = kc._template_quantities(kc.extract_template(img_a, pts0, P), P, "none")
    o1 = kc._clip_xy(torch.floor(pts0) - S // 2 - 1, 0.0, W - Sb, H - Sb)
    so = o1 + 1.0
    f = kc._align(img_b, so, S, tq, pts0 - c_off - so, iters, eps, P, "none")
    edge = torch.tensor([[-2.5, -0.3], [top + 1.7, top + 0.2], [0.0, top], [3.0, 5.0], [4.75, 0.5],
                         [top - 0.25, 1.0 - 2.0**-14]], device=img_a.device)
    pts = torch.cat([f + c_off + so, o1[:6] + half + edge]).contiguous()
    o1 = torch.cat([o1, o1[:6]])
    org = o1.to(torch.int32)
    N = pts.shape[0]
    got = kc.resample_template(img_b, pts, org, Sb, P)
    with matmul_precision_scope(fcfg.matmul_precision):
        want = kc.resample_template_reference(img_b, pts, org, Sb, P)
        good_got = kc._template_quantities(got, P, "none").good
        good_want = kc._template_quantities(want, P, "none").good
    torch.cuda.synchronize()
    vmax = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "resample_template gave non-finite output")
    check(err <= 2e-6 * vmax, f"resample_template differs by {err} (> 2e-6 x {vmax})")
    check(torch.equal(good_got, good_want), "resample_template templates pass another quality gate")
    # The einsum's output layout: reductions over the templates downstream
    # then sum in the same order.
    check(got.stride() == want.stride(), f"resample_template layout {got.stride()}, plain {want.stride()}")

    ob = torch.clamp(pts - half - o1, 0.0, top)

    def before():
        obb = torch.clamp(pts - half - o1, 0.0, top)
        return kc._sample(kc._tent_weights(obb[:, 1], q, Sb), extract_windows(img_b, org, Sb),
                          kc._tent_weights(obb[:, 0], q, Sb))

    c = torch.arange(q, device=img_b.device, dtype=torch.float32)
    x = (o1[:, 0, None, None] + ob[:, 0, None, None] + c[None, None, :]).expand(N, q, q)
    y = (o1[:, 1, None, None] + ob[:, 1, None, None] + c[None, :, None]).expand(N, q, q)
    grid = torch.stack([2.0 * x / (W - 1) - 1.0, 2.0 * y / (H - 1) - 1.0], -1).reshape(1, N * q, q, 2)
    with matmul_precision_scope(fcfg.matmul_precision):
        ms = cuda_ms(lambda: kc.resample_template(img_b, pts, org, Sb, P), reps=200)
        plain = cuda_ms(lambda: kc.resample_template_reference(img_b, pts, org, Sb, P), reps=50)
        lib = cuda_ms(lambda: F.grid_sample(img_b[None, None], grid, mode="bilinear", align_corners=True), reps=200)
        before_ms = cuda_ms(before, reps=200)
        dev_ms = device_ms(lambda: kc.resample_template(img_b, pts, org, Sb, P), "resample_template_kernel")
        before_dev = device_ms_per_call(before)
    wins = (o1 + torch.floor(ob)).long().cpu().numpy()
    n_bytes = window_sectors(wins, Tq, H, W) * SECTOR_BYTES + N * q * q * 4 + N * 4 * 4
    b, by = bound_ms(n_bytes, 0)
    print(f"[resample] level 0 {W}x{H} N={N}: within {err:.3g} of max {vmax:.4g} (tol 2e-6 x max), quality gate "
          f"equal ({int(good_want.sum())} good); per call {ms:.4f} ms (device {_fmt(dev_ms)}), before (K2 block + "
          f"tent weights + einsum) {before_ms:.4f} ms (device {_fmt(before_dev)}), plain {plain:.4f} ms, "
          f"grid_sample {lib:.4f} ms, bound {b:.6f} ms ({by}, {n_bytes} B)")
    # The bf16 passes: weights and pixels rounded as the passes see them,
    # the float32 rows' bars.
    passes = {}
    for p in (1, 3):
        got_p = kc.resample_template(img_b, pts, org, Sb, P, passes=p)
        want_p = kc.resample_template_reference(img_b, pts, org, Sb, P, passes=p)
        torch.cuda.synchronize()
        vmax_p = float(want_p.abs().max())
        err_p = float((got_p - want_p).abs().max())
        check(bool(torch.isfinite(got_p).all()), f"resample_template passes={p}: non-finite output")
        check(err_p <= 2e-6 * vmax_p, f"resample_template passes={p}: differs by {err_p} (> 2e-6 x {vmax_p})")
        check(not torch.equal(got_p, got), f"resample_template passes={p}: the float32 templates")
        dev_p = device_ms(lambda: kc.resample_template(img_b, pts, org, Sb, P, passes=p), "resample_template_kernel")
        ms_p = cuda_ms(lambda: kc.resample_template(img_b, pts, org, Sb, P, passes=p), reps=200)
        plain_p = cuda_ms(lambda: kc.resample_template_reference(img_b, pts, org, Sb, P, passes=p), reps=50)
        passes[p] = dict(max_abs_err=err_p, max_abs=vmax_p, device_ms=dev_p, ms=ms_p, plain_ms=plain_p,
                         max_abs_from_f32=float((got_p - got).abs().max()))
        print(f"[resample] passes={p}: within {err_p:.3g} of max {vmax_p:.4g} (tol 2e-6 x max), "
              f"{passes[p]['max_abs_from_f32']:.3g} from the float32 templates; device {_fmt(dev_p)}, "
              f"per call {ms_p:.4f} ms, plain {plain_p:.4f} ms")
    return [dict(name="resample_template", level=0, H=H, W=W, N=N, Sb=Sb, max_abs_err=err, max_abs=vmax, ms=ms,
                 device_ms=dev_ms, plain_ms=plain, library_ms=lib, before_ms=before_ms,
                 before_device_ms=before_dev, bound_bytes=n_bytes, bound_ms=b, bound_by=by, passes=passes)]


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
    want = launches_per_frame(fcfg)
    check(launches_match(counts, want, T),
          f"main path launches {counts}, expected per frame {want}")
    return out, dict(main_res=res)


def phase_k3(fcfg):
    """``lk_corr_align_gain`` and the loop-only K3 within K1_TOL of their
    plain versions on inputs cut from two frames of the stress scene
    rendered on the card (exposure drift, vignette, blur and noise on):
    FAST corners of one frame tracked into the next, once with 'gain' and
    once with 'offset' filters."""
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
    pyr_a, pyr_b = pyramids_for(img[0], fcfg), pyramids_for(img[1], fcfg)
    corners = _best_corners(pyr_a[0], fcfg, 144)
    rows = []
    for norm in ("gain", "offset"):
        rows += align_rows(pyr_a, pyr_b, corners, fcfg, norm)
        rows += lk_rows("K3", pyr_a[0], pyr_b[0], fcfg, norm)
    return rows


def lk_rows(tag, img_a, img_b, fcfg, norm):
    """K1 (norm 'none') or K3 ('gain', 'offset') within K1_TOL of its plain
    version at N = 48 / 96 / 144 FAST corners of ``img_a`` tracked into
    ``img_b``, the surfaces built as the main path builds them; per-call,
    device, plain and bound times."""
    import torch

    from msckf_stereo_c_torch.config import matmul_precision_scope
    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.ops.patch_extract import extract_windows

    P, iters, eps = fcfg.patch_size, fcfg.max_iteration, fcfg.track_precision
    H, W = img_a.shape
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    hi = float(S - P - 1)
    c_off = (P - 1) / 2.0
    r = P // 2 + 1
    corners = _best_corners(img_a, fcfg, 144)
    rows = []
    for N in (48, 96, 144):
        pts = corners[:N]
        with matmul_precision_scope(fcfg.matmul_precision):
            tq = kc._template_quantities(kc.extract_template(img_a, pts, P), P, norm)
            sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
            Cx, Cy, Ct = kc._surfaces_for_norm(extract_windows(img_b, sorg.to(torch.int32), S), tq, P, norm)
        f0 = pts - c_off - sorg
        if Ct is None:
            name, fn, ref, ops_per_step = "lk_corr_iterate", kc.lk_corr_iterate, kc.lk_corr_iterate_reference, K1_OPS_PER_STEP
            surfaces = (Cx, Cy)
            sc = kc._k1_sc(tq, f0, ~tq.good)
        else:
            name, fn, ref, ops_per_step = ("lk_corr_iterate_gain", kc.lk_corr_iterate_gain,
                                           kc.lk_corr_iterate_gain_reference, K3_OPS_PER_STEP)
            surfaces = (Cx, Cy, Ct)
            sc = kc._k3_sc(tq, f0, ~tq.good)
        args = (sc, *surfaces, iters, eps, hi)
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
        _, steps, sectors, _ = lk_trace(args[0].cpu().numpy(), tuple(c.cpu().numpy() for c in surfaces),
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
    exact launch split per frame of each mode (``launches_per_frame``), and
    finite poses."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB, FrontendConfig
    from msckf_stereo_c_torch.models.vio import run_vio_sequence
    from msckf_stereo_c_torch.ops import _cuda

    T = SWEEP_FRAMES
    frame_t = traj.t[frame_idx[:T]]
    out = {}
    for mode in ("zeromean", "offset", "gain", "mixed", "anchor_gain"):
        fcfg = FrontendConfig(temporal_levels=1, klt_norm=mode)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_vio_sequence(fcfg, mcfg, EUROC_CALIB, frame_t, img0[:T], img1[:T], imu.t, imu.gyro, imu.acc,
                               image_dtype=torch.float32, filter_dtype=torch.float32, method="schur",
                               device="cuda")
        secs = time.perf_counter() - t0
        c = dict(_cuda.launch_counts)
        per = {k: v / T for k, v in c.items()}
        out[mode] = dict(launches=c, seconds=secs, tracks_per_frame_mean=float(np.mean(res.tracking["after_ransac"])))
        print(f"[modes] {mode:11s}: lk_corr_align {per['lk_corr_align']:.0f}, lk_corr_align_gain "
              f"{per['lk_corr_align_gain']:.0f}, extract_template {per['extract_template']:.0f}, resample_template "
              f"{per['resample_template']:.0f}, K2 {per['extract_windows']:.0f}, K1 {per['lk_corr_iterate']:.0f}, "
              f"K3 {per['lk_corr_iterate_gain']:.0f} launches/frame over {T} frames ({secs:.2f} s incl. "
              f"first-call set-up), {out[mode]['tracks_per_frame_mean']:.1f} tracks/frame")
        check(bool(np.isfinite(res.positions).all()), f"non-finite poses under klt_norm={mode!r}")
        want = launches_per_frame(fcfg)
        check(launches_match(c, want, T),
              f"klt_norm={mode!r}: launches {c}, expected per frame {want}")
    return out


def phase_stress(card):
    """The stress path: ``run_stress_gate`` over the 36 s stress scene with
    klt_norm='gain', rendered on the card in chunks (752x480 stereo, 900
    room landmarks, every stress channel on), with the launch counts zeroed
    just before and read just after."""
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
    want = launches_per_frame(kw["fcfg"])
    check(launches_match(counts, want, T),
          f"stress path launches {counts}, expected per frame {want}")
    check(gate.ate_rmse < 0.13, f"stress ATE {gate.ate_rmse} m is above the 0.13 m bar")
    check(gate.min_tracks_after_ransac > 3, f"stress min tracks {gate.min_tracks_after_ransac} (bar > 3)")
    check(tracks.mean() > 30, f"stress mean tracks {tracks.mean()} (bar > 30)")
    return out, dict(stress_run=gate)


def phase_methods(scene, fcfg, mcfg, card):
    """Each filter method of METHOD_RUNS over the last METHOD_FRAMES bench
    frames (B=1), from the state the frames before them leave (the main
    configuration's): the filter in float32 under 'qr', 'cholesky' and
    'schur' with exact solves and 'schur' with 10 Newton-Schulz iterations,
    then 'qr' and 'cholesky' in float64 (the state cast).  Each run's ATE
    under 0.13 m, frames/s, host syncs per frame by call site (one more run
    in torch's sync debug mode) and launches, exactly 7 / 4 / 1 / 1 a frame;
    the float64 methods within 1e-4 m of each other; and
    ``run_vio_sequence(internals_at=INTERNALS_AT)`` under 'qr': every key
    of the dump, poses equal to the same run without it."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB, FilterConfig
    from msckf_stereo_c_torch.models.vio import run_vio_sequence
    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.scripts.stage_split import head_state
    from msckf_stereo_c_torch.utils.lanes import map_tree

    imu, img0, img1, frame_t = scene.imu, scene.img0, scene.img1, scene.frame_t
    k0 = frame_t.shape[0] - METHOD_FRAMES
    T = METHOD_FRAMES
    gt = scene.traj.p[scene.frame_idx[k0:]]
    head = head_state(scene, k0, fcfg, mcfg, "schur", "cuda")
    want = launches_per_frame(fcfg)

    def cast(state, dtype):
        filt = map_tree(lambda x: x.to(dtype) if x.is_floating_point() else x, state.filt)
        return state._replace(filt=filt, prev_time=state.prev_time.to(dtype))

    def runner(method, ns, dname):
        dtype = getattr(torch, dname)
        cfg = FilterConfig(ns_iters=ns, matmul_precision="tensorfloat32")

        def run(n=T, **kw):
            return run_vio_sequence(
                fcfg, cfg, EUROC_CALIB, frame_t[k0:k0 + n], img0[k0:k0 + n], img1[k0:k0 + n], imu.t, imu.gyro,
                imu.acc, image_dtype=torch.float32, filter_dtype=dtype, method=method, state=cast(head, dtype),
                prev_frame_t=float(frame_t[k0 - 1]), device="cuda", **kw)

        return run

    runs, positions = {}, {}
    for label, method, ns, dname in METHOD_RUNS:
        run = runner(method, ns, dname)
        run(2)  # warm-up: library handles and plans of this method's solves
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_cuda.launch_counts)
        sites = package_sites(count_syncs(run))
        pos = res.positions
        check(bool(np.isfinite(pos).all()), f"methods: non-finite poses under {label}")
        ate = _ate(frame_t[k0:], pos, gt)
        runs[label] = dict(method=method, ns_iters=ns, dtype=dname, frames=T, seconds=secs, fps=T / secs,
                           ate_rmse_m=ate, syncs_per_frame=sum(sites.values()) / T,
                           sync_sites={k: v / T for k, v in sorted(sites.items(), key=lambda kv: -kv[1])},
                           launches=counts)
        positions[label] = pos
        print(f"[methods] {label:13s} ({dname}): ATE {ate:.6f} m, {T / secs:.2f} frames/s over {T} frames (B=1), "
              f"{runs[label]['syncs_per_frame']:.2f} host syncs/frame, launches/frame "
              f"{ {k: v / T for k, v in counts.items() if v} } on {card}")
        for site, per_frame in list(runs[label]["sync_sites"].items())[:4]:
            print(f"[methods]   {per_frame:.2f}/frame at {site}")
        check(ate < 0.13, f"methods: ATE {ate} m under {label} is above the 0.13 m bar")
        # One compression a lost-track update, and one a camera prune.
        n_qr = counts["qr_compress"]
        check(T <= n_qr <= 2 * T if method == "qr" else n_qr == 0,
              f"methods: {n_qr} qr_compress launches over {T} frames under {label}")
        check(launches_match({k: v for k, v in counts.items() if k != "qr_compress"},
                             {k: v for k, v in want.items() if k != "qr_compress"}, T),
              f"methods: launches {counts} under {label}, expected per frame {want}")
    f64 = [label for label, _, _, dname in METHOD_RUNS if dname == "float64"]
    pairs = {}
    for i, a in enumerate(f64):
        for b in f64[i + 1:]:
            d = float(np.linalg.norm(positions[a] - positions[b], axis=1).max())
            pairs[f"{a} / {b}"] = d
            print(f"[methods] {a} against {b}: positions within {d:.3e} m (bar 1e-4 m)")
            check(d <= 1e-4, f"methods: {a} and {b} differ by {d} m (> 1e-4 m)")

    label, method, ns, dname = METHOD_RUNS[0]
    res = runner(method, ns, dname)(internals_at=INTERNALS_AT)
    d = res.internals or {}
    missing = sorted(set(INTERNAL_KEYS) - set(d))
    moved = float(np.abs(res.positions - positions[label]).max())
    n_used = int(np.sum(d.get("candidate_use", 0)))
    print(f"[methods] internals_at={INTERNALS_AT} under {label}: {len(d)} keys ({n_used} used candidates, "
          f"{int(np.sum(d.get('gate_pass_qr', 0)))} pass the gate), poses {moved:.3e} m from the run without it")
    check(not missing, f"methods: the internals lack {missing}")
    check(moved == 0.0, f"methods: internals_at moved the poses by {moved} m")
    return dict(runs=runs, f64_pairs_m=pairs, internals=dict(keys=sorted(d), used_candidates=n_used,
                                                             pose_change_m=moved))


def phase_stress_lanes(card):
    """Robustness seeds STRESS_LANE_SEEDS as the lanes of one batched
    ``run_stress_lanes`` over STRESS_LANE_SECONDS of the stress scene with
    klt_norm='none' (each lane its own landmarks, IMU noise, photometric
    draws and images, rendered on the card), with the launch counts zeroed
    just before and read just after (7 / 4 / 1 / 1 per batched frame); then
    each seed's one-lane ``run_stress_gate``: feature ids and validity equal
    on the first 10 frames.  Once with the filter in float64, where the
    lanes' ATEs must be within 2e-4 m of the one-lane runs', and once in
    float32, the stress script's dtype, where the filter's batched products
    round by batch shape (ROADMAP.md, Queue 3) and the ATE gap is
    recorded."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import FilterConfig, FrontendConfig
    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.sim import stress

    seeds = list(STRESS_LANE_SEEDS)
    want = launches_per_frame(FrontendConfig(klt_norm="none"))
    out = {}
    for dname in ("float64", "float32"):
        kw = dict(fcfg=FrontendConfig(klt_norm="none"),
                  mcfg=FilterConfig(ns_iters=10, matmul_precision="tensorfloat32"), method="schur",
                  duration=STRESS_LANE_SECONDS if dname == "float64" else STRESS_LANE_F32_SECONDS,
                  filter_dtype=getattr(torch, dname))
        if not out:
            stress.run_stress_lanes(seeds, **dict(kw, duration=1.0))  # warm-up at these shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        lanes = stress.run_stress_lanes(seeds, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_cuda.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        T = lanes[0].n_frames
        check(launches_match(counts, want, T),
              f"stress lanes ({dname}): launches {counts}, expected per batched frame {want}")
        per_lane = []
        t1 = time.perf_counter()
        for seed, got in zip(seeds, lanes):
            alone = stress.run_stress_gate(seed=seed, lm_seed=stress.protocol_lm_seed(seed), **kw)
            same = (got.result.fid == alone.result.fid).all(-1) & (got.result.valid == alone.result.valid).all(-1)
            parts = int(np.argmin(same)) if not same.all() else None
            gap = abs(got.ate_rmse - alone.ate_rmse)
            per_lane.append(dict(seed=seed, ate_batched_m=got.ate_rmse, ate_alone_m=alone.ate_rmse, ate_gap_m=gap,
                                 ate_max_m=got.ate_max, min_tracks=got.min_tracks_after_ransac,
                                 first_frame_ids_part=parts))
            print(f"[stress-lanes] {dname} seed {seed}: ATE {got.ate_rmse:.6f} m batched, {alone.ate_rmse:.6f} m "
                  f"alone ({gap:.2e} m apart); ids and validity "
                  f"{'equal on every frame' if parts is None else f'part at frame {parts}'}; "
                  f"min tracks {got.min_tracks_after_ransac}")
            check(bool(np.isfinite(got.result.positions).all()), f"stress lanes: non-finite poses, seed {seed}")
            check(parts is None or parts >= 10,
                  f"stress lanes ({dname}): seed {seed} ids differ from its one-lane run at frame {parts}")
            if dname == "float64":
                check(gap <= 2e-4, f"stress lanes: seed {seed} ATE {got.ate_rmse} m batched vs {alone.ate_rmse} m "
                                   f"alone (> 2e-4 m apart)")
        alone_s = time.perf_counter() - t1
        print(f"[stress-lanes] {dname}: {len(seeds)} lanes x {T} frames in {secs:.3f} s "
              f"({len(seeds) * T / secs:.2f} frames/s aggregate, rendering included) against {alone_s:.3f} s for "
              f"the one-lane runs; peak {peak:.3f} GB; launches per batched frame "
              f"{ {k: v // T for k, v in counts.items()} } on {card}")
        out[dname] = dict(seeds=seeds, frames=T, seconds=secs, fps=len(seeds) * T / secs,
                          seconds_one_lane_runs=alone_s, peak_memory_gb=peak, launches=counts, per_lane=per_lane)
    return out


def phase_stack_kernels(img0, fcfg):
    """The four kernels of the main path on a (STACK_LANES, H, W) stack of
    level-0 images of distinct moving frames, every feature naming its
    image with the int32 index a batched frame gives (``lane_index``): 36
    FAST corners per image (N = 144).  Each against its plain version with
    the tolerances of the single-image checks (``extract_template``
    bit-exact, ``resample_template`` within 2e-6 x max, both LK kernels
    within K1_TOL with equal valid masks), and against one launch per image
    (bit-equal)."""
    import torch

    from msckf_stereo_c_torch.config import matmul_precision_scope
    from msckf_stereo_c_torch.models.frontend import pyramids_for
    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.utils.lanes import lane_index

    dev = torch.device("cuda")
    B, n = STACK_LANES, 36
    P, iters, eps = fcfg.patch_size, fcfg.max_iteration, fcfg.track_precision
    frames = [FRAMES - 2 - 4 * b for b in range(B)]
    stack_a = torch.stack([pyramids_for(torch.as_tensor(img0[f], device=dev), fcfg)[0] for f in frames])
    stack_b = torch.stack([pyramids_for(torch.as_tensor(img0[f + 1], device=dev), fcfg)[0] for f in frames])
    H, W = stack_a.shape[1:]
    pts = torch.cat([_best_corners(stack_a[b], fcfg, n) for b in range(B)]).contiguous()
    idx = lane_index(B, n, dev)
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    Sb, hi, c_off = S + 2, float(S - P - 1), (P - 1) / 2.0
    r = P // 2 + 1
    rows = []

    def per_lane(fn, imgs, *per_feature):
        """One launch per image on its own features, concatenated."""
        return torch.cat([fn(imgs[b], *(x[b * n:(b + 1) * n] for x in per_feature)) for b in range(B)])

    def record(name, err, tol):
        torch.cuda.synchronize()
        rows.append(dict(name=name, B=B, N=B * n, max_abs_err=err, tol=tol, per_lane_equal=True))
        print(f"[stack] {name} on a {B}x{H}x{W} stack, N={B * n} with an image index: within {err:.3g} of its "
              f"plain version (tol {tol}), equal to {B} per-image launches")

    sp = kc.extract_template(stack_a, pts, P, idx)
    want = kc.extract_template_reference(stack_a, pts, P, idx)
    check(torch.equal(sp, want), "extract_template on the stack differs from its plain version")
    check(torch.equal(sp, per_lane(lambda im, p: kc.extract_template(im, p, P), stack_a, pts)),
          "extract_template on the stack differs from per-image launches")
    record("extract_template", 0.0, 0.0)

    with matmul_precision_scope(fcfg.matmul_precision):
        sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
        org = sorg.to(torch.int32)
        f0 = pts - c_off - sorg
        for norm, name, fn, ref, make_sc in (
            ("none", "lk_corr_align", kc.lk_corr_align, kc.lk_corr_align_reference, kc._k1_sc),
            ("gain", "lk_corr_align_gain", kc.lk_corr_align_gain, kc.lk_corr_align_gain_reference, kc._k3_sc),
        ):
            tq = kc._template_quantities(sp, P, norm)
            filters = kc._filters_for_norm(tq, P, norm)
            sc = make_sc(tq, f0, ~tq.good)
            got = fn(stack_b, org, S, *filters, sc, iters, eps, hi, idx)
            want = ref(stack_b, org, S, *filters, sc, iters, eps, hi, idx)
            lanes = per_lane(lambda im, o, *rest: fn(im, o, S, *rest, iters, eps, hi), stack_b, org, *filters, sc)
            check(torch.equal(got, lanes), f"{name} on the stack differs from per-image launches")
            pw, pg = want + c_off + sorg, got + c_off + sorg

            def ok_mask(p):
                return tq.good & (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

            border = torch.stack([pw[:, 0] - r, (W - r) - pw[:, 0], pw[:, 1] - r, (H - r) - pw[:, 1]], -1)
            near = border.abs().min(-1).values < K1_TOL
            check(torch.equal(ok_mask(pg)[~near], ok_mask(pw)[~near]), f"{name} valid mask differs on the stack")
            m = ok_mask(pw)
            err = float((got - want)[m].abs().max()) if bool(m.any()) else 0.0
            check(err <= K1_TOL, f"{name} on the stack differs by {err} px (> {K1_TOL})")
            record(name, err, K1_TOL)
            if norm == "none":
                pts1 = pg

        o1 = kc._clip_xy(torch.floor(pts1) - S // 2 - 1, 0.0, W - Sb, H - Sb).to(torch.int32)
        got = kc.resample_template(stack_b, pts1, o1, Sb, P, idx)
        want = kc.resample_template_reference(stack_b, pts1, o1, Sb, P, idx)
    check(torch.equal(got, per_lane(lambda im, p, o: kc.resample_template(im, p, o, Sb, P), stack_b, pts1, o1)),
          "resample_template on the stack differs from per-image launches")
    vmax = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= 2e-6 * vmax, f"resample_template on the stack differs by {err} (> 2e-6 x {vmax})")
    record("resample_template", err, 2e-6 * vmax)
    return rows


def _ate(t, est, gt):
    from msckf_stereo_c_torch.io.tum import evaluate_ate

    return float(evaluate_ate(t, est, t, gt).rmse)


def phase_distinct_lanes(scene, fcfg, mcfg, card):
    """STACK_LANES distinct sequences of the bench scene stepped together:
    lane b starts 60 b IMU samples (0.3 b s) after the spin-up begins, its
    frames rendered on the card (nominal, no stress channel).  One batched
    run over DISTINCT_FRAMES frames with the launch counts zeroed just
    before and read just after (7 / 4 / 1 / 1 per batched frame), then each
    lane alone: feature ids and validity equal on the first 10 frames, each
    lane's ATE within 2e-4 m of its one-lane run (the first frame where a
    lane's ids part from its one-lane run is recorded)."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB
    from msckf_stereo_c_torch.models.frontend import make_frontend_params
    from msckf_stereo_c_torch.models.msckf import make_params
    from msckf_stereo_c_torch.models.runner import pack_imu_batches
    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.parallel.vio_multiseq import (
        batched_gravity_init, batched_init_vio_state, run_vio_batch)
    from msckf_stereo_c_torch.sim.render_torch import TorchRenderer
    from msckf_stereo_c_torch.utils.lanes import map_tree

    dev = torch.device("cuda")
    f32 = torch.float32
    B, T = STACK_LANES, DISTINCT_FRAMES
    traj, imu = scene.traj, scene.imu
    idx = [300 + 60 * b + 10 * np.arange(T) for b in range(B)]
    renderer = TorchRenderer(scene.landmarks, r_wall=8.0, device=dev)
    rendered = [renderer.render_sequence(traj, i) for i in idx]
    imgs0 = torch.stack([x[0] for x in rendered])
    imgs1 = torch.stack([x[1] for x in rendered])
    times = np.stack([traj.t[i] for i in idx])
    batches = pack_imu_batches(imu.t, imu.gyro, imu.acc, times, mcfg.max_imu_per_frame, np.float32, device=dev)
    fparams = make_frontend_params(EUROC_CALIB, f32, dev)
    mparams = make_params(mcfg, EUROC_CALIB, f32, dev)
    states = batched_init_vio_state(fcfg, mcfg, EUROC_CALIB, imgs0.shape[-2:], B, f32, f32, dev)
    states = batched_gravity_init(states, imu.gyro[:200], imu.acc[:200])

    def run(sl):
        return run_vio_batch(map_tree(lambda x: x[sl], states), imgs0[sl], imgs1[sl], times[sl],
                             map_tree(lambda x: x[sl], batches), fparams, mparams, fcfg, mcfg, "schur", device=dev)

    run(slice(0, B))  # warm-up: first-call set-up at these shapes
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    _, poses, fronts, _ = run(slice(0, B))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    want = launches_per_frame(fcfg)
    check(launches_match(counts, want, T),
          f"distinct lanes: launches {counts}, expected per batched frame {want}")
    est = poses.p.cpu().numpy()
    check(bool(np.isfinite(est).all()), "non-finite poses in the distinct-lane run")
    fid, valid = fronts.fid.cpu().numpy(), fronts.valid.cpu().numpy()
    lanes = []
    t1 = time.perf_counter()
    for b in range(B):
        _, p1, f1, _ = run(slice(b, b + 1))
        f1_fid, f1_valid = f1.fid[0].cpu().numpy(), f1.valid[0].cpu().numpy()
        same = (fid[b] == f1_fid).all(-1) & (valid[b] == f1_valid).all(-1)
        parts = int(np.argmin(same)) if not same.all() else None
        gt = traj.p[idx[b]]
        ate_b, ate_1 = _ate(times[b], est[b], gt), _ate(times[b], p1.p[0].cpu().numpy(), gt)
        tracks = fronts.after_ransac[b].cpu().numpy()
        lanes.append(dict(lane=b, first_sample=int(idx[b][0]), ate_batched_m=ate_b, ate_alone_m=ate_1,
                          first_frame_ids_part=parts, tracks_per_frame_mean=float(tracks.mean())))
        print(f"[lanes] lane {b} (from IMU sample {idx[b][0]}): ATE {ate_b:.6f} m batched, {ate_1:.6f} m alone; "
              f"ids and validity {'equal on every frame' if parts is None else f'part at frame {parts}'}; "
              f"{tracks.mean():.1f} tracks/frame")
        check(parts is None or parts >= 10, f"lane {b}: ids or validity differ from its one-lane run at frame {parts}")
        check(abs(ate_b - ate_1) <= 2e-4, f"lane {b}: batched ATE {ate_b} m vs {ate_1} m alone (> 2e-4 m apart)")
    alone = time.perf_counter() - t1
    out = dict(lanes=B, frames=T, seconds=secs, fps=B * T / secs, seconds_one_lane_runs=alone,
               launches=counts, per_lane=lanes)
    print(f"[lanes] {B} distinct lanes x {T} frames in {secs:.3f} s ({B * T / secs:.2f} frames/s aggregate) "
          f"against {alone:.3f} s for the {B} one-lane runs, on {card}; launches per batched frame "
          f"{ {k: v // T for k, v in counts.items()} }")
    return out


def phase_stage_split(scene, fcfg, mcfg, card):
    """The stage split (``scripts/stage_split.py``) at each B of
    SPLIT_BATCHES over the last N_TAIL bench frames, from the state the
    frames before them leave broadcast to B lanes that share the images and
    the IMU: every label's spans hold device events, every hand kernel's
    device event is placed in its stage, no sub-phase takes more device
    time than its parent, the front end's and the filter's totals plus the
    device time in no stage make the step's device total within 1 %, and
    the launches are exact.  A profile with no device event is taken once
    more, and fails the phase if it is empty again."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.scripts.stage_split import (
        FILTER_TOTAL, FRONTEND_TOTAL, head_state, parent_of, split_at, tail_run)

    k0, T = FRAMES - N_TAIL, N_TAIL
    state = head_state(scene, k0, fcfg, mcfg, "schur", "cuda")
    want = launches_per_frame(fcfg)
    out = {}
    for B in SPLIT_BATCHES:
        run = tail_run(scene, state, k0, B, fcfg, mcfg, "schur", torch.device("cuda"))
        def take():
            result, table = split_at(run, tag="stage split")
            return (result, table), table["device_ops"]

        ((_, poses, _, _), table), attempt = profiled_twice(take, f"[stage split] B={B}:")
        table["attempts"] = attempt
        rows = table["stages"]
        check(launches_match(table["launches"], want, T),
              f"[stage split] B={B}: launches {table['launches']}, expected per frame {want}")
        check(bool(np.isfinite(poses.p.cpu().numpy()).all()), f"[stage split] B={B}: non-finite poses")
        check(table["hand_rest_ms"] == 0,
              f"[stage split] B={B}: {table['hand_rest_ms']} ms of hand kernels in no stage "
              f"({table['hand_events']} of {table['hand_launches']} launches placed)")
        empty = [label for label, r in rows.items() if r["device_ops"] == 0]
        check(not empty, f"[stage split] B={B}: no device event in the spans of {empty}")
        for label, r in rows.items():
            parent = parent_of(label)
            if parent is not None:
                check(r["device_ms"] <= rows[parent]["device_ms"] * (1 + 1e-9),
                      f"[stage split] B={B}: {label} {r['device_ms']} ms > {parent} {rows[parent]['device_ms']} ms")
        parts = rows[FRONTEND_TOTAL]["device_ms"] + rows[FILTER_TOTAL]["device_ms"] + table["rest_ms"]
        check(abs(parts - table["device_ms"]) <= 0.01 * table["device_ms"],
              f"[stage split] B={B}: front end + filter + rest {parts} ms against the step's {table['device_ms']} ms")
        print(f"[stage split] B={B}: front end {rows[FRONTEND_TOTAL]['device_ms']:.3f} + filter "
              f"{rows[FILTER_TOTAL]['device_ms']:.3f} + rest {table['rest_ms']:.3f} = {parts:.3f} ms of device time "
              f"per batched frame, step {table['device_ms']:.3f} ms; on {card}")
        out[B] = table
    return out


def phase_precision(scene, fcfg, mcfg, card):
    """The bf16 precision names on the bench scene: each filter/front-end
    spec of PRECISION_SPECS over the first PRECISION_FRAMES frames (B=1)
    through ``run_vio_sequence``, launch counts zeroed just before and read
    just after (exact, ``launches_per_frame``), frames/s with every host
    sync counted, ATE (under 0.13 m for the specs marked so; the others,
    JAX's notes expect to diverge, are recorded as found, a non-finite ATE
    included), and the positions of every spec but the bench's apart from
    the bench's (the passes reached the run)."""
    import dataclasses

    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB
    from msckf_stereo_c_torch.io.tum import evaluate_ate
    from msckf_stereo_c_torch.models.vio import run_vio_sequence
    from msckf_stereo_c_torch.ops import _cuda

    def configs(spec):
        filt, front = spec.split("/")
        return dataclasses.replace(fcfg, matmul_precision=front), dataclasses.replace(mcfg, matmul_precision=filt)

    T = PRECISION_FRAMES
    frame_t, gt = scene.frame_t[:T], scene.traj.p[scene.frame_idx[:T]]
    rows, positions = {}, {}
    for spec, gated in PRECISION_SPECS:
        f, m = configs(spec)

        def run(n):
            return run_vio_sequence(f, m, EUROC_CALIB, frame_t[:n], scene.img0[:n], scene.img1[:n], scene.imu.t,
                                    scene.imu.gyro, scene.imu.acc, image_dtype=torch.float32,
                                    filter_dtype=torch.float32, method="schur", device="cuda")

        run(3)  # warm-up: the bf16 GEMMs' handles and plans
        torch.cuda.synchronize()
        timed = []

        def timed_run():
            t0 = time.perf_counter()
            res = run(T)  # ends in a device-to-host copy of the outputs
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0, res))

        _cuda.reset_launch_counts()
        sites = count_syncs(timed_run)
        counts = dict(_cuda.launch_counts)
        secs, res = timed[0]
        want = launches_per_frame(f)
        check(launches_match(counts, want, T),
              f"[precision] {spec}: launches {counts}, expected per frame {want}")
        finite = bool(np.isfinite(res.positions).all())
        ate = float(evaluate_ate(frame_t, res.positions, frame_t, gt).rmse) if finite else float("inf")
        tracks = res.tracking["after_ransac"]
        top = sorted(sites.items(), key=lambda kv: -kv[1])[:3]
        rows[spec] = dict(frames=T, seconds=secs, fps=T / secs, ate_rmse_m=ate, finite=finite,
                          syncs_per_frame=sum(sites.values()) / T, sync_sites={k: v / T for k, v in top},
                          tracks_min=int(np.min(tracks[1:])), tracks_mean=float(np.mean(tracks)), launches=counts,
                          gated=gated)
        print(f"[precision] filter/front end {spec}: ATE {ate:.6f} m{' (bar 0.13 m)' if gated else ' (recorded)'}, "
              f"{T / secs:.2f} frames/s (B=1, sync debug mode on), {sum(sites.values()) / T:.2f} host syncs a "
              f"frame (" + ", ".join(f"{v / T:.2f} at {k}" for k, v in top) + f"), tracks mean "
              f"{np.mean(tracks):.1f} min {np.min(tracks[1:])}, launches {counts}; on {card}")
        if gated:
            check(finite and ate < 0.13, f"[precision] {spec}: ATE {ate} m is not under the 0.13 m bar")
        positions[spec] = res.positions
    bench = PRECISION_SPECS[0][0]
    for spec, _ in PRECISION_SPECS[1:]:
        check(not np.array_equal(positions[spec], positions[bench]),
              f"[precision] {spec}: the positions are the bench spec's: the passes did not reach the run")
    return rows


EUROC_CHUNK = 32  # the app's --chunk in the euroc phase
EUROC_SPLIT = 30  # the checkpoint: frames before the save
EUROC_SHORT = 40  # frames of the batch app's second sequence


def launches_match(counts: dict, want: dict, T: int) -> bool:
    """Hand-kernel launches ``counts`` over T frames of the whole step
    against the tracker's ``want`` a frame (``launches_per_frame``): those
    exactly T x ``want``, and the filter's ``lm_triangulate`` T to 2T (one a
    lost-track update, every frame, and one a camera prune, in the frames
    where some lane's window is full)."""
    lm = "lm_triangulate"
    rest = {k: v for k, v in counts.items() if k != lm}
    return rest == {k: v * T for k, v in want.items() if k != lm} and T <= counts.get(lm, 0) <= 2 * T


def launches_per_frame(fcfg, img_shape=(480, 752)) -> dict:
    """Hand-kernel launches of one (batched) frame of the tracker under
    ``fcfg``, as ``models/frontend.py`` takes its paths:

    - each corr LK level is one ``extract_template`` and one alignment
      (``lk_corr_align`` for a two-surface norm, ``lk_corr_align_gain`` for
      a three-surface one) unless its image is too small for a window;
    - temporal: one alignment on carried templates (template carry: one
      temporal and one stereo level), else ``temporal_levels`` levels;
    - anchor: one alignment on the birth templates, standalone where the
      fused call is off (it needs template carry);
    - candidates: the levels from 3 down to 2 in one call, then level 1
      (``cand_level1``), each level between them and the shared fine
      levels;
    - fine level: the fused call (forward: a template and an alignment;
      backward: ``resample_template`` and an alignment), or one level with
      its template kept (template carry), or ``stereo_levels`` levels, then
      the unfused left-right pass (one level);
    - ``klt_impl`` 'gather' and 'gemm' launch no LK kernel (the gather LK
      is plain PyTorch);
    - FAST is one ``fast_grid_corners`` under every configuration.
    """
    counts = dict.fromkeys(KERNEL_SOURCES, 0)
    counts["fast_grid_corners"] = 1
    if fcfg.klt_impl != "corr":
        return counts
    P, L = fcfg.patch_size, fcfg.pyramid_levels
    norm, anchor_norm = {"mixed": ("offset", "gain"), "anchor_gain": ("none", "gain")}.get(
        fcfg.klt_norm, (fcfg.klt_norm, fcfg.klt_norm))

    def align(n, how=norm):
        counts["lk_corr_align" if how in ("none", "zeromean") else "lk_corr_align_gain"] += n

    def level_runs(lvl):
        h, w = img_shape
        for _ in range(lvl):
            h, w = (h + 1) // 2, (w + 1) // 2
        return min(h, w) >= P + 4 and min(P + 20, h, w) >= P + 2

    def lk(levels):
        n = sum(level_runs(lvl) for lvl in levels)
        align(n)
        counts["extract_template"] += n

    carry = fcfg.tmpl_carry and fcfg.temporal_levels == 1 and fcfg.stereo_levels == 1
    fused = (fcfg.stereo_levels == 1 and fcfg.stereo_lr_threshold > 0 and fcfg.stereo_lr_survivors
             and min(img_shape) >= P + 22)
    anchor = fcfg.anchor_refine and carry
    sl = max(1, min(fcfg.stereo_levels, L))
    if carry:
        align(level_runs(0))
    else:
        lk(range(min(fcfg.temporal_levels, L)))
    if anchor and not fused:
        align(level_runs(0), anchor_norm)
    if L > 2:
        lk(range(2, L))
    lk([lvl for lvl in range(min(2, L) - 1, sl - 1, -1) if lvl != 1 or fcfg.cand_level1])
    if fused:
        align(int(anchor), anchor_norm)
        align(2)
        counts["extract_template"] += 1
        counts["resample_template"] += 1
    else:
        lk(range(1 if carry else sl))
        if fcfg.stereo_lr_threshold > 0:
            lk([0])
    return counts


def phase_euroc(scene, card):
    """The EuRoC entry points at full size: the bench scene's FRAMES frames
    written as a EuRoC ``mav0/`` directory (PNGs from ``io/png.py``, their
    rows cycling through all five filters; IMU and ground-truth CSVs; the
    EuRoC epoch base), then
    - the decoder the apps use (native runtime or zlib, printed) gives the
      rendered frames rounded to uint8 exactly, and each available backend's
      decode time;
    - ``apps/run_euroc.py``'s ``main`` with the three in-repo YAMLs,
      ``--chunk 32 --ate``, launch counts zeroed just before and read just
      after (``launches_per_frame`` of the loaded config): a TUM file of
      FRAMES rows at epoch times, ATE under 0.13 m, poses within 1e-6 m of
      ``run_vio_sequence`` on the same decoded frames and configs, frames/s,
      decode ms a frame, and host syncs a frame (one more run in torch's
      sync debug mode);
    - a checkpoint after EUROC_SPLIT frames, loaded into a fresh template,
      the rest run from it: poses within 1e-6 m of the uninterrupted run;
    - ``apps/run_euroc_batch.py`` on the FRAMES-frame sequence and its first
      EUROC_SHORT frames (B=2, the second padded), launches per batched
      frame as above: each lane's ATE under 0.13 m and within 2e-4 m of the
      lane's sequence run alone by the batch app;
    - ``entry.entry()``'s step on the card: a finite pose."""
    import tempfile

    import numpy as np
    import torch

    from msckf_stereo_c_torch.apps import run_euroc, run_euroc_batch
    from msckf_stereo_c_torch.config import (
        FilterConfig, FrontendConfig, load_camchain, load_filter_config, load_frontend_config)
    from msckf_stereo_c_torch.entry import entry
    from msckf_stereo_c_torch.io import native, png
    from msckf_stereo_c_torch.io.checkpoint import load_state, save_state
    from msckf_stereo_c_torch.io.euroc import ImageSource, load_sequence, synchronize_stereo
    from msckf_stereo_c_torch.io.tum import read_tum
    from msckf_stereo_c_torch.models.vio import init_vio_state, run_vio_sequence
    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.sim.euroc_dataset import EUROC_EPOCH_NS, to_uint8, write_euroc

    cfg = {flag: os.path.join(ROOT, "config", name) for flag, name in (
        ("--camchain", "camchain-imucam-euroc.yaml"), ("--imgproc-config", "app_imgproc.yaml"),
        ("--msckf-config", "app_msckfvio.yaml"))}
    fcfg = load_frontend_config(cfg["--imgproc-config"])
    mcfg = load_filter_config(cfg["--msckf-config"], FilterConfig(ns_iters=10))  # the app's card default
    calib = load_camchain(cfg["--camchain"])
    T = FRAMES
    per_frame = launches_per_frame(fcfg)
    frame_t, gt = scene.frame_t, scene.traj.p[scene.frame_idx]
    out = dict(launches_per_frame_expected=per_frame)
    with tempfile.TemporaryDirectory(prefix="euroc_") as tmp:
        t0 = time.perf_counter()
        imu = scene.imu
        mav0 = write_euroc(os.path.join(tmp, f"seq{T}"), frame_t, scene.img0, scene.img1, imu.t, imu.gyro, imu.acc, gt)
        short = write_euroc(os.path.join(tmp, f"seq{EUROC_SHORT}"), frame_t[:EUROC_SHORT], scene.img0[:EUROC_SHORT],
                            scene.img1[:EUROC_SHORT], imu.t, imu.gyro, imu.acc, gt[:EUROC_SHORT])
        out["write_seconds"] = time.perf_counter() - t0

        # The decoder the apps use, and every backend's decode time.
        seq = load_sequence(mav0)
        times, files0, files1 = synchronize_stereo(seq)
        check(len(times) == T, f"euroc: {len(times)} stereo frames read back, expected {T}")
        want0, want1 = to_uint8(scene.img0).astype(np.float32), to_uint8(scene.img1).astype(np.float32)
        t0 = time.perf_counter()
        with ImageSource(files0) as s0, ImageSource(files1) as s1:
            dec0, dec1 = s0.next(T), s1.next(T)
            backend = s0.backend
        dec_ms = (time.perf_counter() - t0) * 1e3 / (2 * T)
        check(np.array_equal(dec0, want0) and np.array_equal(dec1, want1),
              f"euroc: frames decoded by the {backend} backend differ from the rendered ones rounded to uint8")
        t0 = time.perf_counter()
        zdec = png.decode_pngs(files0 + files1)
        zlib_ms = (time.perf_counter() - t0) * 1e3 / (2 * T)
        check(np.array_equal(zdec[:T], want0) and np.array_equal(zdec[T:], want1),
              "euroc: the zlib decoder differs from the rendered frames rounded to uint8")
        native_ms = None
        if native.available():
            t0 = time.perf_counter()
            ndec = np.stack([native.decode_png(f, 752, 480) for f in files0 + files1])
            native_ms = (time.perf_counter() - t0) * 1e3 / (2 * T)
            check(np.array_equal(ndec[:T], want0) and np.array_equal(ndec[T:], want1),
                  "euroc: the native decoder differs from the rendered frames rounded to uint8")
        out.update(backend=backend, native_build_error=native.build_error(), decode_ms_per_image=dec_ms,
                   zlib_ms_per_image=zlib_ms, native_ms_per_image=native_ms)
        print(f"[euroc] {T} frames written as EuRoC in {out['write_seconds']:.1f} s; the apps decode with the "
              f"{backend} backend ({run_euroc.decoder_line(backend)}): {2 * T} images equal the rendered frames "
              f"rounded to uint8, {dec_ms:.2f} ms an image; zlib decoder alone {zlib_ms:.2f} ms an image, native "
              f"{'not built' if native_ms is None else f'{native_ms:.2f} ms an image'}, on the host of {card}")

        # The app, timed with its launches counted, then once more with
        # every host sync counted.
        pose_out = os.path.join(tmp, "pose.txt")
        argv = [mav0, "--chunk", str(EUROC_CHUNK), "--ate", "--out", pose_out]
        argv += [x for kv in cfg.items() for x in kv]
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        app = run_euroc.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_cuda.launch_counts)
        check(app.backend == backend, f"euroc: the app decoded with {app.backend}, expected {backend}")
        check(launches_match(counts, per_frame, T),
              f"euroc app: launches {counts}, expected per frame {per_frame}")
        tum_t, _, _ = read_tum(pose_out)
        check(tum_t.shape == (T,), f"euroc app: the TUM file has {tum_t.shape[0]} rows, expected {T}")
        check(bool(np.all(np.abs(tum_t - (EUROC_EPOCH_NS * 1e-9 + frame_t)) < 2e-6)),
              "euroc app: TUM times are not the frames' epoch times")
        check(bool(np.isfinite(app.positions).all()), "euroc app: non-finite poses")
        ate = app.ate.rmse
        check(ate < 0.13, f"euroc app: ATE {ate} m is above the 0.13 m pass bar")
        decode_ms = app.timer.totals["decode_images"] * 1e3 / T
        sites = count_syncs(lambda: run_euroc.main(argv))
        sites = {k: v for k, v in sorted(sites.items(), key=lambda kv: -kv[1])}

        t_base = min(times[0], seq.imu.t[0])
        rel_t, imu_t = times - t_base, seq.imu.t - t_base

        def direct(s0, s1, **kw):
            return run_vio_sequence(fcfg, mcfg, calib, rel_t[s0:s1], dec0[s0:s1], dec1[s0:s1], imu_t, seq.imu.gyro,
                                    seq.imu.acc, filter_dtype=torch.float32, method="schur", device="cuda", **kw)

        whole = direct(0, T)
        app_gap = float(np.abs(app.positions - whole.positions).max())
        check(app_gap <= 1e-6, f"euroc: the app's poses are {app_gap} m from run_vio_sequence's (> 1e-6 m)")

        # Checkpoint after EUROC_SPLIT frames, resume from a fresh template.
        first = direct(0, EUROC_SPLIT)
        ckpt = os.path.join(tmp, "state.npz")
        save_state(ckpt, first.final_state)
        template = init_vio_state(fcfg, mcfg, calib, (480, 752), torch.float32, torch.float32, "cuda")
        rest = direct(EUROC_SPLIT, T, state=load_state(ckpt, template), prev_frame_t=float(rel_t[EUROC_SPLIT - 1]))
        resumed = np.concatenate([first.positions, rest.positions])
        ckpt_gap = float(np.abs(resumed - whole.positions).max())
        check(ckpt_gap <= 1e-6, f"euroc: the resumed run is {ckpt_gap} m from the uninterrupted one (> 1e-6 m)")
        out.update(frames=T, seconds=secs, fps=T / secs, loop_seconds=app.seconds, decode_ms_per_frame=decode_ms,
                   launches=counts, ate_rmse_m=ate, app_vs_direct_m=app_gap, resume_vs_whole_m=ckpt_gap,
                   syncs_per_frame=sum(sites.values()) / T, sync_sites={k: v / T for k, v in sites.items()})
        print(f"[euroc] run_euroc: {T} frames in {secs:.3f} s = {T / secs:.2f} frames/s (B=1, start-up and "
              f"decode included) on {card}; decode {decode_ms:.2f} ms a frame ({backend}); "
              f"{out['syncs_per_frame']:.2f} host syncs a frame; ATE RMSE {ate:.6f} m; launches a frame "
              f"{ {k: v // T for k, v in counts.items()} }")
        print(f"[euroc] app against run_vio_sequence: {app_gap:.3e} m; checkpoint after frame {EUROC_SPLIT} "
              f"resumed: {ckpt_gap:.3e} m from the uninterrupted run")

        # The batch app: B=2, the second lane padded after EUROC_SHORT frames.
        bargv = ["--chunk", str(EUROC_CHUNK), "--ate", "--out-dir", os.path.join(tmp, "poses")]
        per_batched = launches_per_frame(FrontendConfig())
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        lanes = run_euroc_batch.main([mav0, short] + bargv)
        torch.cuda.synchronize()
        bsecs = time.perf_counter() - t0
        bcounts = dict(_cuda.launch_counts)
        check(launches_match(bcounts, per_batched, T),
              f"euroc batch app: launches {bcounts}, expected per batched frame {per_batched}")
        rows = []
        for path, lane in zip((mav0, short), lanes):
            alone = run_euroc_batch.main([path] + bargv[:-1] + [os.path.join(tmp, "alone")])[0]
            gap = abs(lane.ate.rmse - alone.ate.rmse)
            rows.append(dict(name=lane.name, frames=len(lane.times), ate_batched_m=lane.ate.rmse,
                             ate_alone_m=alone.ate.rmse, ate_gap_m=gap,
                             pose_gap_m=float(np.abs(lane.positions - alone.positions).max())))
            print(f"[euroc] run_euroc_batch lane {lane.name} ({len(lane.times)} frames): ATE {lane.ate.rmse:.6f} m "
                  f"batched, {alone.ate.rmse:.6f} m alone ({gap:.2e} m apart, poses {rows[-1]['pose_gap_m']:.2e} m)")
            check(bool(np.isfinite(lane.positions).all()), f"euroc batch app: non-finite poses in {lane.name}")
            check(lane.ate.rmse < 0.13, f"euroc batch app: {lane.name} ATE {lane.ate.rmse} m above 0.13 m")
            check(gap <= 2e-4, f"euroc batch app: {lane.name} ATE {lane.ate.rmse} m batched vs {alone.ate.rmse} m "
                               f"alone (> 2e-4 m apart)")
        out["batch"] = dict(lanes=rows, seconds=bsecs, fps=sum(len(r.times) for r in lanes) / bsecs,
                            launches=bcounts)
        print(f"[euroc] run_euroc_batch: B=2 x {T} padded frames in {bsecs:.3f} s "
              f"({out['batch']['fps']:.2f} unpadded frames/s aggregate, decode included) on {card}; launches per "
              f"batched frame { {k: v // T for k, v in bcounts.items()} }")

    fn, args = entry()
    _, (pose, _) = fn(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(pose.p).all()), "entry(): non-finite pose")
    out["entry_pose"] = pose.p.cpu().tolist()
    print(f"[euroc] entry(): one vio_step at 752x480 ('cholesky', ns_iters=0) on the card, pose "
          f"{out['entry_pose']}")
    return out


def _path_run(label, fcfg, mcfg, traj, imu, frame_idx, img0, img1, allowed, card):
    """``run_vio_sequence`` over the frames under ``fcfg`` (images host
    arrays or card tensors), the launch counts zeroed just before and read
    just after and held to ``launches_per_frame``; then SYNC_FRAMES frames
    again in torch's sync debug mode, every synchronising site inside the
    package among ``allowed`` (None: return the sites, check nothing).
    Prints frames/s (B=1), ATE, syncs a frame by site and the split;
    returns (results, sync sites)."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB
    from msckf_stereo_c_torch.models.vio import run_vio_sequence
    from msckf_stereo_c_torch.ops import _cuda

    frame_t = traj.t[frame_idx]
    T = len(frame_idx)

    def run(n):
        return run_vio_sequence(fcfg, mcfg, EUROC_CALIB, frame_t[:n], img0[:n], img1[:n], imu.t, imu.gyro, imu.acc,
                                image_dtype=torch.float32, filter_dtype=torch.float32, method="schur",
                                device="cuda")

    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(T)  # ends in a device-to-host copy of the outputs
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    sites = package_sites(count_syncs(lambda: run(SYNC_FRAMES)))
    per = {k: v // T for k, v in counts.items()}
    check(bool(np.isfinite(res.positions).all()), f"[paths] {label}: non-finite poses")
    ate = _ate(frame_t, res.positions, traj.p[frame_idx])
    tracks = res.tracking["after_ransac"]
    want = launches_per_frame(fcfg)
    out = dict(frames=T, seconds=secs, fps=T / secs, ate_rmse_m=ate, launches=counts, launches_per_frame=per,
               tracks_per_frame_mean=float(np.mean(tracks)), min_tracks_last20=int(np.min(tracks[-20:])),
               syncs_per_frame=sum(sites.values()) / SYNC_FRAMES,
               sync_sites={k: v / SYNC_FRAMES for k, v in sorted(sites.items(), key=lambda kv: -kv[1])},
               frames_matching_above_published=int(np.sum(res.tracking["after_matching"] > tracks)))
    split = " / ".join(str(per[k]) for k in ("lk_corr_align", "lk_corr_align_gain", "extract_template",
                                             "resample_template"))
    print(f"[paths] {label}: {T} frames in {secs:.3f} s = {T / secs:.2f} frames/s (B=1) on {card}; ATE RMSE "
          f"{ate:.5f} m; tracks mean {np.mean(tracks):.1f}, min over the last 20 {np.min(tracks[-20:])}; launches a "
          f"frame {split} (lk_corr_align / lk_corr_align_gain / extract_template / resample_template; K2, K1, K3 "
          f"{per['extract_windows']}/{per['lk_corr_iterate']}/{per['lk_corr_iterate_gain']}); host syncs a frame "
          f"over {SYNC_FRAMES} frames {out['syncs_per_frame']:.2f}: "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["sync_sites"].items()))
    check(launches_match(counts, want, T),
          f"[paths] {label}: launches {counts}, expected per frame {want}")
    if allowed is not None:
        new = sorted(set(sites) - allowed)
        check(not new, f"[paths] {label}: host syncs at sites the bench path has none at: {new}")
    return out, sites


def pattern_rows(scene, fcfg):
    """The kernels of the new call patterns against their plain versions
    on the card, at the tolerances of ``align_rows`` and ``template_rows``:
    level-2 and level-3 temporal calls with two lanes folded into the
    feature axis (bench frames 20 -> 21 and 40 -> 41, 96 FAST corners each,
    an int32 image index), and the standalone anchor call (frame 40's
    templates, frame 41's image as both images of the call)."""
    import torch

    from msckf_stereo_c_torch.models.frontend import pyramids_for
    from msckf_stereo_c_torch.ops import klt_corr as kc
    from msckf_stereo_c_torch.utils.lanes import lane_index

    P, iters, eps = fcfg.patch_size, fcfg.max_iteration, fcfg.track_precision
    c_off, r = (P - 1) / 2.0, P // 2 + 1
    dev = torch.device("cuda")

    def stack(frames):
        return pyramids_for(torch.as_tensor(scene.img0[frames], dtype=torch.float32).to(dev), fcfg)

    prev, curr = stack([20, 40]), stack([21, 41])
    pts = torch.cat([_best_corners(prev[0][b], fcfg, 96) for b in range(2)])
    idx = lane_index(2, 96, dev)
    rows = []

    def check_align(tag, img, sp, guess, img_index):
        H, W = img.shape[-2:]
        S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
        hi = float(S - P - 1)
        tq = kc._template_quantities(sp, P, "none")
        sorg = kc._clip_xy(torch.floor(guess) - S // 2, 0.0, W - S, H - S)
        args = (img, sorg.to(torch.int32), S, tq.gx, tq.gy, kc._k1_sc(tq, guess - c_off - sorg, ~tq.good), iters, eps,
                hi, img_index)
        got, want = kc.lk_corr_align(*args), kc.lk_corr_align_reference(*args)
        torch.cuda.synchronize()
        pw, pg = want + c_off + sorg, got + c_off + sorg

        def ok_mask(p):
            return tq.good & (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

        border = torch.stack([pw[:, 0] - r, (W - r) - pw[:, 0], pw[:, 1] - r, (H - r) - pw[:, 1]], -1)
        near = border.abs().min(-1).values < K1_TOL
        m = ok_mask(pw)
        check(torch.equal(ok_mask(pg)[~near], m[~near]), f"[paths] {tag}: valid mask differs from the plain version")
        check(bool(torch.isfinite(got).all()), f"[paths] {tag}: non-finite output")
        err = float((got - want)[m].abs().max()) if bool(m.any()) else 0.0
        check(err <= K1_TOL, f"[paths] {tag}: lk_corr_align differs by {err} px (> {K1_TOL})")
        rows.append(dict(name="lk_corr_align", pattern=tag, H=H, W=W, N=int(got.shape[0]), valid=int(m.sum()),
                         near_border=int(near.sum()), max_abs_err=err))
        print(f"[paths] {tag} {W}x{H} N={got.shape[0]}: lk_corr_align within {err:.2e} px of its plain version "
              f"(tol {K1_TOL}), {int(m.sum())} valid lanes, masks equal ({int(near.sum())} lanes within {K1_TOL} "
              f"px of the border exempt)")

    for lvl in (2, 3):
        p = (pts / 2.0**lvl).contiguous()
        sp = kc.extract_template(prev[lvl], p, P, idx)
        check(torch.equal(sp, kc.extract_template_reference(prev[lvl], p, P, idx)),
              f"[paths] extract_template differs from its plain version at level {lvl} with lanes")
        check_align(f"temporal level {lvl}, B=2 lanes", curr[lvl], sp, p, idx)
    anchor = kc.extract_template(prev[0][1], pts[96:], P)
    check_align("standalone anchor", curr[0][1], anchor, pts[96:], None)
    return rows


def phase_frontend_paths(scene, mcfg, card):
    """The tracker's paths off the bench configuration at 752x480, each
    through ``run_vio_sequence`` on the card (B=1) under the bench filter,
    its launches held to ``launches_per_frame`` and its host syncs to the
    sites the bench configuration has (counted on both scenes first):

    a. the fast-motion scene of tests/test_fast_motion.py (6 s circle,
       omega 2 pi / 8, roll 0.25, 500 wall landmarks, rendered on the
       card) at each temporal depth of FAST_TLEVELS, and of FAST_LAST last
       if it fits: min tracks over the last 20 frames > 15 and the test's
       ATE bar;
    b. the reference's own tracker (REFERENCE_TRACKER) over the FRAMES
       bench frames: ATE < 0.13 m, and the tracks RANSAC rejects counted
       on the card (the rejections summed into a device tensor, read once
       after the run);
    c. the bench scene's other paths (BENCH_PATHS) over PATH_FRAMES frames
       each; the gather LK launches no hand kernel and keeps ATE < 0.13 m;
    d. ``pattern_rows``: the kernels on the new call patterns against
       their plain versions."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import FrontendConfig
    from msckf_stereo_c_torch.ops import ransac
    from msckf_stereo_c_torch.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from msckf_stereo_c_torch.sim.render_torch import TorchRenderer

    t_start = time.time()
    dev = torch.device("cuda")
    traj = make_circle_trajectory(duration=6.0, omega=2.0 * np.pi / 8.0, roll_amp=0.25, t_static=1.5, t_ramp=1.0)
    fidx = np.arange(0, traj.t.shape[0], 10)
    fimu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    f0, f1 = TorchRenderer(make_wall_landmarks(num=500, radius=8.0, seed=1), r_wall=8.0, device=dev).render_sequence(
        traj, fidx)
    fast = (traj, fimu, fidx, f0, f1)
    bench = (scene.traj, scene.imu, scene.frame_idx, scene.img0, scene.img1)
    bench_cfg = FrontendConfig(temporal_levels=1)
    allowed = set()
    out = {}
    for name, sc in (("bench", bench), ("fast-motion", fast)):
        cut = (sc[0], sc[1], sc[2][:SYNC_FRAMES], sc[3][:SYNC_FRAMES], sc[4][:SYNC_FRAMES])
        o, sites = _path_run(f"{name} scene, bench front end", bench_cfg, mcfg, *cut, None, card)
        allowed |= set(sites)
        out[f"baseline {name}"] = o
    print(f"[paths] sync sites of the bench front end: {sorted(allowed)}")

    def fast_run(tl, bar):
        t0 = time.time()
        o, _ = _path_run(f"fast-motion, temporal_levels={tl}", FrontendConfig(temporal_levels=tl), mcfg, *fast,
                         allowed, card)
        o["run_seconds"] = time.time() - t0
        out[f"fast-motion tl{tl}"] = o
        check(o["min_tracks_last20"] > 15, f"[paths] fast-motion tl{tl}: min tracks {o['min_tracks_last20']} <= 15")
        check(o["ate_rmse_m"] < bar, f"[paths] fast-motion tl{tl}: ATE {o['ate_rmse_m']} m above the {bar} m bar")

    for tl, bar in FAST_TLEVELS:
        fast_run(tl, bar)

    rejected = torch.zeros((), dtype=torch.int64, device=dev)
    two_point = ransac.two_point_ransac

    def counted(pts1, pts2, valid, *args, **kwargs):
        mask = two_point(pts1, pts2, valid, *args, **kwargs)
        rejected.add_(torch.sum(valid & ~mask))
        return mask

    ransac.two_point_ransac = counted
    try:
        o, _ = _path_run("reference tracker", FrontendConfig(**REFERENCE_TRACKER), mcfg, *bench, allowed, card)
    finally:
        ransac.two_point_ransac = two_point
    o["ransac_rejections"] = int(rejected)  # both cameras, the sync-counted frames included
    out["reference tracker"] = o
    print(f"[paths] reference tracker: RANSAC rejected {o['ransac_rejections']} matches over the timed and the "
          f"sync-counted runs ({o['frames_matching_above_published']} frames with after_matching > after_ransac)")
    check(o["ate_rmse_m"] < 0.13, f"[paths] reference tracker: ATE {o['ate_rmse_m']} m above 0.13 m")
    check(o["ransac_rejections"] > 0, "[paths] reference tracker: RANSAC rejected no match")

    cut = tuple(x[:PATH_FRAMES] for x in bench[2:])
    for label, kw in BENCH_PATHS.items():
        o, _ = _path_run(label, FrontendConfig(**{"temporal_levels": 1, **kw}), mcfg, *bench[:2], *cut, allowed,
                            card)
        out[label] = o
    check(out["gather LK"]["ate_rmse_m"] < 0.13, f"[paths] gather LK: ATE {out['gather LK']['ate_rmse_m']} m")

    out["kernel_rows"] = pattern_rows(scene, bench_cfg)
    # The last depth costs about what the first did.
    spent, need = time.time() - t_start, out[f"fast-motion tl{FAST_TLEVELS[0][0]}"]["run_seconds"]
    if spent + need <= PATHS_SECONDS:
        fast_run(*FAST_LAST)
    else:
        out[f"fast-motion tl{FAST_LAST[0]}"] = f"not run: {spent:.1f} s spent + {need:.1f} s > {PATHS_SECONDS} s"
        print(f"[paths] fast-motion, temporal_levels={FAST_LAST[0]}: not run ({spent:.1f} s spent, about "
              f"{need:.1f} s more would pass the phase's {PATHS_SECONDS:.0f} s)")
    return out


def _synthetic_ba(F, L, seed=0):
    """A keyframe BA problem at the gate's size: F keyframes on a 3 m circle
    (two turns) looking out at the 7 m room wall, L wall landmarks, stereo
    observations with 1e-3 noise where both cameras see the landmark within
    the field of view, poses (but the first) and landmarks perturbed by 1-2
    cm.  float64 on the card."""
    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import EUROC_CALIB
    from msckf_stereo_c_torch.parallel.ba import BAProblem
    from msckf_stereo_c_torch.utils.lie import so3_exp
    from msckf_stereo_c_torch.utils.quaternion import rot_to_jpl

    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, 4.0 * np.pi, F, endpoint=False)
    c, s, z, o = np.cos(th), np.sin(th), np.zeros(F), np.ones(F)
    R = np.stack([-s, c, z, z, z, o, c, s, z], 1).reshape(F, 3, 3)  # rows: cam x, y, z (outward) in world
    p = np.stack([3.0 * c, 3.0 * s, 0.3 * np.sin(2.0 * th)], 1)
    a = rng.uniform(0.0, 2.0 * np.pi, L)
    lms = np.stack([7.0 * np.cos(a), 7.0 * np.sin(a), rng.uniform(-2.0, 2.0, L)], 1)
    T01 = EUROC_CALIB.T_cam0_cam1_mat()
    p_c0 = np.einsum("fij,lfj->lfi", R, lms[:, None] - p[None])
    p_c1 = p_c0 @ T01[:3, :3].T + T01[:3, 3]
    uv0 = p_c0[..., :2] / p_c0[..., 2:]
    uv1 = p_c1[..., :2] / p_c1[..., 2:]
    mask = ((p_c0[..., 2] > 0.3) & (p_c1[..., 2] > 0.3) & (np.abs(uv0) < [0.8, 0.5]).all(-1)
            & (np.abs(uv1) < [0.8, 0.5]).all(-1))
    obs = (np.concatenate([uv0, uv1], -1) + rng.normal(0.0, 1e-3, (L, F, 4))) * mask[..., None]

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64, device="cuda")

    dth, dp = rng.normal(0.0, 0.01, (F, 3)), rng.normal(0.0, 0.01, (F, 3))
    dth[0] = dp[0] = 0.0
    q = rot_to_jpl(so3_exp(t(dth)) @ t(R))
    return BAProblem(q, t(p + dp), t(lms + rng.normal(0.0, 0.02, (L, 3))), t(obs),
                     torch.as_tensor(mask, device="cuda"), t(T01[:3, :3]), t(T01[:3, 3]))


def _timed_refine(prob, iters):
    """(refined, costs, ms a Gauss-Newton step) of ``refine_trajectory`` on
    the card, after a one-step warm-up at the same shapes."""
    import torch

    from msckf_stereo_c_torch.parallel.refine import refine_trajectory

    refine_trajectory(prob, iters=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, costs = refine_trajectory(prob, iters=iters)
    torch.cuda.synchronize()
    return refined, costs, (time.perf_counter() - t0) * 1e3 / iters


def _dist_rank(rank, world, port, in_path, out_dir):
    """One rank of the distributed phase: the sharded BA and pose graph over
    ``gloo`` on CUDA tensors of the one card; results (moved to the host)
    or the error saved for the parent."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from msckf_stereo_c_torch.parallel import ba, multisession, posegraph, refine

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        try:
            data = torch.load(in_path)
            prob = ba.BAProblem(**{k: v.cuda() for k, v in data["ba"].items()})
            graph = posegraph.PoseGraph(**{k: v.cuda() for k, v in data["graph"].items()})
            t0 = time.perf_counter()
            blk, costs = ba.make_distributed_ba(iters=8)(ba.shard_ba_problem(prob, world, rank))
            full, full_costs = refine.refine_trajectory(prob, iters=8, group=dist.group.WORLD)
            pg, pg_costs = posegraph.make_distributed_pose_graph(iters=12)(
                posegraph.shard_pose_graph(graph, world, rank))
            joint, joint_costs = multisession.optimize_joint(graph, group=dist.group.WORLD, iters=12)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            on_card = all(x.is_cuda for x in (blk.landmarks, costs, full.landmarks, pg.p, joint.p))
            torch.save(dict(on_card=on_card, seconds=secs, ba_q=blk.cam_q.cpu(), ba_p=blk.cam_p.cpu(),
                            ba_landmarks=blk.landmarks.cpu(), ba_costs=costs.cpu(),
                            refine_landmarks=full.landmarks.cpu(), refine_costs=full_costs.cpu(),
                            pg_q=pg.q.cpu(), pg_p=pg.p.cpu(), pg_costs=pg_costs.cpu(), joint_p=joint.p.cpu(),
                            joint_costs=joint_costs.cpu()),
                       os.path.join(out_dir, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except Exception as e:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def phase_backend(scene, main_res, stress_run, card, out_dir):
    """The refinement back end on the card in float64: (a) BA from the main
    path's run, against the CPU, and at the gate's size; (b) STRESS_REFINE's
    tier on the stress path's run; (c) the multi-session gate at MS_SECONDS
    with its sessions as two lanes; (d) the sharded solvers over gloo in
    DIST_WORLD processes on the card."""
    import multiprocessing

    import numpy as np
    import torch

    from msckf_stereo_c_torch.config import FrontendConfig
    from msckf_stereo_c_torch.io.tum import evaluate_ate
    from msckf_stereo_c_torch.ops import _cuda
    from msckf_stereo_c_torch.parallel.ba import ba_gauss_newton
    from msckf_stereo_c_torch.parallel.posegraph import PoseGraph, odometry_edges, optimize_pose_graph
    from msckf_stereo_c_torch.parallel.refine import build_ba_problem, problem_to_body_poses, refine_trajectory
    from msckf_stereo_c_torch.scripts import multisession_gate, stress_gate
    from msckf_stereo_c_torch.utils.quaternion import rot_to_jpl

    out = {}
    # (a) BA from the main path's run: card against CPU, costs falling.
    res = main_res
    vio = (res.times, res.quats_xyzw, res.positions, res.fid, res.uv, res.valid)
    prob = build_ba_problem(*vio, keyframe_stride=5, device="cuda")
    check(prob is not None, "backend: the main path's run gave no BA problem")
    refined, costs, ms_step = _timed_refine(prob, 8)
    prob_cpu = build_ba_problem(*vio, keyframe_stride=5, device="cpu")
    refined_cpu, costs_cpu = refine_trajectory(prob_cpu, iters=8)
    costs, costs_cpu = costs.cpu().numpy(), costs_cpu.numpy()
    cost_gap = float(np.max(np.abs(costs - costs_cpu) / np.abs(costs_cpu)))
    pos_gap = float(torch.max(torch.abs(refined.cam_p.cpu() - refined_cpu.cam_p)))
    lm_gap = float(torch.max(torch.abs(refined.landmarks.cpu() - refined_cpu.landmarks)))
    F, L = prob.cam_q.shape[0], prob.landmarks.shape[0]
    kf = np.arange(0, len(res.times), 5)[:F]
    gt = scene.traj.p[scene.frame_idx[kf]]
    ate_before = float(evaluate_ate(res.times[kf], problem_to_body_poses(prob), res.times[kf], gt).rmse)
    ate_after = float(evaluate_ate(res.times[kf], problem_to_body_poses(refined), res.times[kf], gt).rmse)
    synth = _synthetic_ba(*BA_GATE_SIZE)
    s_ref, s_costs, s_ms = _timed_refine(synth, 8)
    s_costs = s_costs.cpu().numpy()
    s_obs = int(synth.mask.sum())
    out["ba_main"] = dict(keyframes=F, landmarks=L, observations=int(prob.mask.sum()), costs=costs.tolist(),
                          costs_cpu=costs_cpu.tolist(), cost_gap_rel=cost_gap, position_gap_m=pos_gap,
                          landmark_gap_m=lm_gap, ms_per_step=ms_step, ate_kf_before_m=ate_before,
                          ate_kf_after_m=ate_after)
    out["ba_gate_size"] = dict(keyframes=BA_GATE_SIZE[0], landmarks=BA_GATE_SIZE[1], observations=s_obs,
                               costs=s_costs.tolist(), ms_per_step=s_ms)
    print(f"[backend] (a) main path BA: {F} keyframes x {L} landmarks ({int(prob.mask.sum())} observations), "
          f"cost {costs[0]:.6g} -> {costs[-1]:.6g}, {ms_step:.3f} ms a Gauss-Newton step on {card}; card vs CPU: "
          f"costs {cost_gap:.2e} rel, positions {pos_gap:.2e} m, landmarks {lm_gap:.2e} m; "
          f"keyframe ATE {ate_before:.5f} -> {ate_after:.5f} m")
    print(f"[backend] (a) gate-size BA: {BA_GATE_SIZE[0]} keyframes x {BA_GATE_SIZE[1]} landmarks ({s_obs} "
          f"observations), cost {s_costs[0]:.6g} -> {s_costs[-1]:.6g}, {s_ms:.3f} ms a Gauss-Newton step")
    check(cost_gap <= BA_CARD_TOL and pos_gap <= BA_CARD_TOL and lm_gap <= BA_CARD_TOL,
          f"backend: card BA differs from the CPU's (costs {cost_gap}, positions {pos_gap}, landmarks {lm_gap})")
    check(costs[-1] < costs[0] and s_costs[-1] < s_costs[0], "backend: BA costs did not fall")
    check(bool(np.isfinite(s_costs).all()) and bool(torch.isfinite(s_ref.cam_p).all()), "backend: non-finite BA")

    # (b) STRESS_REFINE's tier on the stress path's run (the JAX script's keys).
    t0 = time.perf_counter()
    stats = stress_gate.refine_stats(stress_run, 5, 60, device="cuda")
    torch.cuda.synchronize()
    stats["seconds"] = time.perf_counter() - t0
    out["stress_refine"] = stats
    print(f"[backend] (b) STRESS_REFINE on the stress path's {stress_run.n_frames} frames: {stats}")
    check("refine_keyframes" in stats, f"backend: the stress run gave no refine problem ({stats})")
    check(np.isfinite(stats["ate_kf_after"]) and stats["refine_cost_drop"] > 1.0,
          f"backend: STRESS_REFINE's BA did not lower its cost ({stats})")

    # (c) The multi-session gate, its sessions as the two lanes of one run.
    want = launches_per_frame(FrontendConfig())
    _cuda.reset_launch_counts()
    ms = multisession_gate.run_multisession(duration=MS_SECONDS, chunk=MS_CHUNK, cache=False, device="cuda")
    counts = dict(_cuda.launch_counts)
    T = len(np.arange(0, int(MS_SECONDS * 200.0) + 1, 10))
    ms.update(frames=T, launches=counts)
    out["multisession"] = ms
    print(f"[backend] (c) multi-session gate, {MS_SECONDS:g} s sessions as 2 lanes x {T} frames: joint ATE prior "
          f"{ms['joint_ate_prior']:.5f} m, global alignment {ms['joint_ate_global_align']:.5f} m, after the "
          f"graph {ms['joint_ate_after_graph']:.5f} m; sessions {ms['ate_session_a']:.5f} / "
          f"{ms['ate_session_b']:.5f} m; {ms['landmark_matches']} matches, {ms['inter_edges']} inter-session "
          f"edges, {ms['graph_nodes']} nodes; wall {ms['wall_s']:.2f} s (sessions {ms['wall_sessions_s']:.2f}, "
          f"alignment sweep {ms['wall_align_s']:.2f}, graph {ms['wall_graph_s']:.2f}); launches per batched "
          f"frame { {k: v / T for k, v in counts.items()} }")
    check(launches_match(counts, want, T),
          f"backend: multi-session launches {counts}, expected per batched frame {want}")
    after = ms["joint_ate_after_graph"]
    check(after < 0.5 * ms["joint_ate_prior"] and after < 0.13 and after <= ms["joint_ate_global_align"] + 0.02,
          f"backend: multi-session bars missed ({ms})")

    # (d) The sharded solvers over gloo in DIST_WORLD processes on the card:
    # the main path's BA problem and a pose graph over its 60 frames (VIO
    # poses; odometry edges at strides 1 and 5 measured from the truth).
    q_gt = rot_to_jpl(torch.as_tensor(scene.traj.R_w_b[scene.frame_idx], dtype=torch.float64)).numpy()
    p_gt = scene.traj.p[scene.frame_idx]
    e1, e5 = odometry_edges(q_gt, p_gt, 1, 1e4), odometry_edges(q_gt, p_gt, 5, 1e2)
    graph = PoseGraph(*(torch.as_tensor(x, device="cuda") for x in (
        np.asarray(res.quats_xyzw, np.float64), np.asarray(res.positions, np.float64),
        np.concatenate([e1[0], e5[0]]).astype(np.int64), np.concatenate([e1[1], e5[1]]).astype(np.int64),
        np.concatenate([e1[2], e5[2]]), np.concatenate([e1[3], e5[3]]), np.concatenate([e1[4], e5[4]]))))
    want_ba, want_ba_costs = ba_gauss_newton(prob, iters=8)
    want_pg, want_pg_costs = optimize_pose_graph(graph, iters=12)
    dist_dir = os.path.join(out_dir, "backend_dist")
    os.makedirs(dist_dir, exist_ok=True)
    for f in os.listdir(dist_dir):
        os.remove(os.path.join(dist_dir, f))
    in_path = os.path.join(dist_dir, "problems.pt")
    torch.save(dict(ba={k: v.cpu() for k, v in prob._asdict().items()},
                    graph={k: v.cpu() for k, v in graph._asdict().items()}), in_path)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dist_rank, args=(r, DIST_WORLD, port, in_path, dist_dir)) for r in range(DIST_WORLD)]
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(timeout=300)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.terminate()
                pr.join(timeout=30)
    wall = time.perf_counter() - t0
    errors = {r: open(os.path.join(dist_dir, f"rank{r}.err")).read() for r in range(DIST_WORLD)
              if os.path.exists(os.path.join(dist_dir, f"rank{r}.err"))}
    check(not errors, f"backend: a gloo rank failed on CUDA tensors (no move to the CPU is made): {errors}")
    check(all(pr.exitcode == 0 for pr in procs), f"backend: gloo ranks exited {[pr.exitcode for pr in procs]}")
    Lb = -(-L // DIST_WORLD)
    gaps = dict(costs_rel=0.0, ba_poses_m=0.0, landmarks_m=0.0, graph_poses_m=0.0)
    ranks = []
    for r in range(DIST_WORLD):
        got = torch.load(os.path.join(dist_dir, f"rank{r}.pt"))
        check(got["on_card"], f"backend: rank {r}'s results are not CUDA tensors")
        s0, s1 = r * Lb, min((r + 1) * Lb, L)

        def gap(a, b):
            return float(torch.max(torch.abs(a - b.cpu()))) if a.numel() else 0.0

        for c, w in ((got["ba_costs"], want_ba_costs), (got["refine_costs"], want_ba_costs),
                     (got["pg_costs"], want_pg_costs), (got["joint_costs"], want_pg_costs)):
            # Relative gaps, numerical zeros (under 1e-18) held absolutely.
            w = w.cpu()
            rel = torch.abs(c - w) / torch.clamp(torch.abs(w), min=1e-18 / DIST_TOL["costs_rtol"])
            gaps["costs_rel"] = max(gaps["costs_rel"], float(torch.max(rel)))
        gaps["ba_poses_m"] = max(gaps["ba_poses_m"], gap(got["ba_p"], want_ba.cam_p), gap(got["ba_q"], want_ba.cam_q))
        gaps["landmarks_m"] = max(gaps["landmarks_m"], gap(got["ba_landmarks"][: s1 - s0], want_ba.landmarks[s0:s1]),
                                  gap(got["refine_landmarks"], want_ba.landmarks))
        gaps["graph_poses_m"] = max(gaps["graph_poses_m"], gap(got["pg_p"], want_pg.p), gap(got["pg_q"], want_pg.q),
                                    gap(got["joint_p"], want_pg.p))
        ranks.append(dict(rank=r, seconds=got["seconds"]))
    out["distributed"] = dict(world=DIST_WORLD, backend="gloo", tensors="cuda", ba_landmarks=L,
                              graph_nodes=int(graph.q.shape[0]), graph_edges=int(graph.edge_i.shape[0]),
                              gaps=gaps, tolerance=DIST_TOL, wall_seconds=wall, ranks=ranks,
                              ba_costs=want_ba_costs.tolist(), pose_graph_costs=want_pg_costs.tolist())
    print(f"[backend] (d) {DIST_WORLD} gloo ranks on CUDA tensors of the one card ({wall:.2f} s with start-up; "
          f"solves {[round(x['seconds'], 2) for x in ranks]} s): BA {L} landmarks sharded, pose graph "
          f"{int(graph.q.shape[0])} nodes / {int(graph.edge_i.shape[0])} edges sharded; largest gaps to the "
          f"one-process solve {gaps}")
    check(gaps["costs_rel"] <= DIST_TOL["costs_rtol"] and gaps["ba_poses_m"] <= DIST_TOL["ba_poses_m"]
          and gaps["landmarks_m"] <= DIST_TOL["landmarks_m"] and gaps["graph_poses_m"] <= DIST_TOL["graph_poses_m"],
          f"backend: the gloo ranks differ from the one-process solve ({gaps}, tolerance {DIST_TOL})")
    check(float(want_pg_costs[-1]) < float(want_pg_costs[0]), "backend: pose-graph cost did not fall")
    return out


MP_WORLD = 2  # ranks of the [multiproc] phase, over gloo on the one card
MP_BENCH_REPS = 2  # timed chunks of the bench tier (the workers' MSCKF_BENCH_REPS default)


def phase_multiproc(card):
    """The multi-process tier on the card (``parallel/multiproc.py``): (a)
    ``entry.dryrun_multichip(MP_WORLD)``, the bench configuration at
    752x480 over MP_WORLD lanes x 22 frames in one process, then its
    automatic 2-process tier (one lane a rank); (b) the ``vio`` workers
    (half resolution, 4 lanes over MP_WORLD ranks, 8 frames) and the
    ``ba`` workers in float64; (c) the ``bench`` workers, one lane a
    rank, against the one-process MP_WORLD-lane chunk.  Every rank's
    launches exact per batched frame, each rank's lanes against a
    one-process run of its own block (ids and validity on the first 10
    frames, positions within ``multiproc.LANE_TOL_M``), the all-reduced
    ``total_tracks`` equal to the sum of the ranks' own totals; the BA
    ranks hold themselves within 1e-9 of the one-process solve.  The
    tiers' wall times include the ranks' start-up."""
    import torch

    from msckf_stereo_c_torch import entry
    from msckf_stereo_c_torch.config import FrontendConfig
    from msckf_stereo_c_torch.parallel import multiproc
    from msckf_stereo_c_torch.scripts.bench_scaling import run_flagship_on

    def per_frame(launches, frames):
        return {k: v / frames for k, v in launches.items() if v}

    def check_ranks(tag, reports, want, frames):
        """Launches, per-lane agreement and the reduced total of every
        rank of a tier; returns the largest position gap."""
        check(len(reports) == MP_WORLD, f"multiproc: {tag}: {len(reports)} ranks reported")
        total = sum(r["local_total_tracks"] for r in reports)
        for r in reports:
            check(launches_match(r["launches"], want, frames),
                  f"multiproc: {tag} rank {r['process']} launched {r['launches']}, expected per batched frame "
                  f"{want} over {frames} frames")
            check(r["backend"] == "gloo" and r["device"].startswith("cuda"),
                  f"multiproc: {tag} rank {r['process']} ran on {r['device']} over {r['backend']}")
            g = r["gaps"]
            check(g["ids_equal"] and g["max_position_gap_m"] <= multiproc.LANE_TOL_M,
                  f"multiproc: {tag} rank {r['process']} differs from the one-process run of its block: {g}")
            check(r["total_tracks"] == total,
                  f"multiproc: {tag} all-reduced total_tracks {r['total_tracks']} != the ranks' sum {total}")
        return max(r["gaps"]["max_position_gap_m"] for r in reports)

    out = {}
    want = launches_per_frame(FrontendConfig())

    # (a) dryrun_multichip: one process, then the automatic 2-process tier.
    t0 = time.perf_counter()
    dr = entry.dryrun_multichip(MP_WORLD, "cuda")
    secs = time.perf_counter() - t0
    one, T = dr["one_process"], dr["one_process"]["frames"]
    check(launches_match(one["launches"], want, T),
          f"multiproc: dryrun launched {one['launches']} in one process, expected per batched frame {want}")
    check("multi_process" in dr, "multiproc: dryrun_multichip ran no 2-process tier (MSCKF_MULTIPROC_AUTO)")
    gap = check_ranks("dryrun", dr["multi_process"], want, T)
    out["dryrun"] = dict(dr, seconds=secs, max_position_gap_m=gap)
    print(f"[multiproc] (a) dryrun_multichip({MP_WORLD}): one process {MP_WORLD} lanes x {T} frames "
          f"({one['seconds']:.2f} s), num_cams {one['num_cams']}, min after_ransac {one['min_after_ransac']}, "
          f"launches per batched frame {per_frame(one['launches'], T)}; {MP_WORLD} ranks x 1 lane over gloo: "
          f"launches per batched frame {[per_frame(r['launches'], T) for r in dr['multi_process']]}, largest gap to "
          f"the one-lane runs {gap:.3g} m, total_tracks {dr['multi_process'][0]['total_tracks']} = "
          f"{' + '.join(str(r['local_total_tracks']) for r in dr['multi_process'])}; {secs:.1f} s with start-up")

    # (b) the vio workers against one-process runs of their blocks; the BA
    # workers against the one-process solve.
    fcfg_v, _, calib_v = multiproc.vio_configs()
    want_v = launches_per_frame(fcfg_v, tuple(reversed(calib_v.cam0.resolution)))
    t0 = time.perf_counter()
    vio = multiproc.run_tier("vio", MP_WORLD, device="cuda")
    secs_v = time.perf_counter() - t0
    gap_v = check_ranks("vio", vio, want_v, multiproc.VIO_FRAMES)
    t0 = time.perf_counter()
    ba = multiproc.run_tier("ba", MP_WORLD, device="cuda")
    secs_b = time.perf_counter() - t0
    out["vio"] = dict(ranks=vio, seconds=secs_v, max_position_gap_m=gap_v)
    out["ba"] = dict(ranks=ba, seconds=secs_b)
    print(f"[multiproc] (b) vio workers: {multiproc.VIO_LANES} lanes over {MP_WORLD} ranks x "
          f"{multiproc.VIO_FRAMES} frames at {calib_v.cam0.resolution}, launches per batched frame "
          f"{[per_frame(r['launches'], multiproc.VIO_FRAMES) for r in vio]}, largest gap to the blocks' "
          f"one-process runs {gap_v:.3g} m, total_tracks {vio[0]['total_tracks']} ({secs_v:.1f} s); ba workers: "
          f"costs {[r['costs'] for r in ba]}, gaps to the one-process solve {[r['gaps'] for r in ba]} (bar 1e-9) "
          f"({secs_b:.1f} s)")

    # (c) the bench workers (one lane a rank on the shared card) against
    # the one-process MP_WORLD-lane chunk, same reps.  No bar.
    t0 = time.perf_counter()
    bench = multiproc.run_tier("bench", MP_WORLD, 1, "cuda", tag="MULTIPROC_BENCH")
    secs_c = time.perf_counter() - t0
    one_ms = run_flagship_on(MP_WORLD, torch.device("cuda"), reps=MP_BENCH_REPS) * 1e3
    out["bench"] = dict(ranks=bench, one_process_ms=one_ms, seconds=secs_c, reps=MP_BENCH_REPS)
    print(f"[multiproc] (c) bench: {MP_WORLD} ranks x 1 lane x {bench[0]['frames']} frames on the one card: "
          f"{[round(r['step_ms'], 1) for r in bench]} ms a chunk; one process, {MP_WORLD} lanes: {one_ms:.1f} ms "
          f"a chunk ({card}; the ranks share the card: no multi-card number)")
    return out


# The phases in the order they run.  A phase's parameters name what it takes:
# ``fcfg``, ``mcfg`` and ``out_dir`` of the run, or what an earlier phase
# hands on.  A phase returns its record for chip_smoke.json, or (record,
# {name: value}) to hand values on to the phases after it.
PHASES = (
    ("device", phase_device),
    ("build", phase_build),
    ("scene", phase_scene),
    ("kernels", phase_kernels),
    ("kernels, stress inputs", phase_k3),
    ("kernels on a stack", phase_stack_kernels),
    ("main path", phase_main_path),
    ("mode sweep", phase_mode_sweep),
    ("methods", phase_methods),
    ("distinct lanes", phase_distinct_lanes),
    ("stage split", phase_stage_split),
    ("precision", phase_precision),
    ("euroc", phase_euroc),
    ("frontend paths", phase_frontend_paths),
    ("stress path", phase_stress),
    ("stress lanes", phase_stress_lanes),
    ("backend", phase_backend),
    ("multiproc", phase_multiproc),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke"),
                    help="directory for chip_smoke.json (default build/chip_smoke)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "msckf_stereo_c_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(msckf_stereo_c_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.makedirs(args.out, exist_ok=True)

    from msckf_stereo_c_torch.config import FilterConfig, FrontendConfig

    # The bench configuration (bench.py): FrontendConfig defaults with one
    # temporal level; Schur filter in f32 with 10 Newton-Schulz iterations
    # and the 'tensorfloat32' name, which the port maps to full f32.
    given = dict(fcfg=FrontendConfig(temporal_levels=1),
                 mcfg=FilterConfig(ns_iters=10, matmul_precision="tensorfloat32"), out_dir=args.out)
    records, phase_seconds = {}, {}
    t_start = time.time()
    for label, phase in PHASES:
        t0 = time.time()
        record = phase(*(given[name] for name in inspect.signature(phase).parameters))
        if isinstance(record, tuple):
            record, handed = record
            given.update(handed)
        records[label] = record
        phase_seconds[label] = time.time() - t0
        print(f"[phase] {label}: {phase_seconds[label]:.1f} s")

    rows = records["kernels"] + records["kernels, stress inputs"]
    pick = {
        "lk_corr_align": next(r for r in rows if r["name"] == "lk_corr_align" and r["level"] == 0
                              and r["N"] == 144),
        "extract_template": next(r for r in rows if r["name"] == "extract_template" and r["level"] == 0),
        "lk_corr_iterate": next(r for r in rows if r["name"] == "lk_corr_iterate" and r["N"] == 144),
        "extract_windows": next(r for r in rows if r["name"] == "extract_windows" and r["level"] == 0
                                and r["S"] == 37),
        "lk_corr_iterate_gain": next(r for r in rows if r["name"] == "lk_corr_iterate_gain" and r["N"] == 144
                                     and r["norm"] == "gain"),
        "lk_corr_align_gain": next(r for r in rows if r["name"] == "lk_corr_align_gain" and r["level"] == 0
                                   and r["N"] == 144 and r["norm"] == "gain"),
        "resample_template": next(r for r in rows if r["name"] == "resample_template"),
        "fast_grid_corners": next(r for r in rows if r["name"] == "fast_grid_corners" and r["B"] == 1),
        "qr_compress": next(r for r in rows if r["name"] == "qr_compress" and r["dtype"] == "float32"),
        "lm_triangulate": next(r for r in rows if r["name"] == "lm_triangulate" and r["dtype"] == "float32"
                               and r["B"] == 512),
    }
    # Launch counts come from the bench path, lk_corr_align_gain's from the
    # stress path (the bench path runs klt_norm='none', which never launches
    # it).  K2, K1 and K3 have no launch on either path.
    launches = dict(records["main path"]["launches"],
                    lk_corr_align_gain=records["stress path"]["launches"]["lk_corr_align_gain"])
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
        json.dump(dict(records, phase_seconds=phase_seconds, seconds=time.time() - t_start), f, indent=1)
    print(f"[done] {time.time() - t_start:.1f} s")
    device = records["device"]
    print(device["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
