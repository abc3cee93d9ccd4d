"""EuRoC VIO app on the card (port of ``apps/run_euroc.py``, the
reference's ``run_euroc_single_thread`` app,
apps/run_euroc_single_thread.cpp:116-324).

Usage:
    python -m msckf_stereo_c_torch.apps.run_euroc <path-to>/mav0 [--out pose_out.txt]
        [--chunk 128] [--device cuda|cpu] [--method qr|cholesky|schur]
        [--camchain config/camchain-imucam-euroc.yaml] [--ate]

Streams the dataset in chunks of stereo frames with their IMU batches
through ``models/vio.py:run_vio_sequence``, the state carried from chunk to
chunk; poses are written in TUM format and optionally scored against the
sequence's ground truth.  Runs on the CUDA card, and raises without one,
unless ``--device cpu`` asks for the CPU.  The image decoder in use (the
native runtime or the zlib decoder, ``io/euroc.py:ImageSource``) is printed
at the start.  ``main(argv)`` returns an ``EurocRun`` for callers in
process.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import (
    EUROC_CALIB,
    FilterConfig,
    FrontendConfig,
    load_camchain,
    load_filter_config,
    load_frontend_config,
    resolve_device,
)
from ..io import evaluate_ate, write_tum
from ..io import native
from ..io.euroc import ImageSource, load_sequence, synchronize_stereo
from ..models.vio import run_vio_sequence
from ..utils.timing import PhaseTimer


@dataclasses.dataclass
class EurocRun:
    times: np.ndarray  # (T,) epoch seconds, float64
    positions: np.ndarray  # (T, 3)
    quats_xyzw: np.ndarray  # (T, 4)
    backend: str  # the image decoder: 'native' or 'zlib'
    seconds: float  # wall time of the chunk loop
    timer: PhaseTimer
    ate: Optional[object] = None  # io.tum.AteResult with --ate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m msckf_stereo_c_torch.apps.run_euroc")
    ap.add_argument("mav0", help="path to the EuRoC sequence's mav0 directory")
    ap.add_argument("--out", default="pose_out.txt")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--method", default="schur", choices=["qr", "cholesky", "schur"])
    ap.add_argument("--camchain", default=None)
    ap.add_argument("--imgproc-config", default=None)
    ap.add_argument("--msckf-config", default=None)
    ap.add_argument("--f64", action="store_true", help="run the filter in float64")
    ap.add_argument("--ate", action="store_true", help="evaluate ATE against ground truth")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--debug-dump", default=None,
        help="write per-frame tracking counters (the reference's debug_imageprocessor.txt)",
    )
    ap.add_argument(
        "--viewer", nargs="?", const=8642, type=int, default=None, metavar="PORT",
        help="serve a live 3D trajectory view at http://localhost:PORT/ "
        "(the headless replacement for the reference's Pangolin window, "
        "run_euroc_single_thread.cpp:131-148)",
    )
    ap.add_argument(
        "--dump-filter-frame", type=int, default=None,
        help="dump the update-phase filter internals (Jacobian blocks, "
        "projected rows, gating scores) at this frame index to "
        "--dump-filter-out; the reference's frame-9 differential dump "
        "(msckf_vio.cpp:719-723)",
    )
    ap.add_argument("--dump-filter-out", default="debug_msckfvio.npz")
    ap.add_argument(
        "--cov-out", default=None,
        help="write a per-pose position-covariance sidecar "
        "(t p11 p12 p13 p22 p23 p33; the reference marshals this block "
        "then discards it, msckf_vio.cpp:1262-1293)",
    )
    return ap


def app_device(name: str) -> torch.device:
    """``--device``: 'cuda' is the card and raises without one."""
    return resolve_device(None) if name == "cuda" else torch.device(name)


def decoder_line(backend: str) -> str:
    if backend == "native":
        return "decoding PNGs with the native runtime (prefetching C++ stream)"
    return f"decoding PNGs with the zlib decoder (native runtime not built: {native.build_error()})"


def main(argv: Optional[List[str]] = None) -> EurocRun:
    args = build_parser().parse_args(argv)
    device = app_device(args.device)

    calib = load_camchain(args.camchain) if args.camchain else EUROC_CALIB
    fcfg = load_frontend_config(args.imgproc_config) if args.imgproc_config else FrontendConfig()
    # On the card the schur path defaults to the Newton-Schulz solves, as
    # the JAX app's accelerator branch does; a YAML ns_iters wins.
    base_mcfg = FilterConfig()
    if device.type == "cuda" and args.method == "schur" and not args.f64:
        base_mcfg = FilterConfig(ns_iters=10)
    mcfg = load_filter_config(args.msckf_config, base_mcfg) if args.msckf_config else base_mcfg

    print(f"loading sequence {args.mav0} ...")
    seq = load_sequence(args.mav0)
    times, files0, files1 = synchronize_stereo(seq)
    if args.max_frames:
        times, files0, files1 = times[: args.max_frames], files0[: args.max_frames], files1[: args.max_frames]
    print(f"{len(times)} stereo frames, {len(seq.imu.t)} IMU samples, on {device}")

    # Rebase timestamps to the sequence start BEFORE they are cast to the
    # filter dtype: absolute EuRoC epoch times (~1.4e9 s) have a float32
    # resolution of ~128 s, which collapses the 0.05 s frame spacing to
    # zero (no propagation, constant output).  Absolute times are restored
    # for the TUM output / ATE association below.
    t_base = float(min(times[0], seq.imu.t[0]))
    times = times - t_base
    imu_t = seq.imu.t - t_base
    filter_dtype = torch.float64 if args.f64 else torch.float32
    W, H = calib.cam0.resolution

    timer = PhaseTimer(frame_budget_s=1.0 / mcfg.frame_rate)
    t_start = time.time()
    state = None
    all_res = []

    viewer = None
    if args.viewer is not None:
        from ..io.live_viewer import LiveViewer

        viewer = LiveViewer(port=args.viewer)
        print(f"live viewer at http://localhost:{viewer.start()}/")

    # One decoder per camera stays open across the run: the native stream's
    # threads decode chunk N+1 while chunk N runs on the card, and the
    # decode phase measures the residual wait.
    c = args.chunk
    try:
        with ImageSource(files0, W, H, prefetch=max(c, 64), threads=3) as src0, \
             ImageSource(files1, W, H, prefetch=max(c, 64), threads=3) as src1:
            print(decoder_line(src0.backend))
            for s0 in range(0, len(times), c):
                s1 = min(s0 + c, len(times))
                with timer.phase("decode_images"):
                    imgs0 = src0.next(s1 - s0)
                    imgs1 = src1.next(s1 - s0)
                t_chunk = time.time()
                dump_local = None
                if args.dump_filter_frame is not None and s0 <= args.dump_filter_frame < s1:
                    dump_local = args.dump_filter_frame - s0
                with timer.phase("vio_chunk", sync=device):
                    r = run_vio_sequence(
                        fcfg, mcfg, calib,
                        times[s0:s1], imgs0, imgs1,
                        imu_t, seq.imu.gyro, seq.imu.acc,
                        filter_dtype=filter_dtype,
                        method=args.method,
                        state=state,
                        internals_at=dump_local,
                        prev_frame_t=float(times[s0 - 1]) if s0 > 0 else None,
                        device=device,
                    )
                if r.internals is not None:
                    np.savez_compressed(args.dump_filter_out, **r.internals)
                    print(f"wrote filter internals for frame {args.dump_filter_frame} -> {args.dump_filter_out}")
                # Budget check at chunk granularity (mean frame time over the
                # chunk; the first chunk absorbs the warm-up).
                timer.frame_done((time.time() - t_chunk) / (s1 - s0))
                state = r.final_state
                all_res.append(r)
                if viewer is not None:
                    viewer.publish(r.positions, frame=s1)
                el = time.time() - t_start
                print(f"  frames {s1}/{len(times)}  ({s1 / el:.1f} fps cumulative)")
            backend = src0.backend
    finally:
        if viewer is not None:
            viewer.stop()
    loop_seconds = time.time() - t_start

    # float64 BEFORE re-adding the epoch base (a float32 time plus a large
    # float would collapse the spacing again).
    times_out = np.concatenate([r.times for r in all_res]).astype(np.float64) + t_base
    pos = np.concatenate([r.positions for r in all_res])
    quat = np.concatenate([r.quats_xyzw for r in all_res])
    write_tum(args.out, times_out, pos, quat)
    if args.debug_dump:
        # TrackingInfo counters per frame (reference image_processor.cpp:1174-1179).
        with open(args.debug_dump, "w") as f:
            f.write("# time before_tracking after_tracking after_matching after_ransac\n")
            bt, at, am, ar = (
                np.concatenate([r.tracking[k] for r in all_res])
                for k in ("before_tracking", "after_tracking", "after_matching", "after_ransac")
            )
            for i in range(len(times_out)):
                f.write(f"{times_out[i]:.6f} {bt[i]} {at[i]} {am[i]} {ar[i]}\n")
    if args.cov_out:
        cov = np.concatenate([r.pos_cov for r in all_res])  # (T, 3, 3)
        with open(args.cov_out, "w") as f:
            f.write("# time p11 p12 p13 p22 p23 p33\n")
            for i in range(len(times_out)):
                c_ = cov[i]
                f.write(
                    f"{times_out[i]:.6f} {c_[0,0]:.9e} {c_[0,1]:.9e} {c_[0,2]:.9e} "
                    f"{c_[1,1]:.9e} {c_[1,2]:.9e} {c_[2,2]:.9e}\n"
                )
    wall = time.time() - t_start
    print(f"wrote {args.out}; {len(times)} frames in {wall:.1f}s = {len(times) / wall:.1f} fps")
    print(timer.report())
    if timer.overruns:
        # The reference prints its overrun report in red ANSI (msckf_vio.cpp:363-372).
        print(
            f"\x1b[31m{timer.overruns} chunk(s) exceeded the "
            f"{1.0 / mcfg.frame_rate * 1e3:.0f} ms/frame budget\x1b[0m"
        )

    ate = None
    if args.ate and seq.gt is not None:
        ate = evaluate_ate(times_out, pos, seq.gt.t, seq.gt.p)
        print(
            f"ATE RMSE {ate.rmse:.6f} m  mean {ate.mean:.4f}  median {ate.median:.4f} "
            f"std {ate.std:.4f}  min {ate.min:.4f}  max {ate.max:.4f}  pairs {ate.num_pairs}"
        )
    return EurocRun(times=times_out, positions=pos, quats_xyzw=quat, backend=backend,
                    seconds=loop_seconds, timer=timer, ate=ate)


if __name__ == "__main__":
    main()
