"""Batched multi-sequence EuRoC evaluation on one card (port of
``apps/run_euroc_batch.py``): several sequences stepped together as the
lanes of one batched state (BASELINE.json config 3, "MH_01-MH_05
machine-hall batch ... on one chip").

Usage:
    python -m msckf_stereo_c_torch.apps.run_euroc_batch <seqA>/mav0 <seqB>/mav0 ... \\
        [--out-dir poses/] [--chunk 64] [--ate] [--device cuda|cpu]

Each sequence is one lane with its own tracker and filter state, its own
images (B, T, H, W) and its own IMU stream, packed on its own and stacked;
every chunk of frames goes through ``parallel/vio_multiseq.py:
run_vio_batch``.  Each lane's times are rebased to its own start before the
float32 cast and restored for its TUM file.  Sequences shorter than the
longest are padded with repeats of their last frame (its IMU batch is empty
and its dt 0), and the padding is masked out of the outputs.  Runs on the
CUDA card, and raises without one, unless ``--device cpu`` asks for the
CPU.  ``main(argv)`` returns one ``LaneResult`` per sequence.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from contextlib import ExitStack
from typing import List, Optional

import numpy as np
import torch

from ..config import EUROC_CALIB, FilterConfig, FrontendConfig
from ..io import evaluate_ate, write_tum
from ..io.euroc import ImageSource, load_sequence, synchronize_stereo
from ..models.frontend import make_frontend_params
from ..models.msckf import make_params
from ..models.runner import apply_gravity_init, pack_imu_batches
from ..models.vio import init_vio_state
from ..parallel.vio_multiseq import broadcast_state, run_vio_batch
from ..utils.lanes import map_tree, stack_lanes
from .run_euroc import app_device, decoder_line


@dataclasses.dataclass
class LaneResult:
    name: str
    out: str  # the TUM file written
    times: np.ndarray  # (n,) epoch seconds, float64
    positions: np.ndarray  # (n, 3)
    quats_xyzw: np.ndarray  # (n, 4)
    ate: Optional[object] = None  # io.tum.AteResult with --ate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m msckf_stereo_c_torch.apps.run_euroc_batch")
    ap.add_argument("mav0", nargs="+")
    ap.add_argument("--out-dir", default="poses")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--method", default="schur")
    ap.add_argument("--ate", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv: Optional[List[str]] = None) -> List[LaneResult]:
    args = build_parser().parse_args(argv)
    device = app_device(args.device)

    fcfg = FrontendConfig()
    mcfg = FilterConfig()
    dtype = torch.float32
    calib = EUROC_CALIB
    W, H = calib.cam0.resolution
    fparams = make_frontend_params(calib, torch.float32, device)
    mparams = make_params(mcfg, calib, dtype, device)

    B = len(args.mav0)
    seqs = []
    for path in args.mav0:
        seq = load_sequence(path)
        times, f0, f1 = synchronize_stereo(seq)
        if args.max_frames:
            times, f0, f1 = times[: args.max_frames], f0[: args.max_frames], f1[: args.max_frames]
        seqs.append((path, seq, times, f0, f1))
    T = max(len(s[2]) for s in seqs)
    print(f"{B} sequences, padded length {T}, on {device}")

    # Per lane: the frame index k of padded step k, its own time base (the
    # epoch rebase of run_euroc), and its IMU batches packed on their own.
    pad_idx = [np.minimum(np.arange(T), len(times) - 1) for _, _, times, _, _ in seqs]
    t_base = [float(min(times[0], seq.imu.t[0])) for _, seq, times, _, _ in seqs]
    tt = np.stack([times[k] - tb for (_, _, times, _, _), k, tb in zip(seqs, pad_idx, t_base)])  # (B, T)
    imu_all = stack_lanes([
        pack_imu_batches(seq.imu.t - tb, seq.imu.gyro, seq.imu.acc, tt[b], mcfg.max_imu_per_frame, np.float32)
        for b, ((_, seq, _, _, _), tb) in enumerate(zip(seqs, t_base))
    ])

    one = init_vio_state(fcfg, mcfg, calib, (H, W), torch.float32, dtype, device)
    filts = []
    for _, seq, _, _, _ in seqs:
        n0 = min(mcfg.imu_init_samples, len(seq.imu.t))
        filts.append(apply_gravity_init(one.filt, seq.imu.gyro[:n0], seq.imu.acc[:n0]))
    bstate = broadcast_state(one, B)._replace(filt=stack_lanes(filts))

    os.makedirs(args.out_dir, exist_ok=True)
    all_p, all_q = [], []
    t_start = time.time()
    with ExitStack() as stack:
        srcs = [
            [stack.enter_context(ImageSource([files[k] for k in idx], W, H, prefetch=max(args.chunk, 64), threads=3))
             for files in (f0, f1)]
            for (_, _, _, f0, f1), idx in zip(seqs, pad_idx)
        ]
        print(decoder_line(srcs[0][0].backend))
        for s0 in range(0, T, args.chunk):
            s1 = min(s0 + args.chunk, T)
            i0 = np.stack([src[0].next(s1 - s0) for src in srcs])  # (B, n, H, W)
            i1 = np.stack([src[1].next(s1 - s0) for src in srcs])
            bstate, poses, _, _ = run_vio_batch(
                bstate, i0, i1, tt[:, s0:s1], map_tree(lambda x: x[:, s0:s1], imu_all),
                fparams, mparams, fcfg, mcfg, args.method, device=device,
            )
            all_p.append(poses.p.cpu().numpy())  # (B, n, 3)
            all_q.append(poses.q_xyzw.cpu().numpy())
            print(f"  {s1}/{T} frames x {B} seqs  ({s1 * B / (time.time() - t_start):.1f} fps aggregate)")

    results = []
    for b, (path, seq, times, _, _) in enumerate(seqs):
        n = len(times)
        p = np.concatenate([x[b] for x in all_p])[:n]
        q = np.concatenate([x[b] for x in all_q])[:n]
        name = os.path.basename(os.path.dirname(path.rstrip("/"))) or f"seq{b}"
        out = os.path.join(args.out_dir, f"pose_{name}.txt")
        write_tum(out, times, p, q)
        print(f"wrote {out}")
        ate = None
        if args.ate and seq.gt is not None:
            ate = evaluate_ate(times, p, seq.gt.t, seq.gt.p)
            print(f"  {name}: ATE RMSE {ate.rmse:.4f} m ({ate.num_pairs} pairs)")
        results.append(LaneResult(name=name, out=out, times=times, positions=p, quats_xyzw=q, ate=ate))
    return results


if __name__ == "__main__":
    main()
