"""Weak scaling of the sharded multi-sequence runners (port of
``scripts/bench_scaling.py``).

    python -m msckf_stereo_c_torch.scripts.bench_scaling [--flagship | --processes P] [--device cpu]

Without a flag: the filter-only runner (``parallel/multiseq.py:
make_sharded_runner``) on random feature tracks, B = n lanes for n = 1, 2,
4, 8, in one process on one device.  ``--flagship``: the full pipeline
(``parallel/vio_multiseq.py:make_sharded_vio_runner``) in bench.py's
configuration, 752x480, T = M+2 frames, one lane per n.  ``--processes P``:
P ``bench`` workers (``parallel/multiproc.py``), ``SCALE_DEVICES_PER_PROC``
lanes each (default 1), and their ``MULTIPROC_BENCH`` lines.  On the CUDA
card unless ``--device cpu``.

The efficiency printed is t(1) / t(n) at the same work per lane.  In one
process every n runs on the one device as one batched step, and the ranks
of ``--processes`` share the card when there are fewer cards than ranks,
so on one card these numbers are batching on one chip, not a multi-card
scaling measurement; that needs a card per rank (``nccl``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import EUROC_CALIB, FilterConfig, resolve_device
from ..models.msckf import FrameFeatures, make_params
from ..models.propagation import ImuBatch
from ..parallel import multiproc
from ..parallel.multiseq import batched_init_state, make_sharded_runner

CFG = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=10)
T, F = 20, 32
NOTE = "one device: the lanes are batched on it, so this is no multi-card scaling number"


def make_batch(B: int, rng, device):
    """B filter-only sequences of random tracks: states, frames (B, T, F)
    and IMU batches (B, T, L), float32."""
    L, dt = CFG.max_imu_per_frame, torch.float32

    def t(x, d=dt):
        return torch.as_tensor(np.asarray(x), dtype=d, device=device)

    frames = FrameFeatures(
        time=t(np.tile(np.arange(1, T + 1) * 0.05, (B, 1))),
        fid=t(np.tile(np.arange(F), (B, T, 1)), torch.int32),
        uv=t(rng.uniform(-0.3, 0.3, (B, T, F, 4))),
        valid=t(np.ones((B, T, F), bool), torch.bool),
    )
    imu_t = np.tile(np.linspace(0.005, 0.05, L), (B, T, 1)) + np.arange(T)[None, :, None] * 0.05
    imu = ImuBatch(
        time=t(imu_t),
        gyro=t(rng.normal(0, 0.01, (B, T, L, 3))),
        acc=t(np.tile([0, 0, 9.81], (B, T, L, 1)) + rng.normal(0, 0.01, (B, T, L, 3))),
        valid=t(np.ones((B, T, L), bool), torch.bool),
    )
    return batched_init_state(CFG, EUROC_CALIB, B, dt, device), frames, imu


def run_on(B: int, device, reps: int = 3) -> float:
    """Seconds a chunk of the filter-only runner over B lanes, after one
    warm-up chunk, the device synchronised."""
    run = make_sharded_runner(make_params(CFG, EUROC_CALIB, torch.float32, device), CFG, method="schur")
    states, frames, imu = make_batch(B, np.random.default_rng(0), device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    run(states, frames, imu)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        run(states, frames, imu)
    sync()
    return (time.perf_counter() - t0) / reps


def run_flagship_on(B: int, device, reps: int = 2) -> float:
    """Seconds a chunk of the flagship pipeline over B lanes (T = M+2
    frames), timed as the ``bench`` workers time it
    (``multiproc.run_dryrun``)."""
    return multiproc.run_dryrun(range(B), device, time_reps=reps).step_ms / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flagship", action="store_true", help="the full pipeline instead of the filter")
    ap.add_argument("--processes", type=int, default=0, help="P bench workers across OS processes")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU; the card otherwise")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.processes:
        D = int(os.environ.get("SCALE_DEVICES_PER_PROC", "1"))
        reports = multiproc.run_tier("bench", args.processes, D, device, tag="MULTIPROC_BENCH")
        shared = device.type == "cpu" or args.processes > torch.cuda.device_count()
        for r in reports:
            print(f"MULTIPROC_BENCH process={r['process']} step_ms={r['step_ms']:.1f} lanes={r['lanes']} "
                  f"frames={r['frames']} device={r['device']} backend={r['backend']}"
                  + (f"  ({r['world']} ranks share {r['device'].split(':')[0]}: not a multi-card number)"
                     if shared else ""))
        return 0
    fn = run_flagship_on if args.flagship else run_on
    results = {}
    for n in (1, 2, 4, 8):
        results[n] = fn(n, device)
        print(f"{'flagship ' if args.flagship else ''}lanes={n}  B={n}  time={results[n] * 1e3:8.1f} ms  "
              f"weak-scaling eff={results[1] / results[n]:6.1%}  ({NOTE})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
