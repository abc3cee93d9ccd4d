#!/usr/bin/env python
"""ATE of the JAX package on the CPU for front-end configurations that
``chip_smoke.py``'s ``[frontend-paths]`` phase runs on the card, on the same
scenes, so the port's card numbers have a reference beside them.

    JAX_PLATFORMS=cpu python scripts/reference_tracker_cpu_ate.py [--frames 60] [--config reference_tracker]

Configs: ``reference_tracker`` (the reference's own tracker on bench.py's
scene: four pyramid levels for temporal and stereo LK, rotation-only
prediction, no template carry, anchor or left-right check, raw-pixel FAST
threshold 10, no candidate budget, RANSAC on), ``fastmotion_tl2`` and
``fastmotion_tl4`` (tests/test_fast_motion.py's scene under the
FrontendConfig defaults with 2 or 4 temporal levels).  The filter is the
bench's (Schur, float32, 10 Newton-Schulz iterations).  Prints one JSON
line per config.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_TRACKER = dict(
    pyramid_levels=4, temporal_levels=4, stereo_levels=4, tmpl_carry=False, anchor_refine=False,
    translation_seed=False, stereo_lr_threshold=0.0, presmooth=False, fast_threshold=10, cand_budget=0,
    ransac_enabled=True,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60, help="bench-scene frames (reference_tracker)")
    ap.add_argument("--config", action="append", help="config name; repeat for several (default: all)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from msckf_stereo_c_tpu.config import EUROC_CALIB, FilterConfig, FrontendConfig
    from msckf_stereo_c_tpu.io import evaluate_ate
    from msckf_stereo_c_tpu.models.vio import run_vio_sequence
    from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from msckf_stereo_c_tpu.sim.render import render_stereo_sequence

    def bench_scene(n):
        traj = make_circle_trajectory(duration=max(4.0, n * 0.05 + 2.0))
        lms = make_wall_landmarks(num=600, radius=8.0, seed=1)
        return traj, lms, np.arange(0, traj.t.shape[0], 10)[:n]

    def fastmotion_scene():
        traj = make_circle_trajectory(duration=6.0, omega=2.0 * np.pi / 8.0, roll_amp=0.25, t_static=1.5,
                                      t_ramp=1.0)
        lms = make_wall_landmarks(num=500, radius=8.0, seed=1)
        return traj, lms, np.arange(0, traj.t.shape[0], 10)

    configs = {
        "reference_tracker": (lambda: bench_scene(args.frames), REFERENCE_TRACKER),
        "fastmotion_tl2": (fastmotion_scene, dict(temporal_levels=2)),
        "fastmotion_tl4": (fastmotion_scene, dict(temporal_levels=4)),
    }
    mcfg = FilterConfig(ns_iters=10, matmul_precision="tensorfloat32")
    for name in args.config or list(configs):
        make_scene, kw = configs[name]
        traj, lms, idx = make_scene()
        imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
        img0, img1 = render_stereo_sequence(traj, lms, idx, r_wall=8.0)
        t0 = time.time()
        res = run_vio_sequence(FrontendConfig(**kw), mcfg, EUROC_CALIB, traj.t[idx], img0, img1, imu.t, imu.gyro,
                               imu.acc, image_dtype=jnp.float32, filter_dtype=jnp.float32, method="schur")
        ate = evaluate_ate(res.times, res.positions, traj.t[idx], traj.p[idx])
        tr = res.tracking
        print(json.dumps(dict(
            config=name, frames=int(len(idx)), ate_rmse_m=float(ate.rmse), platform="cpu (JAX)",
            min_tracks_last20=int(tr["after_ransac"][-20:].min()),
            frames_matching_above_published=int(np.sum(tr["after_matching"] > tr["after_ransac"])),
            seconds=time.time() - t0,
        )), flush=True)


if __name__ == "__main__":
    main()
