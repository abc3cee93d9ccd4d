"""The multi-session alignment sweep over several prior-noise draws: the
port's sweep against JAX's way of scoring it.

    python -m msckf_stereo_c_torch.scripts.alignment_sweep_study [--duration 12] [--draws 8] [--device cpu]

Computes the gate's two sessions once (``multisession_gate.compute_sessions``,
or the gate's session cache when it holds them), then for each prior draw
(seeds 0 ... draws-1 at the gate's default 10 deg / 0.75 m noise) runs the
alignment and joint-graph tiers (``align_and_solve``) four ways: the
port's sweep (candidates scored after the full radius schedule) on the
gate's grid (JAX's half-ranges widened to 3 sigma of the prior) and on
JAX's grid, and JAX's scoring (after the first three radii, the polish
from the winner as in JAX) on both grids.  Prints one JSON line per draw
and way, then a summary line: how many draws reach a joint ATE under
0.13 m each way.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import resolve_device
from ..parallel import multisession
from . import multisession_gate as gate

JAX_GRID = dict(yaw_sweep_deg=multisession.YAW_SWEEP_DEG, dz_sweep_m=multisession.DZ_SWEEP_M,
                xy_sweep_m=multisession.XY_SWEEP_M)


def jax_scored_alignment(lms_a, lms_b_in_a, radius_schedule=(3.0, 1.5, 0.8, 0.4), min_matches=12,
                         yaw_sweep_deg=multisession.YAW_SWEEP_DEG, yaw_step_deg=multisession.YAW_STEP_DEG,
                         dz_sweep_m=multisession.DZ_SWEEP_M, xy_sweep_m=multisession.XY_SWEEP_M, device=None):
    """``multisession.refine_alignment`` with JAX's candidate score: match
    count, then -rms, after the first three radii; then JAX's polish from
    the winner."""
    device = resolve_device(device)
    g = multisession._grid
    grid = np.stack([x.reshape(-1) for x in np.meshgrid(
        np.deg2rad(g(yaw_sweep_deg, yaw_step_deg)), g(xy_sweep_m, multisession.XY_STEP_M),
        g(xy_sweep_m, multisession.XY_STEP_M), g(dz_sweep_m, multisession.DZ_STEP_M), indexing="ij")], axis=1)
    a = torch.as_tensor(np.asarray(lms_a, np.float64), device=device)
    b = torch.as_tensor(np.asarray(lms_b_in_a, np.float64), device=device)
    cB = b.mean(dim=0)
    c, s = np.cos(grid[:, 0]), np.sin(grid[:, 0])
    z, o = np.zeros_like(c), np.ones_like(c)
    Rz = torch.as_tensor(np.stack([c, -s, z, s, c, z, z, z, o], 1).reshape(-1, 3, 3), device=device)
    t0 = cB - (Rz @ cB) + torch.as_tensor(grid[:, 1:], device=device)
    step = max(1, (1 << 26) // max(1, a.shape[0] * b.shape[0]))
    best = None
    for s0 in range(0, len(grid), step):
        cur0 = b @ Rz[s0:s0 + step].transpose(1, 2) + t0[s0:s0 + step, None]
        R1, t1, _, keep, rms, _ = multisession._icp_batch(a, cur0, radius_schedule[:3], min_matches)
        n = keep.sum(dim=1)
        r = torch.where(n == n.max(), rms, float("inf"))
        k = int(torch.argmax(((n == n.max()) & (r == r.min())).to(torch.int8)))
        score = (int(n[k]), -float(rms[k]))
        if best is None or score > best[0]:
            best = (score, R1[k] @ Rz[s0 + k], R1[k] @ t0[s0 + k] + t1[k])
    _, R_acc, t_acc = best
    R2, t2, nn_ab, keep, *_ = multisession._icp_batch(a, (b @ R_acc.T + t_acc)[None], radius_schedule, min_matches)
    ia, ib = multisession._matches(nn_ab[0], keep[0])
    return (R2[0] @ R_acc).cpu().numpy(), (R2[0] @ t_acc + t2[0]).cpu().numpy(), ia, ib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=12.0, help="session length in s (default 12)")
    ap.add_argument("--draws", type=int, default=8, help="prior-noise draws, seeds 0 ... draws-1 (default 8)")
    ap.add_argument("--device", default=None, help="'cpu' for the CPU; the CUDA card by default")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    path = gate._cache_path(dict(duration=args.duration, seed=0, keyframe_stride=5, chunk=64, device=device.type))
    sess = gate._read_cache(path)
    if sess is None:
        sess = gate.compute_sessions(duration=args.duration, device=device)
        gate._write_cache(path, sess)
    ways = {
        "port_sweep_gate_grid": (multisession.refine_alignment, None),
        "port_sweep_jax_grid": (multisession.refine_alignment, JAX_GRID),
        "jax_scoring_gate_grid": (jax_scored_alignment, None),
        "jax_scoring_jax_grid": (jax_scored_alignment, JAX_GRID),
    }
    passed = dict.fromkeys(ways, 0)
    for seed in range(args.draws):
        for way, (fn, sweep) in ways.items():
            gate.refine_alignment = fn
            try:
                t0 = time.perf_counter()
                out = gate.align_and_solve(sess, seed=seed, sweep=sweep, device=device, verbose=False)
            finally:
                gate.refine_alignment = multisession.refine_alignment
            passed[way] += out["joint_ate_after_graph"] < 0.13
            print(json.dumps({"draw": seed, "way": way, "seconds": time.perf_counter() - t0,
                              **{k: out[k] for k in ("joint_ate_prior", "joint_ate_global_align",
                                                     "joint_ate_after_graph", "landmark_matches", "inter_edges",
                                                     "sweep")}}), flush=True)
    line = {"duration_s": args.duration, "draws": args.draws, "device": str(device),
            "under_0.13_m": passed}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
