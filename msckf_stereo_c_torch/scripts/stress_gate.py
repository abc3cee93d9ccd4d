"""The multi-seed stress gate on the port (port of ``scripts/stress_gate.py``).

    python -m msckf_stereo_c_torch.scripts.stress_gate

Runs the V1_01-realistic stress scene (130 s by default: aggressive 6-dof
motion, texture-poor windows, an occluder sweep, exposure drift) end to end
(render on the device -> frontend kernels -> MSCKF) on the CUDA card, in
float32 with the Schur filter and 10 Newton-Schulz iterations by default.
``STRESS_SEEDS=N`` runs seeds ``STRESS_SEED`` ... ``+ N - 1``, each with its
own IMU noise, photometric draws and landmark field, as the N lanes of one
batched run, prints one JSON line per seed, and judges the gate on the
WORST seed against 0.13 m.  The last line is the JAX script's JSON line,
with the aggregate frames/s and the peak device memory added.

Knobs (environment): STRESS_DURATION, STRESS_CHUNK, STRESS_METHOD,
STRESS_NS_ITERS, STRESS_FILTER_PRECISION, STRESS_FRONTEND_PRECISION,
STRESS_SEED, STRESS_SEEDS, STRESS_GENERATOR, STRESS_NOISE_ADAPTIVE,
STRESS_NOISE_REF, STRESS_NOISE_CAP, STRESS_CAND_LEVEL1, STRESS_PRESMOOTH,
STRESS_FAST_THR, STRESS_KLT_NORM, the photometric channels
(STRESS_SENSOR_NOISE, STRESS_MOTION_BLUR, STRESS_VIGNETTE,
STRESS_NOISE_READ, STRESS_NOISE_SHOT, STRESS_TEX_POOR, STRESS_BLOB_POOR),
STRESS_PLATFORM (``cpu`` selects the CPU; the card otherwise) and
STRESS_REFINE=1 (or ``--refine``): the worst seed's run through the
keyframe-BA refinement tier (``parallel/refine.py``, keyframes every
STRESS_REFINE_STRIDE frames, at most STRESS_REFINE_KF of them, 8
Gauss-Newton steps in float64 on the run's device), its keyframe ATE
before and after added to the last line with the JAX script's keys.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Mapping, Optional

import numpy as np

GATE_M = 0.13


@dataclasses.dataclass(frozen=True)
class StressKnobs:
    duration: float
    chunk: int
    method: str
    seeds: tuple
    generator: str
    fcfg: object  # FrontendConfig
    mcfg: object  # FilterConfig
    events_kwargs: dict
    device: Optional[str]  # None = the CUDA card
    refine: bool = False  # the keyframe-BA refinement tier on the worst seed
    refine_stride: int = 5
    refine_kf: int = 60


def stress_knobs(env: Mapping[str, str] = os.environ, argv=()) -> StressKnobs:
    """The run the JAX script builds from ``env``: the same configurations,
    seeds, photometric knobs and refinement tier."""
    from ..config import FilterConfig, FrontendConfig

    mcfg = FilterConfig(
        ns_iters=int(env.get("STRESS_NS_ITERS", "10")),
        matmul_precision=env.get("STRESS_FILTER_PRECISION", "tensorfloat32"),
        noise_adaptive=env.get("STRESS_NOISE_ADAPTIVE", str(int(FilterConfig.noise_adaptive))) == "1",
        noise_snr_ref=float(env.get("STRESS_NOISE_REF", FilterConfig.noise_snr_ref)),
        noise_inflation_cap=float(env.get("STRESS_NOISE_CAP", FilterConfig.noise_inflation_cap)),
    )
    fcfg = FrontendConfig(
        matmul_precision=env.get("STRESS_FRONTEND_PRECISION", FrontendConfig.matmul_precision),
        cand_level1=env.get("STRESS_CAND_LEVEL1", str(int(FrontendConfig.cand_level1))) == "1",
        presmooth=env.get("STRESS_PRESMOOTH", str(int(FrontendConfig.presmooth))) == "1",
        fast_threshold=int(env.get("STRESS_FAST_THR", FrontendConfig.fast_threshold)),
        klt_norm=env.get("STRESS_KLT_NORM", FrontendConfig.klt_norm),
    )
    # Photometric-channel knobs (defaults follow make_stress_events).
    events_kwargs = {}
    for knob, key, parse in [
        ("STRESS_SENSOR_NOISE", "sensor_noise", lambda v: v == "1"),
        ("STRESS_MOTION_BLUR", "motion_blur", lambda v: v == "1"),
        ("STRESS_VIGNETTE", "vignette", float),
        ("STRESS_NOISE_READ", "noise_read_dn", float),
        ("STRESS_NOISE_SHOT", "noise_shot_gain", float),
        ("STRESS_TEX_POOR", "tex_poor_depth", float),
        ("STRESS_BLOB_POOR", "blob_poor_depth", float),
    ]:
        if knob in env:
            events_kwargs[key] = parse(env[knob])
    generator = env.get("STRESS_GENERATOR", "stress")
    # The fast-motion family pairs with the milder texture dips by default;
    # explicit knobs still win.
    if env.get("STRESS_GENERATOR") == "fastmotion":
        events_kwargs.setdefault("tex_poor_depth", 0.5)
        events_kwargs.setdefault("blob_poor_depth", 0.4)
    seed0 = int(env.get("STRESS_SEED", "0"))
    return StressKnobs(
        duration=float(env.get("STRESS_DURATION", "130")),
        chunk=int(env.get("STRESS_CHUNK", "64")),
        method=env.get("STRESS_METHOD", "schur"),
        seeds=tuple(range(seed0, seed0 + int(env.get("STRESS_SEEDS", "1")))),
        generator=generator,
        fcfg=fcfg,
        mcfg=mcfg,
        events_kwargs=events_kwargs,
        device="cpu" if env.get("STRESS_PLATFORM") == "cpu" else None,
        refine=env.get("STRESS_REFINE", "0") == "1" or "--refine" in argv,
        refine_stride=int(env.get("STRESS_REFINE_STRIDE", "5")),
        refine_kf=int(env.get("STRESS_REFINE_KF", "60")),
    )


def refine_stats(run, stride: int = 5, max_keyframes: int = 60, device=None) -> dict:
    """The refinement tier on one stress run (a ``StressGateResult``): its
    keyframe BA problem (``build_ba_problem``), 8 Gauss-Newton steps on
    ``device`` (the CUDA card when None), and the keyframe ATE before and
    after, both through the same Horn alignment (BA fixes the first
    keyframe, so it can only reduce relative inconsistency).  The JAX
    script's keys."""
    from ..config import EUROC_CALIB
    from ..io.tum import evaluate_ate
    from ..parallel.refine import build_ba_problem, problem_to_body_poses, refine_trajectory

    res = run.result
    prob = build_ba_problem(res.times, res.quats_xyzw, res.positions, res.fid, res.uv, res.valid,
                            calib=EUROC_CALIB, keyframe_stride=stride, max_keyframes=max_keyframes,
                            device=device)
    if prob is None:
        return {"refine": "skipped (too few tracks/keyframes)"}
    kf = np.arange(0, len(res.times), stride)[: prob.cam_q.shape[0]]
    kf_t = res.times[kf]
    gt_at_kf = run.gt_p[np.searchsorted(run.gt_t, kf_t).clip(0, len(run.gt_t) - 1)]
    before = evaluate_ate(kf_t, problem_to_body_poses(prob), kf_t, gt_at_kf)
    refined, costs = refine_trajectory(prob, iters=8)
    after = evaluate_ate(kf_t, problem_to_body_poses(refined), kf_t, gt_at_kf)
    costs = costs.cpu().numpy()
    return {
        "refine_keyframes": int(prob.cam_q.shape[0]),
        "refine_landmarks": int(prob.landmarks.shape[0]),
        "refine_cost_drop": float(costs[0] / max(float(costs[-1]), 1e-30)),
        "ate_kf_before": float(before.rmse),
        "ate_kf_after": float(after.rmse),
    }


def main(env: Mapping[str, str] = os.environ, argv=None) -> dict:
    import torch

    from ..config import resolve_device
    from ..sim.stress import run_stress_lanes

    knobs = stress_knobs(env, sys.argv[1:] if argv is None else argv)
    device = resolve_device(knobs.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    runs = run_stress_lanes(
        knobs.seeds, duration=knobs.duration, generator=knobs.generator, chunk=knobs.chunk,
        fcfg=knobs.fcfg, mcfg=knobs.mcfg, filter_dtype=torch.float32, method=knobs.method,
        events_kwargs=knobs.events_kwargs, device=device,
    )
    if on_card:
        torch.cuda.synchronize()
    wall = time.time() - t0
    n = len(runs)
    if n > 1:
        for seed, out in zip(knobs.seeds, runs):
            print(json.dumps({"seed": seed, "ate_rmse": out.ate_rmse, "ate_max": out.ate_max,
                              "min_tracks": out.min_tracks_after_ransac}), flush=True)
    ates = np.array([r.ate_rmse for r in runs])
    worst = runs[int(np.argmax(ates))]
    line = {
        "metric": "stress_ate_rmse_worst" if n > 1 else "stress_ate_rmse",
        "value": float(ates.max()),
        "unit": "m",
        "gate": GATE_M,
        "margin_pct": round(100.0 * (1.0 - float(ates.max()) / GATE_M), 1),
        "ate_median": float(np.median(ates)),
        "ate_mean": worst.ate_mean,
        "ate_max": worst.ate_max,
        "n_seeds": n,
        "duration_s": worst.duration,
        "frames": worst.n_frames,
        "min_tracks": int(min(r.min_tracks_after_ransac for r in runs)),
        "generator": knobs.generator,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "wall_s": wall,
        "frames_per_s": n * worst.n_frames / wall,
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
    }
    if knobs.refine:
        line.update(refine_stats(worst, knobs.refine_stride, knobs.refine_kf, device))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
