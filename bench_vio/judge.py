"""What decides ``correct``: the program's outputs held against the frozen
reference (``bench_vio/reference/``), run after the window has closed and
the program's state is freed.

The reference follows the program step by step from the program's own
state, over every lane in the program's batch shape: for each checked
frame it takes the state before the step (tracks, carried templates,
filter state) and works out again what the program derived from the
inputs: the previous frame's pyramids from that frame's images, the IMU
batches from each lane's raw IMU stream, the calibration, configuration
and parameters from the configuration's files.  It then runs the two
stages of the step apart:

- the tracker, in float32 with every hand kernel's plain PyTorch version
  and TF32 off, on the frame's images; compared with the program's
  published tracks (``tracks_moved``: the share, over every checked
  lane-frame, of the track slots either side publishes whose id,
  validity or normalised observation (by more than ``MOVED``) differ;
  ``track_mismatch``: the largest share of one lane-frame's slots whose
  id or validity differ; ``uv_gap``: the widest gap of an observation
  both publish under one id);
- the filter, in float64 and by the textbook update (``REFERENCE_METHOD``:
  each track's rows projected onto the left null space of its feature
  Jacobian and compressed by a dense QR, where the program marginalises
  the features by its Schur algebra and Newton-Schulz solves), on the
  program's published tracks; compared with the program's pose and
  covariance, lane by lane: ``pose_gap`` (m), ``att_gap`` (quaternion) and
  ``cov_gap`` (the covariance's widest gap over the reference's largest
  entry), each as its widest and its 90th percentile (``_p90``) over the
  checked lane-frames.  The percentile is steady where a lane's gating or
  pruning decision sits on its threshold, which swings the widest gap.

The start is checked by itself, in float32: the state after set-up's
initialisation against the reference's (``init_gap``, exact).  Also read:
``nonfinite``, the window's lane-frames whose pose is not finite, and
``ate_p99``, the 99th percentile over the lanes of each lane's ATE RMSE
(its worst sequence run) against the ground truth; that one is printed
and held to no limit, since it compares with no reference."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .harness import REPO, Run, tree_leaves, tree_map

MOVED = 1e-6  # normalised units, about 0.0005 px: well past float32 rounding of an observation
REFERENCE_METHOD = "qr"


def _rebuild(template, leaves: list):
    """``template``'s tree with its tensors replaced, in order, by ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("the program's state has more tensors than the reference's")
    return out


def reference_configs(config: dict):
    from .reference.config import FilterConfig, FrontendConfig, load_camchain, load_filter_config

    calib = load_camchain(str(REPO / config["calib"]["camchain"]))
    fcfg = FrontendConfig(**config["frontend"], distortion_model0=calib.cam0.distortion_model,
                          distortion_model1=calib.cam1.distortion_model)
    mcfg = load_filter_config(str(REPO / config["calib"]["filter"]), FilterConfig(**config["filter"]))
    return calib, fcfg, mcfg, config["method"]


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest gap between ``a`` and ``b``; NaN where either is not
    finite (a diverged lane fails the comparison by itself)."""
    if not a.numel():
        return 0.0
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        return float("nan")
    return float((a.double() - b.double()).abs().max())


def _worst(a: float, b: float) -> float:
    """The larger of two readings, NaN if either is NaN."""
    return float("nan") if a != a or b != b else max(a, b)


def _spread(name: str, per_lane: list) -> dict:
    """``name``: the widest of the per-lane gaps (NaN if any is NaN), and
    ``name_p90``: their 90th percentile, a NaN counted as infinite."""
    v = torch.cat(per_lane).cpu().numpy() if per_lane else np.zeros(1)
    finite = np.where(np.isnan(v), np.inf, v)
    return {name: float(v.max()) if np.isfinite(finite).all() else float("nan"),
            f"{name}_p90": float(np.quantile(finite, 0.9))}


def measure(run: Run, config: dict, method: str = REFERENCE_METHOD) -> dict:
    """Every number the judge can compare, by name."""
    from .reference.config import matmul_precision_scope
    from .reference.models import frontend as rf
    from .reference.models import msckf as rm
    from .reference.models import runner as rr
    from .reference.models import vio as rv

    dev = run.device
    f32, f64 = torch.float32, torch.float64
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        calib, fcfg, mcfg, _ = reference_configs(config)
        fparams = rf.make_frontend_params(calib, f32, dev)
        mparams = rm.make_params(mcfg, calib, f64, dev)
        inp = run.inputs
        B = run.window.lanes
        H, W = inp.img0.shape[-2:]
        fields = torch.as_tensor(inp.lane_field, device=dev)

        template = rv.init_vio_state(fcfg, mcfg, calib, (H, W), f32, f32, dev)._replace(pyr0_prev=())
        template = tree_map(lambda x: x.expand(B, *x.shape).clone(), template)

        # The start: initial state and gravity from each lane's raw IMU.
        n0 = mcfg.imu_init_samples
        ref_init = template._replace(filt=rr.batched_apply_gravity_init(
            template.filt, inp.gyro[:, :n0], inp.acc[:, :n0]))
        init_gap = 0.0
        for a, b in zip(tree_leaves(run.init), tree_leaves(ref_init)):
            if a.is_floating_point():
                init_gap = _worst(init_gap, _gap(a.to(dev), b))

        packed = [rr.pack_imu_batches(inp.imu_t, inp.gyro[b], inp.acc[b], inp.frame_t, mcfg.max_imu_per_frame,
                                      np.float64) for b in range(B)]
        imu_lanes = type(packed[0])(*(torch.stack(x).to(dev) for x in zip(*packed)))

        def images(k, cam):
            stack = (inp.img0, inp.img1)[cam]
            if B == 1:
                return stack[0, k]
            return stack[:, k].index_select(0, fields)

        def wide(x):
            return x.to(f64) if x.is_floating_point() else x

        mismatch = uv_gap = 0.0
        moved = published = 0
        pose_gaps, att_gaps, cov_gaps = [], [], []
        for c in run.checks:
            state = _rebuild(template, [x.to(dev) for x in tree_leaves(c.before)])
            prev = images(c.k - 1, 0) if c.k > 0 else torch.zeros((H, W), dtype=f32, device=dev)
            with matmul_precision_scope(fcfg.matmul_precision):
                state = state._replace(pyr0_prev=rv.lane_pyramids(prev, B, fcfg))
            time_k = torch.full((B,), float(inp.frame_t[c.k]), dtype=f64, device=dev)
            imu = tree_map(lambda x: x[:, c.k], imu_lanes)
            _, out, _, _ = rv._run_frontend(state, images(c.k, 0), images(c.k, 1), time_k.to(f32),
                                            tree_map(lambda x: x.to(f32) if x.is_floating_point() else x, imu),
                                            fparams, fcfg)
            p_out = tree_map(lambda x: x.to(dev), c.out)
            differ = (out.fid != p_out.fid) | (out.valid != p_out.valid)
            mismatch = _worst(mismatch, float(differ.double().mean(-1).max()))
            both = out.valid & p_out.valid & (out.fid == p_out.fid)
            per_slot = (out.uv.double() - p_out.uv.double()).abs().amax(-1)
            if bool(both.any()):
                uv_gap = _worst(uv_gap, _gap(out.uv[both], p_out.uv[both]))
            either = out.valid | p_out.valid
            moved += int((either & (differ | (per_slot > MOVED) | ~torch.isfinite(per_slot))).sum())
            published += int(either.sum())

            frame = rm.FrameFeatures(time=time_k, fid=p_out.fid, uv=p_out.uv.to(f64), valid=p_out.valid,
                                     quality=p_out.quality.to(f64))
            filt, pose = rm.batched_filter_step(tree_map(wide, state.filt), frame, imu, mparams, mcfg, method=method)
            p_pose = tree_map(lambda x: x.to(dev).double(), c.pose)
            pose_gaps.append((pose.p - p_pose.p).abs().amax(-1))
            q, pq = pose.q_xyzw, p_pose.q_xyzw
            att_gaps.append(torch.minimum((q - pq).abs().amax(-1), (q + pq).abs().amax(-1)))
            scale = filt.P.abs().amax((-2, -1)).clamp_min(1e-30)
            cov_gaps.append((c.P.to(dev).double() - filt.P).abs().amax((-2, -1)) / scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ate_p99 = float(np.percentile(run.ates.max(axis=0), 99)) if run.ates.size else float("inf")
    return dict(tracks_moved=moved / max(published, 1), track_mismatch=mismatch, uv_gap=uv_gap,
                **_spread("pose_gap", pose_gaps), **_spread("att_gap", att_gaps), **_spread("cov_gap", cov_gaps),
                init_gap=init_gap, nonfinite=float(run.failed), ate_p99=ate_p99)


def judge(values: dict, cell: dict) -> List[Tuple[str, float, float]]:
    """(name, value, limit) of every number the cell compares (its
    ``limits``); the run is correct when each value is finite and at most
    its limit."""
    return [(name, float(values[name]), float(limit)) for name, limit in cell["limits"].items()]


def is_correct(numbers) -> bool:
    return all(np.isfinite(v) and v <= lim for _, v, lim in numbers)
