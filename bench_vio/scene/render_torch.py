# Frozen copy of msckf_stereo_c_torch/sim/render_torch.py at commit 50013dad8c92; imports the frozen config and utilities.
"""Device-side stereo renderer with the stress channels (port of
``msckf_stereo_c_tpu/sim/render_jax.py``).

The same world as ``sim/render.py`` (procedural texture on a finite cylinder
and caps, full radtan lens model, Gaussian landmark blobs), rendered on the
run's device for a batch of frames at once, plus the stress channels of the
stress gate: per-frame texture and blob contrast, exposure gain and offset,
a world-space sphere occluder, 3-tap motion blur over the true trajectory,
vignetting, and read + shot sensor noise.

Where it differs from the JAX original:

* the per-pose rotations, camera origins and IMU-frame landmarks are
  computed on the host in float64, and the per-pixel and per-landmark
  rotations on the device are written out elementwise in float32, so no
  TF32 matmul can touch the geometry whatever the caller's precision flags
  (a warped render once made a phantom accuracy gap; see the notes in the
  JAX original at ``_interp_pose_taps`` and ``_raycast``);
* the blob scatter-add is ``index_put_(..., accumulate=True)``, which uses
  atomics on CUDA: the order of the adds, and so the last bits of a pixel
  where blobs overlap, changes from run to run (about 1e-5 DN);
* sensor noise comes from one ``torch.Generator`` per (noise seed, absolute
  frame index, camera) on the run's device, so chunked and one-shot renders
  draw the same noise; the draws are not JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..reference.config import EUROC_CALIB, StereoCalib, resolve_device
from ..reference.utils.lie import so3_exp, so3_log
from .render import _ray_lut, _Texture
from .trajectory import SimTrajectory


def _interp_pose_taps(
    traj: SimTrajectory, frame_indices: np.ndarray, offsets: np.ndarray, n_traj: int
):
    """(T, K, 3, 3), (T, K, 3) poses at fractional trajectory offsets:
    positions interpolated linearly, rotations geodesically (so3 log/exp
    between the bracketing samples), in float64 on the host."""
    T, K = len(frame_indices), len(offsets)
    idx = np.clip(frame_indices[:, None] + offsets[None, :], 0.0, n_traj - 1.0)
    lo = np.floor(idx).astype(np.int64)
    hi = np.minimum(lo + 1, n_traj - 1)
    a = idx - lo
    p = (1.0 - a[..., None]) * traj.p[lo] + a[..., None] * traj.p[hi]
    Rl = torch.as_tensor(traj.R_w_b[lo].reshape(-1, 3, 3), dtype=torch.float64)
    Rh = torch.as_tensor(traj.R_w_b[hi].reshape(-1, 3, 3), dtype=torch.float64)
    phi = so3_log(Rl.transpose(-1, -2) @ Rh)  # log(R_lo^T R_hi)
    Rt = Rl @ so3_exp(phi * torch.as_tensor(a.reshape(-1), dtype=torch.float64)[:, None])
    return Rt.numpy().reshape(T, K, 3, 3), p


@dataclasses.dataclass
class StressEvents:
    """Per-frame stress schedule (arrays (T,) unless noted).  A photometric
    channel left None is off: ``noise_read``/``noise_shot`` sensor noise,
    ``blur`` exposure fraction of the 3-tap motion blur, ``vignette``
    corner falloff fraction."""

    tex_scale: np.ndarray  # texture AC amplitude multiplier (1 = nominal)
    blob_scale: np.ndarray  # landmark blob amplitude multiplier
    gain: np.ndarray  # global brightness gain
    offset: np.ndarray  # global brightness offset (intensity units)
    occ_pos: np.ndarray  # (T, 3) occluder sphere centre in world
    occ_radius: np.ndarray  # occluder radius in metres (0 = off)
    noise_read: Optional[np.ndarray] = None  # read-noise sigma (DN)
    noise_shot: Optional[np.ndarray] = None  # shot gain: var = shot * I
    blur: Optional[np.ndarray] = None  # exposure fraction in [0, 1]
    vignette: Optional[np.ndarray] = None  # corner falloff in [0, 1]
    noise_seed: int = 0
    noise_frame0: int = 0  # absolute index of frame 0 (set by .slice)

    @staticmethod
    def nominal(T: int) -> "StressEvents":
        return StressEvents(
            tex_scale=np.ones(T), blob_scale=np.ones(T), gain=np.ones(T), offset=np.zeros(T),
            occ_pos=np.zeros((T, 3)), occ_radius=np.zeros(T),
        )

    def slice(self, s0: int, s1: int) -> "StressEvents":
        """Frame-range slice for chunked rendering; the noise of each frame
        depends on its absolute index only."""

        def cut(x):
            return None if x is None else x[s0:s1]

        return StressEvents(
            tex_scale=self.tex_scale[s0:s1], blob_scale=self.blob_scale[s0:s1],
            gain=self.gain[s0:s1], offset=self.offset[s0:s1],
            occ_pos=self.occ_pos[s0:s1], occ_radius=self.occ_radius[s0:s1],
            noise_read=cut(self.noise_read), noise_shot=cut(self.noise_shot),
            blur=cut(self.blur), vignette=cut(self.vignette),
            noise_seed=self.noise_seed, noise_frame0=self.noise_frame0 + s0,
        )


def make_stress_events(
    traj: SimTrajectory,
    frame_indices: np.ndarray,
    orbit_angle: Optional[np.ndarray] = None,
    occ_orbit_radius: float = 5.5,
    occ_max_radius: float = 0.8,
    sensor_noise: bool = True,
    noise_read_dn: float = 1.5,
    noise_shot_gain: float = 0.04,
    motion_blur: bool = True,
    vignette: float = 0.35,
    noise_seed: int = 0,
    tex_poor_depth: float = 0.85,
    blob_poor_depth: float = 0.65,
) -> StressEvents:
    """The standard stress schedule over normalised sequence time (see the
    JAX original for the calibration of each default): texture-poor windows
    [0.22, 0.36] and [0.58, 0.72]; an occluder sphere parked in front of the
    wall over [0.42, 0.56]; exposure drift (gain 1 +/- 0.25 with a darkening
    trend, offset +/- 12 DN) all run; sensor noise, full-exposure motion blur
    and 35 % vignetting all run."""
    t = traj.t[frame_indices]
    u = (t - t[0]) / max(t[-1] - t[0], 1e-9)
    T = len(t)

    def window(lo, hi, ramp=0.02):
        up = np.clip((u - lo) / ramp, 0.0, 1.0)
        dn = np.clip((hi - u) / ramp, 0.0, 1.0)
        return np.minimum(up, dn)

    poor = np.maximum(window(0.22, 0.36), window(0.58, 0.72))
    gain = 1.0 + 0.25 * np.sin(2 * np.pi * u * 3.1) - 0.1 * u
    offset = 12.0 * np.sin(2 * np.pi * u * 1.7 + 1.0)
    occ_w = window(0.42, 0.56, ramp=0.04)
    if orbit_angle is None:
        orbit_angle = np.arctan2(traj.p[frame_indices, 1], traj.p[frame_indices, 0])
    mid = int(np.clip(np.searchsorted(u, 0.49), 0, T - 1))
    az = float(orbit_angle[mid])
    occ_pos = np.tile(
        np.array([occ_orbit_radius * np.cos(az), occ_orbit_radius * np.sin(az), 0.3]), (T, 1)
    )
    return StressEvents(
        tex_scale=1.0 - tex_poor_depth * poor,
        blob_scale=1.0 - blob_poor_depth * poor,
        gain=gain,
        offset=offset,
        occ_pos=occ_pos,
        occ_radius=occ_max_radius * occ_w,
        noise_read=np.full(T, noise_read_dn) if sensor_noise else None,
        noise_shot=np.full(T, noise_shot_gain) if sensor_noise else None,
        blur=np.ones(T) if motion_blur else None,
        vignette=np.full(T, vignette) if vignette > 0 else None,
        noise_seed=noise_seed,
    )


def _noise_generator(seed: int, frame: int, cam: int, device) -> torch.Generator:
    """A fresh generator for one (noise seed, absolute frame, camera)."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) * 1_000_003 + int(frame)) * 2 + cam) % (1 << 63))
    return g


def _rotate(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v @ R^T for v (B, n, 3) and R (B or 1, 3, 3), written out
    elementwise so it runs in float32 whatever the TF32 flags are."""
    return (
        v[..., 0:1] * R[:, None, :, 0]
        + v[..., 1:2] * R[:, None, :, 1]
        + v[..., 2:3] * R[:, None, :, 2]
    )


class TorchRenderer:
    """Scene constants on ``device`` (the CUDA card when None; raises
    without CUDA unless a device is named); renders batches of frames
    there."""

    def __init__(
        self,
        landmarks: np.ndarray,
        calib: StereoCalib = EUROC_CALIB,
        min_depth: float = 0.3,
        blob_radius: int = 4,
        seed: int = 5,
        r_wall: float = 12.0,
        z_cap: float = 8.0,
        dtype=torch.float32,
        blur_taps: Tuple[float, ...] = (-0.5, 0.0, 0.5),
        device=None,
    ):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        W, H = calib.cam0.resolution
        self.H, self.W = H, W
        self.r_wall, self.z_cap = r_wall, z_cap
        self.min_depth = min_depth
        self.blob_radius = blob_radius
        self.blur_taps = tuple(blur_taps)
        self.dtype = dtype

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=self.device)

        L = landmarks.shape[0]
        # Same draw order and shapes as render.render_stereo_sequence.
        self.amp = t(rng.uniform(60.0, 140.0, L))
        self.sx = t(rng.uniform(1.1, 1.8, L))
        self.sy = t(rng.uniform(1.1, 1.8, L))
        self.landmarks = np.asarray(landmarks, np.float64)
        tex = _Texture(seed)
        self.tex = [tuple(float(c[n]) for c in (tex.fa, tex.fz, tex.pa, tex.pz, tex.amp))
                    for n in range(len(tex.fa))]

        T_ci0 = calib.cam0.T_cam_imu_mat()
        T_ci1 = calib.T_cam0_cam1_mat() @ T_ci0
        self.cams = []
        for T_ci, cam in ((T_ci0, calib.cam0), (T_ci1, calib.cam1)):
            cx, cy = cam.intrinsics[2], cam.intrinsics[3]
            uu, vv = np.meshgrid(np.arange(W) - cx, np.arange(H) - cy)
            corners = [(x - cx) ** 2 + (y - cy) ** 2 for x in (0, W - 1) for y in (0, H - 1)]
            self.cams.append(dict(
                R_ci=T_ci[:3, :3], t_ci=T_ci[:3, 3],
                R_ci_t=t(T_ci[:3, :3]), t_ci_t=t(T_ci[:3, 3]),
                rays=t(_ray_lut(cam.intrinsics, cam.distortion_coeffs, W, H).reshape(-1, 3)),
                intr=tuple(float(v) for v in cam.intrinsics),
                dist=tuple(float(v) for v in cam.distortion_coeffs),
                # Vignetting: normalised squared radius from the principal
                # point, 1 at the farthest corner.
                vig=t((uu * uu + vv * vv) / max(corners)),
            ))

    # ---- per-pose pieces, batched over B poses -----------------------------

    def _texture(self, theta, z, tex_scale):
        ac = torch.zeros_like(theta)
        for fa, fz, pa, pz, amp in self.tex:
            ac += amp * torch.sin(theta * fa + pa) * torch.sin(z * fz + pz)
        return 70.0 + tex_scale[:, None] * ac

    def _raycast(self, R_c_w, o_w, rays, tex_scale):
        """(B, H*W) background, world ray directions (B, H*W, 3) and hit
        distances (B, H*W)."""
        d = _rotate(rays[None], R_c_w)
        d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
        o0, o1, o2 = o_w[:, 0:1], o_w[:, 1:2], o_w[:, 2:3]
        a = d0 * d0 + d1 * d1
        b = 2.0 * (o0 * d0 + o1 * d1)
        c = o0 * o0 + o1 * o1 - self.r_wall**2
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        t_cyl = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-12)
        dz = torch.where(torch.abs(d2) > 1e-9, d2, torch.full_like(d2, 1e-9))
        t_top = (self.z_cap - o2) / dz
        t_bot = (-self.z_cap - o2) / dz
        use_cyl = (torch.abs(o2 + t_cyl * d2) <= self.z_cap) & (t_cyl > 0)
        t_cap = torch.where(d2 > 0, t_top, t_bot)
        t = torch.where(use_cyl, t_cyl, torch.clamp(t_cap, min=0.1))
        p0, p1, p2 = o0 + t * d0, o1 + t * d1, o2 + t * d2
        theta = torch.atan2(p1, p0)
        zc = torch.where(use_cyl, p2, torch.hypot(p0, p1) * torch.sign(p2) * 0.6)
        return self._texture(theta, zc, tex_scale), d, t

    def _project(self, p_cam, intr, dist):
        fx, fy, cx, cy = intr
        k1, k2, p1, p2 = dist
        z = torch.where(p_cam[..., 2] != 0, p_cam[..., 2], torch.ones_like(p_cam[..., 2]))
        x = p_cam[..., 0] / z
        y = p_cam[..., 1] / z
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return xd * fx + cx, yd * fy + cy

    def _render_one_cam(self, cam, R_wb, p_b, p_imu, ev):
        """Pre-photometric images (B, H, W) of one camera at B poses given
        as float64 numpy (B, 3, 3), (B, 3); ``p_imu`` (B, L, 3) the
        landmarks in the IMU frame, ``ev`` per-pose tensors."""
        dev, dt = self.device, self.dtype
        B, H, W = R_wb.shape[0], self.H, self.W
        R_c_w = np.swapaxes(cam["R_ci"] @ R_wb, -1, -2)
        o_w = p_b + np.einsum("bji,j->bi", R_wb, -cam["R_ci"].T @ cam["t_ci"])
        R_c_w_t = torch.as_tensor(R_c_w, dtype=dt, device=dev)
        o_w_t = torch.as_tensor(o_w, dtype=dt, device=dev)
        img, d_w, t_bg = self._raycast(R_c_w_t, o_w_t, cam["rays"], ev["tex_scale"])

        # Landmark blobs, scatter-added.
        p_c = _rotate(p_imu, cam["R_ci_t"][None]) + cam["t_ci_t"]
        vis = p_c[..., 2] > self.min_depth
        u, v = self._project(torch.where(vis[..., None], p_c, torch.ones_like(p_c)), cam["intr"], cam["dist"])
        r = self.blob_radius
        vis = vis & (u > r + 3) & (u < W - r - 4) & (v > r + 3) & (v < H - r - 4)
        cx_i = torch.round(u).to(torch.int64)
        cy_i = torch.round(v).to(torch.int64)
        g = torch.arange(-r, r + 1, device=dev)
        gy, gx = g[:, None], g[None, :]
        du = gx.to(dt) + (cx_i.to(dt) - u)[..., None, None]
        dv = gy.to(dt) + (cy_i.to(dt) - v)[..., None, None]
        blob = (
            ev["blob_scale"][:, None, None, None]
            * self.amp[None, :, None, None]
            * torch.exp(-0.5 * ((du / self.sx[None, :, None, None]) ** 2
                                + (dv / self.sy[None, :, None, None]) ** 2))
        )
        blob = torch.where(vis[..., None, None], blob, torch.zeros_like(blob))
        # Clip instead of drop: invisible landmarks carry zero weight and
        # visible ones lie at least r+3 px inside the border.
        iy = torch.clamp(cy_i[..., None, None] + gy, 0, H - 1)
        ix = torch.clamp(cx_i[..., None, None] + gx, 0, W - 1)
        flat = (torch.arange(B, device=dev)[:, None, None, None] * H + iy) * W + ix
        img = img.reshape(-1).index_put_((flat.reshape(-1),), blob.reshape(-1), accumulate=True)
        img = img.reshape(B, H * W)

        # World-space sphere occluder, flat-shaded, over background and blobs.
        oc = ev["occ_pos"] - o_w_t  # (B, 3)
        t_close = (d_w * oc[:, None, :]).sum(-1)
        dist2 = (oc * oc).sum(-1)[:, None] - t_close * t_close
        rad = ev["occ_radius"][:, None]
        hit = (rad > 0) & (t_close > self.min_depth) & (dist2 < rad * rad) & (t_close < t_bg)
        img = torch.where(hit, torch.full_like(img, 42.0), img)
        return img.reshape(B, H, W)

    def _finalize(self, img, ev, frames, cam_idx: int, noise_seed: int):
        """Photometric chain on (T, H, W): vignette, exposure gain and
        offset, sensor noise, clip to [0, 255]."""
        if "vignette" in ev:
            img = img * (1.0 - ev["vignette"][:, None, None] * self.cams[cam_idx]["vig"])
        img = ev["gain"][:, None, None] * img + ev["offset"][:, None, None]
        if "noise_read" in ev:
            nr = ev["noise_read"][:, None, None]
            sigma = torch.sqrt(nr * nr + ev["noise_shot"][:, None, None] * torch.clamp(img, min=0.0))
            z = torch.stack([
                torch.randn((self.H, self.W), generator=_noise_generator(noise_seed, f, cam_idx, self.device),
                            device=self.device, dtype=self.dtype)
                for f in frames
            ])
            img = img + sigma * z
        return torch.clamp(img, 0.0, 255.0)

    def render_frames(self, R_taps: np.ndarray, p_taps: np.ndarray, ev: StressEvents):
        """Render T frames: R_taps (T, K, 3, 3) and p_taps (T, K, 3) are the
        exposure taps of each frame (K = 1 without blur), ``ev`` the T
        frames' events.  Returns two (T, H, W) tensors on the device.  With
        blur b the frame is (1 - b) * centre tap + b * mean of the taps."""
        T, K = R_taps.shape[:2]
        dev, dt = self.device, self.dtype

        def per_frame(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dt, device=dev)

        evt = {k: per_frame(getattr(ev, k)) for k in ("tex_scale", "blob_scale", "gain", "offset",
                                                       "occ_pos", "occ_radius")}
        for k in ("blur", "vignette", "noise_read", "noise_shot"):
            if getattr(ev, k) is not None:
                evt[k] = per_frame(getattr(ev, k))
        # Per pose (frame-major, taps minor).
        ev_pose = {k: torch.repeat_interleave(evt[k], K, dim=0)
                   for k in ("tex_scale", "blob_scale", "occ_pos", "occ_radius")}
        R_wb = np.asarray(R_taps, np.float64).reshape(T * K, 3, 3)
        p_b = np.asarray(p_taps, np.float64).reshape(T * K, 3)
        # Landmarks in the IMU frame of each pose: (lm - p_b) @ R_wb^T.
        p_imu = torch.as_tensor(
            np.einsum("bij,blj->bli", R_wb, self.landmarks[None] - p_b[:, None]), dtype=dt, device=dev
        )
        frames = range(ev.noise_frame0, ev.noise_frame0 + T)
        outs = []
        for c, cam in enumerate(self.cams):
            taps = self._render_one_cam(cam, R_wb, p_b, p_imu, ev_pose).reshape(T, K, self.H, self.W)
            img = taps[:, K // 2]
            if "blur" in evt and K > 1:
                b = evt["blur"][:, None, None]
                img = (1.0 - b) * img + b * taps.mean(dim=1)
            outs.append(self._finalize(img, evt, frames, c, ev.noise_seed))
        return outs[0], outs[1]

    def render_sequence(
        self,
        traj: SimTrajectory,
        frame_indices: np.ndarray,
        events: Optional[StressEvents] = None,
        chunk: int = 64,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render ``frame_indices`` in chunks; returns two (T, H, W) tensors
        on the device."""
        frame_indices = np.asarray(frame_indices)
        T = len(frame_indices)
        ev = events or StressEvents.nominal(T)
        if ev.blur is not None:
            # Exposure taps at fractional trajectory steps (+/- 0.5 step, a
            # ~5 ms shutter at 200 Hz), close enough to integrate into a
            # smooth streak; the smear comes from the true pose change.
            R_np, p_np = _interp_pose_taps(traj, frame_indices, np.asarray(self.blur_taps), traj.p.shape[0])
        else:
            R_np = traj.R_w_b[frame_indices][:, None]
            p_np = traj.p[frame_indices][:, None]
        outs0, outs1 = [], []
        for s0 in range(0, T, chunk):
            s1 = min(s0 + chunk, T)
            i0, i1 = self.render_frames(R_np[s0:s1], p_np[s0:s1], ev.slice(s0, s1))
            outs0.append(i0)
            outs1.append(i1)
        return torch.cat(outs0), torch.cat(outs1)
