"""The track-bias probe of the port (``msckf_stereo_c_torch/scripts/
track_bias_probe.py``) on the CPU: its ``PROBE_*`` knobs, the bias tables
on a hand-made track set with known errors, and one 2 s run of the stress
scene with noise off against the JAX script (``scripts/track_bias_probe.py``)
run as a subprocess on the CPU with the same knobs.

The JAX script runs its Pallas LK loop in interpret mode
(``MSCKF_KLT_CORR_LOOP=interpret``): the template formula the port uses on
every device.  (JAX's default CPU path builds templates from a (P+4) window
with tent weights; points then differ by up to 5.3e-4 px, enough to flip a
stereo gate and change which tracks the two runs hold.)  With the same
formula the tracked points agree within 1.2e-4 px, so the printed lines are
compared number by number: every integer (track, observation and bin
counts) exactly, every decimal within PX_TOL = 1.5e-4 plus one unit of its
last printed digit (the means are in px or normalized rows, and a mean of
points each within 1.2e-4 px moves by no more)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.config import FrontendConfig
from msckf_stereo_c_torch.scripts import track_bias_probe as tbp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX_TOL = 1.5e-4
KNOBS = {"PROBE_GENERATOR": "stress", "PROBE_DUR": "2", "PROBE_NOISE": "0"}
NUMBER = re.compile(r"[+-]?\d+(?:\.\d+)?")


def test_knobs():
    k = tbp.probe_knobs({"PROBE_PLATFORM": "cpu"})
    assert (k.duration, k.r_wall, k.generator, k.use_vel, k.tex_scale) == (36.0, 8.0, "circle", True, 1.0)
    assert (k.noise, k.vignette, k.blur, k.device) == (False, 0.0, False, torch.device("cpu"))
    assert k.fcfg == FrontendConfig(anchor_refine=True)
    assert k.circle_kwargs == dict(z_amp=0.5, roll_amp=0.1, omega=2.0 * 3.14159265 / 20.0)
    env = {"PROBE_PLATFORM": "cpu", "PROBE_DUR": "3", "PROBE_WALL": "7", "PROBE_KLT": "gather", "PROBE_TMPL": "0",
           "PROBE_TLEVELS": "2", "PROBE_SLEVELS": "2", "PROBE_ANCHOR": "0", "PROBE_GENERATOR": "stress",
           "PROBE_ZAMP": "0.2", "PROBE_ROLLAMP": "0.3", "PROBE_OMEGA": "0.5", "PROBE_VEL": "0", "PROBE_TEX": "0.5",
           "PROBE_NOISE": "1", "PROBE_VIG": "0.35", "PROBE_BLUR": "1"}
    k = tbp.probe_knobs(env)
    assert k.fcfg == FrontendConfig(klt_impl="gather", tmpl_carry=False, temporal_levels=2, stereo_levels=2,
                                    anchor_refine=False)
    assert (k.duration, k.r_wall, k.generator, k.use_vel, k.tex_scale, k.noise, k.vignette, k.blur) == (
        3.0, 7.0, "stress", False, 0.5, True, 0.35, True)
    assert k.circle_kwargs == dict(z_amp=0.2, roll_amp=0.3, omega=0.5)
    ev = tbp.chunk_events(k, 64, 70)
    assert ev.noise_frame0 == 64 and np.all(ev.noise_read == 1.5) and np.all(ev.noise_shot == 0.04)
    assert np.all(ev.vignette == 0.35) and np.all(ev.blur == 1.0) and np.all(ev.tex_scale == 0.5)
    ev = tbp.chunk_events(tbp.probe_knobs({"PROBE_PLATFORM": "cpu"}), 0, 5)
    assert ev.noise_read is None and ev.vignette is None and ev.blur is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbp.probe_knobs({})


def test_bias_tables_known_errors(capsys):
    """Four landmarks tracked over 10 frames with du = 0.1 px x track age,
    dv = -0.2 px and, on one track only, a disparity error of +1 px; a
    fifth track far from every landmark is never associated."""
    fx, T = 400.0, 10
    n0 = np.tile(np.array([[-0.5, -0.4], [-0.1, -0.1], [0.1, 0.1], [0.5, 0.4]]), (T, 1, 1))
    n1 = n0 - np.array([0.05, 0.0])  # gt disparity 20 px
    z0 = np.full((T, 4), 5.0)
    fid = np.tile(np.array([0, 1, 2, 3, 9]), (T, 1))
    valid = np.ones((T, 5), bool)
    uv = np.zeros((T, 5, 4))
    age = np.arange(T)[:, None]
    uv[:, :4, 0] = n0[..., 0] + 0.1 * age / fx
    uv[:, :4, 1] = n0[..., 1] - 0.2 / fx
    ddisp = np.array([0.0, 0.0, 0.0, 1.0])
    uv[:, :4, 2] = uv[:, :4, 0] - (n0[..., 0] - n1[..., 0]) - ddisp / fx
    uv[:, 4, :2] = (0.9, 0.9)
    out = tbp.bias_tables(fid, uv, valid, n0, z0, n1, fx, np.arange(T) * 0.05)
    assert (out["tracks_associated"], out["tracks_seen"], out["obs"]) == (4, 5, 40)
    assert out["du_mean"] == pytest.approx(0.45) and out["dv_mean"] == pytest.approx(-0.2)
    assert out["ddisp_mean"] == pytest.approx(0.25)
    assert [r["share"] for r in out["outliers"]] == [0.25, 0.25, 0.0, 0.0]
    assert out["outliers"][1]["ddisp_mean"] == pytest.approx(1.0)
    assert (out["bad_tracks"], out["born_bad"], out["bad_lifetime_mean"], out["bad_lifetime_max"]) == (1, 1, 10.0, 10)
    ages = {r["age"]: (r["n"], r["du"]) for r in out["by_age"]}
    assert ages[(0, 1)] == (4, pytest.approx(0.0)) and ages[(6, 10)] == (16, pytest.approx(0.75))
    assert sum(r["n"] for r in out["by_row"]) == 30  # the top quantile edge is exclusive, as in JAX
    assert all(r["dv"] == pytest.approx(-0.2) for r in out["by_row"])
    assert out["age_row"][3] == [None] * 4  # no cell over 30 observations
    assert [r["n"] for r in out["by_time"]] == [4] * 10
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "tracks associated: 4 / 5; obs: 40"
    assert lines[8] == "tracks with |median ddisp|>0.5: 1 / 4"


def _numbers_agree(a: str, b: str) -> bool:
    if NUMBER.sub("#", a) != NUMBER.sub("#", b):
        return False
    for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
        if "." not in x:
            if x.lstrip("+") != y.lstrip("+"):
                return False
        elif abs(float(x) - float(y)) > PX_TOL + 10.0 ** -len(x.split(".")[1]) + 1e-12:
            return False
    return True


def test_stress_scene_against_jax(capsys):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PROBE_")}
    env.update(KNOBS, JAX_PLATFORMS="cpu", PROBE_PLATFORM="cpu", MSCKF_KLT_CORR_LOOP="interpret", PYTHONPATH=ROOT)
    jax_run = subprocess.Popen([sys.executable, os.path.join(ROOT, "scripts", "track_bias_probe.py")], cwd=ROOT,
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = tbp.main(dict(KNOBS, PROBE_PLATFORM="cpu"))
        jax_out, jax_err = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, jax_err[-3000:]
    ours = capsys.readouterr().out.strip().splitlines()
    theirs = jax_out.strip().splitlines()
    assert len(ours) == len(theirs) > 30
    bad = [(a, b) for a, b in zip(ours, theirs) if not _numbers_agree(a, b)]
    assert not bad, bad
    assert out["obs"] > 1000 and out["tracks_associated"] > 40
    assert f"{out['tracks_associated']} / {out['tracks_seen']}; obs: {out['obs']}" in ours[0]
