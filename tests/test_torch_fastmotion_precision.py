"""The fast-motion precision script of the port
(``msckf_stereo_c_torch/scripts/fastmotion_precision.py``) on the CPU: its
``filter[/frontend]`` specs with the JAX script's defaults, the bf16 names
parsed and run (over a 0.3 s cut of the scene, rendered once), and one
spec over a 2 s cut of the scene
equal to a direct ``run_vio_sequence`` call with the same configurations
(ATE to the printed digit, min tracks exact)."""
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.config import EUROC_CALIB
from msckf_stereo_c_torch.io.tum import evaluate_ate
from msckf_stereo_c_torch.models.vio import run_vio_sequence
from msckf_stereo_c_torch.scripts import fastmotion_precision as fmp


def test_spec_parser():
    fcfg, mcfg = fmp.spec_configs("float32/tensorfloat32")
    assert (mcfg.matmul_precision, fcfg.matmul_precision) == ("float32", "tensorfloat32")
    fcfg, mcfg = fmp.spec_configs("highest")
    assert (mcfg.matmul_precision, fcfg.matmul_precision) == ("highest", "default")
    assert fcfg.max_features == 64 and fcfg.temporal_levels == 1
    assert (mcfg.max_cam_state_size, mcfg.max_tracks, mcfg.max_imu_per_frame, mcfg.ns_iters) == (8, 80, 12, 10)
    assert fmp.DEFAULT_SPECS == ("float32", "tensorfloat32")
    with pytest.raises(ValueError):
        fmp.spec_configs("float16")


@pytest.fixture(scope="module")
def short_scene():
    return fmp.fastmotion_scene(duration=0.3, device="cpu")


@pytest.mark.parametrize("spec", ["bfloat16", "float32/bfloat16_3x", "default/bfloat16"])
def test_bf16_names_raise_before_any_frame(spec, short_scene, monkeypatch):
    """The bf16 names, which once raised here, parse into their
    configurations and run on the CPU (a stub scene: the first 0.3 s)."""
    monkeypatch.setattr(fmp, "fastmotion_scene", lambda *a, **k: short_scene)
    filt, _, front = spec.partition("/")
    fcfg, mcfg = fmp.spec_configs(spec)
    assert (mcfg.matmul_precision, fcfg.matmul_precision) == (filt, front or "default")
    out = fmp.main(["float32", spec], env={"FM_PLATFORM": "cpu"})
    assert list(out) == ["float32", spec]
    got = out[spec]
    assert (got["filter"], got["frontend"]) == (filt, front or "default")
    assert np.isfinite(got["ate_rmse"]) and got["min_tracks_last20"] > 0
    with pytest.raises(ValueError):
        fmp.spec_configs(spec.replace("bfloat16", "bfloat8"))


def test_main_needs_the_card_unless_told(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.setattr(fmp, "fastmotion_scene", lambda *a, **k: pytest.fail("rendered without a device"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fmp.main(["float32"], env={})


def test_run_spec_equals_direct_run(capsys):
    scene = fmp.fastmotion_scene(duration=2.0, device="cpu")
    got = fmp.run_spec("float32/default", scene, device="cpu")
    line = capsys.readouterr().out.strip()
    assert line.startswith("filter=float32") and f"ate_rmse={got['ate_rmse']:.4f}m" in line

    fcfg, mcfg = fmp.spec_configs("float32/default")
    res = run_vio_sequence(
        fcfg, mcfg, EUROC_CALIB, scene.frame_t, scene.img0, scene.img1, scene.imu.t, scene.imu.gyro,
        scene.imu.acc, filter_dtype=torch.float32, method="schur", chunk=40, device="cpu",
    )
    ate = evaluate_ate(res.times, res.positions, scene.frame_t, scene.traj.p[scene.frame_idx]).rmse
    assert f"{got['ate_rmse']:.4f}" == f"{ate:.4f}"
    assert got["min_tracks_last20"] == int(res.tracking["after_ransac"][-20:].min())
    assert np.isfinite(ate) and got["min_tracks_last20"] > 0
