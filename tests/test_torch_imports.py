"""The port stands alone: no module of msckf_stereo_c_torch, and not
chip_smoke.py, imports JAX or the JAX package."""
import io
import os
import pkgutil
import subprocess
import sys
import tokenize

import pytest

import msckf_stereo_c_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(msckf_stereo_c_torch.__file__)


def _port_modules():
    names = [msckf_stereo_c_torch.__name__]
    for info in pkgutil.walk_packages([PKG], prefix="msckf_stereo_c_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_imports_without_jax():
    modules = _port_modules() + ["chip_smoke"]
    assert len(modules) > 30
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'msckf_stereo_c_tpu'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": ROOT},
    )
    assert r.returncode == 0, r.stdout + r.stderr


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_names_the_jax_package_in_code(path):
    """Comments and docstrings may cite the JAX original; code may not name
    it or JAX."""
    with open(path) as f:
        tokens = tokenize.generate_tokens(io.StringIO(f.read()).readline)
        names = {t.string for t in tokens if t.type == tokenize.NAME}
    assert not names & {"msckf_stereo_c_tpu", "jax", "jaxlib"}, path


def test_batched_entry_modules_are_covered():
    """The batched-sequence runner and the benchmark entry point are among
    the modules imported without JAX and scanned for its names above."""
    new = {"msckf_stereo_c_torch.parallel.vio_multiseq", "msckf_stereo_c_torch.bench"}
    assert new <= set(_port_modules())
    paths = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"msckf_stereo_c_torch/parallel/vio_multiseq.py", "msckf_stereo_c_torch/bench.py"} <= paths


def test_stress_script_modules_are_covered():
    """The multi-seed stress script and the package's scripts are among the
    modules imported without JAX and scanned for its names above."""
    new = {"msckf_stereo_c_torch.scripts", "msckf_stereo_c_torch.scripts.stress_gate"}
    assert new <= set(_port_modules())
    paths = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"msckf_stereo_c_torch/scripts/__init__.py", "msckf_stereo_c_torch/scripts/stress_gate.py"} <= paths


DATASET_MODULES = {
    "msckf_stereo_c_torch.io.yaml_subset", "msckf_stereo_c_torch.io.euroc", "msckf_stereo_c_torch.io.native",
    "msckf_stereo_c_torch.io.png", "msckf_stereo_c_torch.io.checkpoint", "msckf_stereo_c_torch.io.live_viewer",
    "msckf_stereo_c_torch.utils.timing", "msckf_stereo_c_torch.apps", "msckf_stereo_c_torch.apps.run_euroc",
    "msckf_stereo_c_torch.apps.run_euroc_batch", "msckf_stereo_c_torch.entry",
    "msckf_stereo_c_torch.sim.euroc_dataset",
}


def test_dataset_modules_are_covered():
    """The config reader, the EuRoC I/O, the checkpoints, the timer, the
    apps and the entry point are among the modules imported without JAX and
    scanned for its names above."""
    assert DATASET_MODULES <= set(_port_modules())
    paths = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in DATASET_MODULES - {"msckf_stereo_c_torch.apps"}} <= paths


def test_port_imports_no_yaml_cv2_or_pil():
    """The card host need not have PyYAML, OpenCV or Pillow: no module of
    the port, and not chip_smoke.py, imports them (the CPU tests use them
    only as references)."""
    modules = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('yaml', '_yaml', 'cv2', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": ROOT},
    )
    assert r.returncode == 0, r.stdout + r.stderr


FRONTEND_PATH_MODULES = {
    "msckf_stereo_c_torch.ops.klt", "msckf_stereo_c_torch.ops.ransac",
    "msckf_stereo_c_torch.scripts.stress_debug",
}


def test_frontend_path_modules_are_covered():
    """The gather LK, the two-point RANSAC and the stress diagnosis script
    are among the modules imported without JAX and scanned for its names
    above."""
    assert FRONTEND_PATH_MODULES <= set(_port_modules())
    paths = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in FRONTEND_PATH_MODULES} <= paths


BACKEND_MODULES = {
    "msckf_stereo_c_torch.parallel.collectives", "msckf_stereo_c_torch.parallel.ba",
    "msckf_stereo_c_torch.parallel.posegraph", "msckf_stereo_c_torch.parallel.refine",
    "msckf_stereo_c_torch.parallel.multisession", "msckf_stereo_c_torch.scripts.multisession_gate",
}


def test_backend_modules_are_covered():
    """The refinement back end (BA, the pose graph, the VIO-to-BA glue, the
    multi-session tier, their torch.distributed plumbing) and the
    multi-session gate script are among the modules imported without JAX
    and scanned for its names above."""
    assert BACKEND_MODULES <= set(_port_modules())
    paths = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in BACKEND_MODULES} <= paths
