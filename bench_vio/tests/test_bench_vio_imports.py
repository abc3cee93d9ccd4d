"""The import check compares whole top-level names, and the benchmark's
modules load neither JAX nor the JAX package."""
import subprocess
import sys

from bench_vio.run import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["msckf_stereo_c_torch", "msckf_stereo_c_torch.models.vio", "jaxtyping",
                              "numpy", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "msckf_stereo_c_tpu.models", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "msckf_stereo_c_tpu"]


def test_the_benchmark_loads_no_jax():
    code = ("import pkgutil, importlib, sys, bench_vio\n"
            "for m in pkgutil.walk_packages(bench_vio.__path__, 'bench_vio.'):\n"
            "    if '.tests' not in m.name and 'shim' not in m.name:\n"
            "        importlib.import_module(m.name)\n"
            "import msckf_stereo_c_torch.models.vio, msckf_stereo_c_torch.parallel.vio_multiseq\n"
            "from bench_vio.run import forbidden_modules\n"
            "print(forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
