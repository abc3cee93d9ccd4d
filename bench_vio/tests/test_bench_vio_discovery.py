"""Cells, configurations and metric readers are found by name, and a new
one is picked up from new files and new BENCHMARK.json entries alone."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_has_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    from bench_vio.harness import load_json
    from bench_vio.metrics import reader

    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert load_json("cells", w["name"])["config"] == w["config"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and callable(reader(m["name"]))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in bench["workloads"]}
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path):
    """In a copy of the benchmark, add a configuration, a cell and a
    per-layer metric as new files and entries: the harness finds them."""
    shutil.copytree(REPO / "bench_vio", tmp_path / "bench_vio",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "bench_vio/configs/euroc-v101.json").read_text())
    cfg["frontend"] = {"klt_norm": "offset"}
    (tmp_path / "bench_vio/configs/throwaway-cfg.json").write_text(json.dumps(cfg))
    cell = json.loads((tmp_path / "bench_vio/cells/v101.eval.b512.json").read_text())
    cell.update(config="throwaway-cfg", lanes=2, fields=2, seq_frames=6, warmup_frames=1, trace_frames=1)
    (tmp_path / "bench_vio/cells/throwaway.b2.json").write_text(json.dumps(cell))
    (tmp_path / "bench_vio/metrics/throwaway_frames.py").write_text(
        "def read(run):\n    return None if run.trace is None else float(run.trace.frames)\n")
    bench["configs"].append(dict(bench["configs"][0], name="throwaway-cfg", file="bench_vio/configs/throwaway-cfg.json"))
    bench["workloads"].append(dict(name="throwaway.b2", config="throwaway-cfg", traffic="b2", chips=1, why="test"))
    bench["per_layer"].append(dict(name="throwaway_frames", unit="frames", better="higher", source="program_counter",
                                   layer="frame step", moves="lane_frames_per_s", workloads=["throwaway.b2"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "bench_vio/tests_shim.py").write_text(
        "import io, json\n"
        "from bench_vio.harness import load_json\n"
        "from bench_vio.run import execute\n"
        "def go():\n"
        "    cell, config = load_json('cells', 'throwaway.b2'), load_json('configs', 'throwaway-cfg')\n"
        "    config['scene']['duration'] = 3.0\n"
        "    out, err = io.StringIO(), io.StringIO()\n"
        "    rc = execute('throwaway.b2', 5, 0.5, True, device='cpu', cell=cell, config=config, out=out, err=err)\n"
        "    print(rc, out.getvalue().splitlines()[-1])\n"
        "go()\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]))
    p = subprocess.run([sys.executable, "-c", "import bench_vio.tests_shim"], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    rc, line = p.stdout.strip().splitlines()[-1].split(" ", 1)
    result = json.loads(line)
    assert rc == "0"
    assert result["metrics"]["throwaway_frames"]["value"] == 1.0
    assert result["correct"] is True, result["checks"]
