"""Tiny sizes of the benchmark's cells for runs on the CPU: two lanes (one
for a one-lane cell) over sequences of 6 frames of a 3 s trajectory."""
import copy
import io
import json

from bench_vio.harness import load_json


def tiny(name: str):
    """(cell, config) of the workload ``name`` at a size the CPU runs in
    seconds."""
    cell = copy.deepcopy(load_json("cells", name))
    lanes = min(2, int(cell["lanes"]))
    cell.update(lanes=lanes, fields=min(int(cell["fields"]), lanes), seq_frames=6, warmup_frames=2, trace_frames=2,
                roofline_frames=1, check_every=2)
    config = copy.deepcopy(load_json("configs", cell["config"]))
    config["scene"]["duration"] = 3.0
    return cell, config


def run_tiny(name: str, trace: bool = False, seed: int = 2**31 + 11, seconds: float = 1.0, overrides=None):
    """(exit code, stdout lines, stderr lines, the last stdout line as JSON)
    of one tiny run of ``name`` on the CPU."""
    from bench_vio.run import execute

    cell, config = tiny(name)
    out, err = io.StringIO(), io.StringIO()
    rc = execute(name, seed, seconds, trace, device="cpu", cell=cell, config=config, overrides=overrides,
                 out=out, err=err)
    lines = out.getvalue().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, lines, err.getvalue().splitlines(), result
