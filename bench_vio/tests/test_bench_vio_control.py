"""On the card: a sound run of each cell is correct, and each of its
controls (the program one precision below the configuration's: TF32
products in the filter, one bf16 pass in the front end) is not.  Small
windows and at most 8 lanes, so that a test run holds it; the cells' own
sizes are read by ``python3 -m bench_vio.calibrate``.

    python -m pytest -p no:cacheprovider -m cuda bench_vio/tests/test_bench_vio_control.py
"""
import copy
import io
import json

import pytest
import torch

from bench_vio.calibrate import CONTROLS
from bench_vio.harness import load_json

CELLS = [w["name"] for w in json.load(open("BENCHMARK.json"))["workloads"]]


def _run(name, overrides):
    from bench_vio.run import execute

    cell = copy.deepcopy(load_json("cells", name))
    cell.update(lanes=min(8, int(cell["lanes"])), check_every=2)
    out, err = io.StringIO(), io.StringIO()
    rc = execute(name, 2**31 + 99, 4.0, False, device="cuda", cell=cell, overrides=overrides, out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sound = _run(name, None)
    assert sound["correct"] is True, sound["checks"]
    for side, overrides in CONTROLS.items():
        control = _run(name, overrides)
        assert control["correct"] is False, (side, control["checks"])
