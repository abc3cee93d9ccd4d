"""The calibration script runs every side at a tiny size on the CPU: the
program, both controls and the neighbour-field fault, with the filter
also judged by the reference's Schur update."""
import contextlib
import io
import json

from bench_vio import calibrate
from bench_vio.tests._tiny import tiny


def test_calibrate_runs_every_side():
    cell, config = tiny("v101.eval.b512")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate.main(["--workload", "v101.eval.b512", "--seeds", "7", "--control-seeds", "8",
                             "--fault-seeds", "9", "--seconds", "0.5", "--check-every", "1", "--methods", "schur"],
                            device="cpu", cell=cell, config=config)
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [x["side"] for x in lines[:-1]] == ["program", "tf32", "bf16", "field"]
    for x in lines[:-1]:
        assert "error" not in x, x
        assert {"tracks_moved", "cov_gap_p90", "cov_gap_p90@schur"} <= set(x["numbers"])
    assert lines[1]["numbers"]["tracks_moved"] == 0.0  # TF32 reaches no product of the tracker on the CPU
    assert lines[-2]["numbers"]["tracks_moved"] > 0.5  # another field's images: other tracks
    assert set(lines[-1]["largest"]) == {"program", "tf32", "bf16", "field"}
