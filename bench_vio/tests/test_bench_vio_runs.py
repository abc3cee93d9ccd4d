"""Each cell runs on the CPU at a tiny size and prints the contract's last
line; a run with the timed path broken underneath comes out not correct."""
import json

import pytest
import torch

from bench_vio.calibrate import neighbour_field
from bench_vio.tests._tiny import run_tiny

CELLS = [w["name"] for w in json.load(open("BENCHMARK.json"))["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(name, trace):
    rc, lines, err, result = run_tiny(name, trace)
    assert rc == 0, err
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(line.startswith("#") for line in lines[:-1])
    # Every number compared is printed last on stderr, beside its limit.
    checks = result["checks"]
    assert [line.split(":")[0] for line in err[-len(checks):]] == [f"check {k}" for k in checks]
    bench = json.load(open("BENCHMARK.json"))
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    for name_m in result["metrics"]:
        assert any(m["name"] == name_m for m in entries)
    if not trace:
        # The CPU has no device metric: only the host clock's.
        host = {m["name"] for m in entries if m["source"] == "host_clock" and name in m.get("workloads", [name])}
        assert set(result["metrics"]) == host and "setup_s" in host and len(host) >= 2
    else:
        assert "breakdown" in result and list(result)[-2] == "breakdown"
        assert result["device"]["window_s"] > 0


def _broken(monkeypatch, how):
    from msckf_stereo_c_torch.models import vio

    real = vio.batched_vio_step

    def step(state, *args, **kwargs):
        new, outs = real(state, *args, **kwargs)
        if how == "unchanged":
            return state, outs
        if how == "half":
            B = state.prev_time.shape[0]
            keep = torch.arange(B) >= B // 2

            def merge(n, o):
                return torch.where(keep.view(-1, *[1] * (n.dim() - 1)), o, n)

            def copy0(x):
                x = x.clone()
                x[B // 2:] = x[0]
                return x

            from bench_vio.harness import tree_map
            olds = [x for x in _leaves(state)]
            it = iter(olds)
            new = tree_map(lambda n: merge(n, next(it)), new)
            return new, tree_map(copy0, outs)
        pose, front = outs
        if how == "uv":  # every published observation 1e-4 (about 0.05 px) off
            return new, (pose, front._replace(uv=front.uv + 1e-4))
        raise ValueError(how)

    monkeypatch.setattr(vio, "batched_vio_step", step)


def _leaves(tree):
    from bench_vio.harness import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("name,how", [("v101.eval.b512", "unchanged"), ("v101.eval.b512", "half"),
                                      ("v101.eval.b512", "uv"), ("v101.eval.b512", "field"),
                                      ("v101-stress-gain.live.b1", "unchanged"),
                                      ("v101-stress-gain.live.b1", "uv")])
def test_a_broken_step_is_not_correct(monkeypatch, name, how):
    """The faults a cell can have: a step that returns its state unchanged,
    half of the lanes left unstepped (their answers copied from lane 0),
    an answer (the published observations) altered where it is produced,
    each lane handed another landmark field's images."""
    if how == "field":
        with neighbour_field():
            rc, _, err, result = run_tiny(name)
    else:
        _broken(monkeypatch, how)
        rc, _, err, result = run_tiny(name)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
