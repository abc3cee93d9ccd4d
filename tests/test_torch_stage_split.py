"""The stage split of the port (``msckf_stereo_c_torch/scripts/stage_split.py``)
on the CPU, at B=2 over 3 frames of the bench scene from the state its
first frames leave (a 4-camera window, so the camera prune runs within
the split frames): the ranged run gives bit for bit the poses and tracks of an
unwrapped run, every stage label is recorded with each sub-phase's host
time inside its parent's, and every wrapped attribute is restored, also
when the run raises.  The CPU has no device events, so the attribution of
device events to stages is tested on a hand-made event list; the device
columns themselves need the card (chip_smoke.py's ``[stage split]``
phase)."""
import pytest
import torch

from msckf_stereo_c_torch.bench import bench_scene
from msckf_stereo_c_torch.config import FilterConfig, FrontendConfig
from msckf_stereo_c_torch.scripts import stage_split as ss

HEAD, SPLIT, B = 4, 3, 2


def _attributes():
    return {stage: ss.stage_function(stage) for stage in ss.STAGES + ss.LOST_STAGES}


@pytest.fixture(scope="module")
def tail():
    scene = bench_scene(HEAD + SPLIT)
    fcfg = FrontendConfig(temporal_levels=1)
    mcfg = FilterConfig(ns_iters=10, max_cam_state_size=4, matmul_precision="tensorfloat32")
    state = ss.head_state(scene, HEAD, fcfg, mcfg, "schur", "cpu")
    return ss.tail_run(scene, state, HEAD, B, fcfg, mcfg, "schur", "cpu")


def test_ranged_run_equals_unwrapped_run(tail, capsys):
    before = _attributes()
    _, plain_poses, plain_fronts, _ = tail()
    (_, poses, fronts, _), table = ss.split_at(tail)
    assert _attributes() == before
    for a, b in ((plain_poses, poses), (plain_fronts, fronts)):
        for field, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), field
    assert poses.p.shape == (B, SPLIT, 3)

    assert table["B"] == B and table["frames"] == SPLIT
    rows = table["stages"]
    assert set(rows) == set(ss.LABELS)
    for label, r in rows.items():
        assert r["calls"] >= (1 if label == "filter: camera prune" else SPLIT), label
        parent = ss.parent_of(label)
        if parent is not None:
            assert r["host_ms"] <= rows[parent]["host_ms"], (label, parent)
    assert rows["lost: Schur update"]["calls"] == SPLIT  # the camera prune's calls are not ranged
    assert table["device_ms"] == 0 and table["device_ops"] == 0  # no device activity on the CPU
    out = capsys.readouterr().out
    assert f"[split] B={B}: {SPLIT} frames" in out and "lost: triangulate" in out


def test_attributes_restored_when_the_run_raises():
    from msckf_stereo_c_torch.ops import _cuda

    before, kernel_function = _attributes(), _cuda.kernel_function
    with pytest.raises(RuntimeError, match="inside"):
        with ss.stage_ranges():
            assert all(_attributes()[k] is not v for k, v in before.items())
            assert _cuda.kernel_function is not kernel_function
            raise RuntimeError("inside the ranges")
    assert _attributes() == before and _cuda.kernel_function is kernel_function


def test_labels_and_parents():
    assert len(set(ss.LABELS)) == len(ss.LABELS) == 21
    assert ss.parent_of("frontend: temporal LK") == ss.FRONTEND_TOTAL
    assert ss.parent_of("filter: camera prune") == ss.FILTER_TOTAL
    assert ss.parent_of("lost: Schur gating") == ss.LOST_PARENT
    assert ss.parent_of(ss.FILTER_TOTAL) is None


class _Event:
    """A raw profiler event as ``stage_table`` reads it."""

    def __init__(self, name, kind, corr, linked, start, end, annotation=False):
        self._v = (name, kind, corr, linked, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def linked_correlation_id(self):
        return self._v[3]

    def start_ns(self):
        return self._v[4]

    def end_ns(self):
        return self._v[5]

    def duration_ns(self):
        return self._v[5] - self._v[4]

    def is_user_annotation(self):
        return self._v[6]


def test_stage_table_attributes_device_events():
    """Device events go to the ranges around the op that launched them
    (or around the range that launched them), nested ranges to their
    parents too; the rest, unlinked events included, to no stage; the
    device-side spans of ranges count nowhere."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event(ss.FRONTEND_TOTAL, cpu, 1, 0, 0, 100, True),
        _Event("frontend: pyramids", cpu, 2, 0, 10, 20, True),
        _Event("aten::add", cpu, 3, 0, 12, 14),
        _Event("aten::mul", cpu, 4, 0, 50, 60),
        _Event(ss.FILTER_TOTAL, cpu, 5, 0, 200, 300, True),
        _Event(ss.LOST_PARENT, cpu, 6, 0, 210, 260, True),
        _Event("lost: triangulate", cpu, 7, 0, 220, 230, True),
        _Event("aten::mm", cpu, 8, 0, 225, 226),
        _Event("aten::copy_", cpu, 9, 0, 400, 401),
        _Event("cudaLaunchKernel", cpu, 100, 3, 13, 14),
        _Event("add_kernel", cuda, 101, 3, 1000, 1003),  # in pyramids
        _Event("mul_kernel", cuda, 102, 4, 1010, 1015),  # frontend, no stage below it
        _Event("hand_kernel", cuda, 103, 7, 1020, 1027),  # launched by the triangulate range
        _Event("gemm", cuda, 104, 8, 1030, 1041),  # in triangulate
        _Event("copy", cuda, 105, 9, 1050, 1063),  # outside both totals
        _Event("orphan", cuda, 106, 999, 1070, 1087),  # no launching op
        _Event(ss.FRONTEND_TOTAL, cuda, 107, 1, 1000, 1015, True),  # device-side span of a range
        # Two hand kernels with no launching op, placed by the launch log.
        _Event("lk_corr_align_kernel(float const*)", cuda, 108, 0, 1100, 1119),
        _Event("lk_corr_align_kernel(float const*)", cuda, 109, 0, 1120, 1143),
    ]
    log = [("lk_corr_align", (ss.FRONTEND_TOTAL, "frontend: pyramids")), ("lk_corr_align", ())]
    t = ss.stage_table(events, frames=1, launches=log)
    ms = {label: r["device_ms"] * 1e6 for label, r in t["stages"].items()}
    assert ms["frontend: pyramids"] == 3 + 19 and ms[ss.FRONTEND_TOTAL] == 8 + 19
    assert ms["lost: triangulate"] == 18 and ms[ss.LOST_PARENT] == 18 and ms[ss.FILTER_TOTAL] == 18
    assert ms["lost: Schur gating"] == 0 and ms["filter: camera prune"] == 0
    assert t["device_ms"] * 1e6 == 3 + 5 + 7 + 11 + 13 + 17 + 19 + 23 and t["device_ops"] == 8
    assert t["rest_ms"] * 1e6 == 53 and [r["name"] for r in t["rest_top"]][:2] == [
        "lk_corr_align_kernel(float const*)", "orphan"]
    assert (t["hand_launches"], t["hand_events"], t["hand_rest_ms"] * 1e6) == (2, 2, 23)
    assert t["stages"]["lost: triangulate"]["device_ops"] == 2 and t["stages"][ss.FRONTEND_TOTAL]["calls"] == 1
    assert t["stages"][ss.FILTER_TOTAL]["host_ms"] * 1e6 == 100
    assert t["stages"][ss.FRONTEND_TOTAL]["share"] == 27 / 98
