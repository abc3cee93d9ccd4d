"""The benchmark of ``msckf_stereo_c_torch``: one run of one cell.

    python3 -m bench_vio.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell is ``BENCHMARK.json``'s workload ``<name>``; its
traffic, sizes and limits are ``bench_vio/cells/<name>.json``, its
configuration ``bench_vio/configs/<config>.json``, and each metric's
reader ``bench_vio/metrics/<metric>.py``.  With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from the cell's first ``trace_frames`` window frames run
under the profiler.

Prints the run's notes on lines starting with ``#``, then, as the last
line of standard output, one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the judge compared, with its limit), and the
same numbers with their limits as the last lines of standard error.
Exits with 2, printing no result, without enough CUDA cards, and with 3
if a JAX module or the JAX package is loaded once the window has closed."""
from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, as near as the harness can take it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# Top-level modules that must not be loaded in the process that prints the
# result, compared whole (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "msckf_stereo_c_tpu")


def forbidden_modules(modules=None) -> list:
    names = {name.split(".")[0] for name in list(sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def applicable(entries: list, workload: str) -> list:
    """The metrics of ``entries`` that the cell ``workload`` reports."""
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


def card_description() -> str:
    """The first card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0].strip() if out else "power limit not read"


def result_line(run, numbers: list, bench: dict, workload: dict, trace: bool) -> dict:
    """The JSON object of the last line."""
    from .judge import is_correct
    from .metrics import reader

    entries = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in applicable(entries, workload["name"]):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": run.kind, "count": int(workload["chips"]),
              "memory_peak_bytes": run.window.peak_bytes}
    out = {"correct": is_correct(numbers), "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if trace and run.trace is not None and run.trace.span is not None:
        from .trace.events import breakdown, busy_ns

        lo, hi = run.trace.span
        device["busy_s"] = busy_ns(run.trace.events, lo, hi) / 1e9
        device["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = breakdown(run.trace.events, lo, hi)
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in numbers}
    return out


def notes(run, card: str) -> list:
    import numpy as np

    w = run.window
    ates = run.ates.max(axis=0) if run.ates.size else np.zeros(0)
    lines = [
        f"card: {card}",
        f"lanes {w.lanes}, frames in the window {w.frames} (lane-frames {w.frames * w.lanes}), "
        f"sequences ended in the window {w.sequences}, window {w.seconds:.3f} s, set-up {run.setup_s:.3f} s",
        f"resident inputs subtracted from peak_mem_gib: {w.resident_bytes} bytes; window peak "
        f"{w.peak_bytes} bytes",
        f"checked every lane at {len(run.checks)} frames (frame in sequence: {[c.k for c in run.checks]})",
    ]
    if ates.size:
        if ates.size <= 16:
            lines.append("lane ATE RMSE (m, worst sequence): " + ", ".join(f"{a:.5f}" for a in ates))
        else:
            q = np.percentile(ates, [0, 50, 100])
            lines.append(f"lane ATE RMSE (m, worst sequence) over {ates.size} lanes: min {q[0]:.5f}, "
                         f"median {q[1]:.5f}, max {q[2]:.5f}")
    if w.frame_ms:
        ms = np.asarray(w.frame_ms)
        lines.append(f"frame ms: mean {ms.mean():.3f}, median {np.median(ms):.3f}, p95 {np.percentile(ms, 95):.3f}, "
                     f"max {ms.max():.3f} over {ms.size} frames")
    if run.trace is not None:
        t = run.trace
        lines.append(f"traced frames {t.frames}; host syncs inside the port {t.syncs} at {t.sync_sites}")
        lines.append(f"LK launches logged / device events: {t.roofline_pairs}")
        for kernel, counts in t.roofline.items():
            lines.append(f"{kernel}: {len(counts)} launches counted, {sum(c.n_bytes for c in counts)} bytes, "
                         f"{sum(c.n_ops for c in counts)} operations, bound {sum(c.bound_ms for c in counts):.6f} ms, "
                         f"device {sum(c.device_ns for c in counts) / 1e6:.6f} ms")
        rows = t.stage_table["stages"]
        lines.append(f"step device ms per frame {t.stage_table['device_ms']:.3f}, in no stage "
                     f"{t.stage_table['rest_ms']:.3f}")
        for label, r in rows.items():
            lines.append(f"  {r['host_ms']:9.3f} host ms {r['device_ms']:9.3f} device ms "
                         f"{100 * r['share']:5.1f}%  {label}")
    return lines


def execute(name: str, seed: int, seconds: float, trace: bool, device=None, cell=None, config=None,
            overrides=None, out=None, err=None) -> int:
    """One run of the workload ``name``; returns the exit code.  With
    ``device`` None the run takes the first CUDA card, and exits with 2
    without as many cards as the cell asks for; a test passes another
    device, and may pass the cell's and configuration's dicts (smaller
    sizes) and ``overrides`` of the program's configuration."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    workload = {w["name"]: w for w in bench["workloads"]}.get(name)
    if workload is None:
        print(f"no workload {name!r} in BENCHMARK.json", file=err)
        return 2
    # Kernel caches live inside the checkout, at fixed paths (the port
    # builds its CUDA sources into build/torch_kernels/).
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")

    import torch

    from .harness import load_json, run_cell
    from .judge import judge, measure

    cell = load_json("cells", name) if cell is None else cell
    if cell["config"] != workload["config"]:
        print(f"cell file names config {cell['config']!r}, BENCHMARK.json {workload['config']!r}", file=err)
        return 2
    config = load_json("configs", cell["config"]) if config is None else config
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
            print(f"the cell needs {workload['chips']} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    card = card_description() if device.type == "cuda" else str(device)
    run = run_cell(cell, config, seed, seconds, trace, device, _T0, overrides)
    values = measure(run, config)
    numbers = judge(values, cell)
    result = result_line(run, numbers, bench, workload, trace)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the process that prints the result: {', '.join(bad)}", file=err)
        return 3
    for line in notes(run, card) + [f"every number the judge reads: {values}"]:
        print(f"# {line}", file=out)
    print(json.dumps(result), file=out, flush=True)
    for key, value, limit in numbers:
        print(f"check {key}: {value!r} (limit {limit!r})", file=err)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    return execute(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
