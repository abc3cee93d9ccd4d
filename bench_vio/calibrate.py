"""The readings a cell's limits are set from: the numbers the judge
compares, over sound runs of the program on many seeds (the lower
readings) and over runs of its controls on a few (the upper readings), in
one process so that the set-up's imports and kernel builds are paid once.

    python3 -m bench_vio.calibrate --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 5

The controls run the program one precision below the configuration's:
``tf32``, the filter's (and the front end's) products at ``'default'``
(TF32 on the card) where the configuration states full float32; ``bf16``,
the front end at ``'bfloat16'`` (one bf16 pass in its kernels, pyramids
and products), since TF32 reaches no product of the tracker.  With
``--fault-seeds``, the fault ``field`` hands each lane the images of its
neighbour's landmark field.  Each run is a short window at the cell's own
sizes and load, with every ``--check-every`` frames checked; with
``--methods`` the filter is also judged by the reference's other update
methods (their numbers suffixed ``@<method>``).  Prints one JSON line per
run and the largest reading of each number per side; nothing here runs in
a benchmark run."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time

TF32 = {"frontend": {"matmul_precision": "default"}, "filter": {"matmul_precision": "default"}}
BF16 = {"frontend": {"matmul_precision": "bfloat16"}}
CONTROLS = {"tf32": TF32, "bf16": BF16}


@contextlib.contextmanager
def neighbour_field():
    """The program's step sees lane b-1's images in lane b."""
    from msckf_stereo_c_torch.models import vio

    real = vio.batched_vio_step

    def step(state, img0, img1, *args, **kwargs):
        return real(state, img0.roll(1, 0), img1.roll(1, 0), *args, **kwargs)

    vio.batched_vio_step = step
    try:
        yield
    finally:
        vio.batched_vio_step = real


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None, device=None, cell=None, config=None) -> int:
    """With ``device`` None the card; a test passes another device and may
    pass the cell's and configuration's dicts (smaller sizes)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default=",".join(CONTROLS), help="the controls to run, of " + ", ".join(CONTROLS))
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--check-every", type=float, default=4.0)
    ap.add_argument("--methods", default="", help="further reference update methods, e.g. schur")
    args = ap.parse_args(argv)

    import torch

    from .harness import load_json, run_cell
    from .judge import measure

    if device is None and not torch.cuda.is_available():
        raise SystemExit("calibration reads the card")
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cell = dict(load_json("cells", args.workload) if cell is None else cell, check_every=args.check_every)
    config = load_json("configs", cell["config"]) if config is None else config
    worst = {}
    runs = [("program", s, None) for s in _seeds(args.seeds)]
    runs += [(name, s, CONTROLS[name]) for name in filter(None, args.controls.split(","))
             for s in _seeds(args.control_seeds)]
    runs += [("field", s, None) for s in _seeds(args.fault_seeds) if int(cell["lanes"]) > 1]
    for side, seed, overrides in runs:
        t0 = time.perf_counter()
        try:
            with neighbour_field() if side == "field" else contextlib.nullcontext():
                run = run_cell(cell, config, seed, args.seconds, False, device, t0, overrides)
            numbers = measure(run, config)
            for method in filter(None, args.methods.split(",")):
                numbers.update({f"{k}@{method}": v for k, v in measure(run, config, method).items()
                                if k.split("_")[0] in ("pose", "att", "cov")})
            extra = dict(frames=run.window.frames, checks=len(run.checks), failed=run.failed)
            del run
        except (RuntimeError, ValueError) as e:  # a control that crashes has failed and sets no reading
            numbers, extra = {}, dict(error=repr(e)[:300])
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(dict(side=side, seed=seed, **extra, numbers=numbers, s=round(time.perf_counter() - t0, 1))),
              flush=True)
        for name, value in numbers.items():
            w = worst.setdefault(side, {})
            w[name] = max(w.get(name, value), value) if value == value else float("nan")
    print(json.dumps(dict(largest=worst)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
