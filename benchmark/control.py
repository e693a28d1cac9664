"""The readings a cell's limits are set from, on the card at the cell's own
size. The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program] [--control 3]

For each seed (the control's on the first ``--control`` seeds) it prints, as JSON lines, the numbers the cell compares for:

- ``control``: the plain reference put in the program's place and computed
  in the nearest precision below float32, TF32 on (``plain.tf32(True)``),
  against the reference with TF32 off;
- ``half_batch`` (training cells): the reference put in the program's place
  with half of each batch left out, the loss the mean over the rest. A
  step that returns its state unchanged reads 1 in ``moved3_leaf`` by the
  measure's definition and needs no run;
- with ``--program``: the program itself, one run of the cell a seed with a
  short window (``--seconds``), all in this process, the kernels built once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def reference_inputs(cell, seed: int, device: str):
    """The cell's inputs for ``seed`` without the program."""
    from benchmark import inputs
    from benchmark.models import plain

    cfg, mix = cell.cfg, cell.mix
    family = cell.module("models", cfg["family"])
    _, graph_dir = inputs.graph_dir(cell.bench / ".cache", cfg)
    sizes = plain.graph_sizes(graph_dir)
    stats = inputs.statistics(cfg, seed)
    return SimpleNamespace(
        cfg=cfg, mix=mix, family=family, device=device, graph_dir=graph_dir, sizes=sizes,
        stats=stats, mask=inputs.boundary_mask(cfg),
        weights=plain.make_weights(family.param_specs(cfg, sizes), inputs.substream(seed, 0),
                                   device),
        pool=inputs.make_pool(cfg, mix, stats, seed, device), control_tf32=False)


def readings(cell, seed: int, device: str) -> dict:
    from benchmark import checks
    from benchmark.drivers.train import CHECKED_STEPS

    ctx = reference_inputs(cell, seed, device)
    out = {}
    if cell.mix["kind"] == "train":
        ref = checks.reference_training(ctx, CHECKED_STEPS)
        ctx.control_tf32 = True
        out["control"] = checks.training_numbers(checks.reference_training(ctx, CHECKED_STEPS),
                                                 ref)
        ctx.control_tf32 = False
        out["half_batch"] = checks.training_numbers(
            checks.reference_training(ctx, CHECKED_STEPS, half_batch=True), ref)
    else:
        picks = list(range(min(cell.mix["check_samples"], len(ctx.pool))))
        ref = checks.reference_forecasts(ctx, [(j, None) for j in picks])
        ctx.control_tf32 = True
        ctl = checks.reference_forecasts(ctx, [(j, None) for j in picks])
        out["control"] = checks.forecast_numbers(
            [(c[1], r[1]) for c, r in zip(ctl, ref)])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program", action="store_true")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", type=int, default=3,
                        help="take the control's readings on the first this many seeds")
    args = parser.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.Cell(ROOT, args.workload)
    for i, seed in enumerate(args.seeds):
        if args.program:
            result = harness.run_cell(ROOT, args.workload, seed, args.seconds, False)
            print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in
                                                        result["checks"].items()},
                              "correct": result["correct"]}), flush=True)
            torch.cuda.empty_cache()
        if i < args.control:
            print(json.dumps({"seed": seed, **readings(cell, seed, "cuda")}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
