"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, when traced,
``breakdown``; ``checks`` last, each number compared beside its limit,
which also close standard error. Without a card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # caches at fixed paths inside the checkout; no library may load JAX
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.Cell(ROOT, args.workload)
    import torch

    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: cell {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    if chips != 1:
        print(f"run.py: cell {args.workload} asks for {chips} chips; this harness runs "
              "one-chip cells", file=sys.stderr)
        return 1
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"run.py: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 1
    for line in harness.notes(result) + harness.summary_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
