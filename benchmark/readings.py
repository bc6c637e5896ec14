"""The readings that set the limits of ``correct``: a cell's compared
numbers on many seeds of the program and on a few seeds of its control,
all in one process (set-up is paid once for the imports and the card).

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2

Each run is the cell's own driver at the cell's own sizes and load, for a
short window. One JSON line a run on standard output, then a summary: for
each number the largest program reading (the lower reading) and the
smallest control reading (the upper reading).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--spec", default=str(harness.ROOT / "BENCHMARK.json"),
                   help="a file with BENCHMARK.json's entries that names the cell, such as "
                        "benchmark/tests/held_out.json for a cell not yet in BENCHMARK.json")
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, spec=harness.entries(Path(args.spec)))
    driver = cell.module("driver")
    lower, upper = {}, {}
    plan = [(int(s), False) for s in args.seeds.split(",")]
    plan += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        run = driver.run(cell, seed, args.seconds, False, "cuda", control=control)
        numbers = driver.judge(cell, run)
        print(json.dumps({"seed": seed, "control": control, "numbers": numbers,
                          "e2e": run.e2e, "notes": run.notes}), flush=True)
        side = upper if control else lower
        for name, value in numbers.items():
            if control:
                side[name] = min(side.get(name, math.inf), value)
            else:
                side[name] = max(side.get(name, -math.inf), value)
        del run
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
