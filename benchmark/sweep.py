"""The knee of an open-loop stream cell: its driver at each offered rate,
for a short window each, in one process.

    python3 -m benchmark.sweep --workload stream_refit_1k.steady \\
        --spec benchmark/tests/held_out.json \\
        --rates 100,150,200,250,300,10000 --seconds 10 --seed 5

Per rate one JSON line: the rate offered, the batches completed a second,
p95 and p50 latency, the median latency of each quarter of the window (a
backlog that grows shows as rising quarters) and the largest backlog. The
knee is the highest rate whose quarters do not rise; the cell's traffic
file then fixes its rate below it, as a number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    base = harness.load_cell(args.workload, spec=harness.entries(Path(args.spec)))
    driver = base.module("driver")
    for rate in (float(r) for r in args.rates.split(",")):
        cell = dataclasses.replace(base, traffic=dict(base.traffic, rate=rate))
        run = driver.run(cell, args.seed, args.seconds, False, "cuda")
        n = run.notes
        print(json.dumps({"rate": rate, "completed_per_s": n["completed_per_s"],
                          "p95_ms": run.e2e["refit_p95_ms"], "p50_ms": n["latency_p50_ms"],
                          "p50_ms_by_quarter": n["latency_p50_ms_by_quarter"],
                          "backlog_max": n["backlog_max"], "missing": n["missing"],
                          "ticks_per_batch": n["ticks_per_batch"]}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
