"""Run one cell of the port's benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root. The cell's files are found by its name (see
``benchmark/harness.py``); the system under test is the PyTorch port,
``iv_interpolation_tpu_torch``, on one or more CUDA cards. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit. Lines before it carry
what is not a metric: notes of the run, the card and its power limit, the
kernels' launches. Exits 2 without a result where the cards the cell asks
for are not there, 3 where JAX or the JAX package is loaded once the
comparison is done, just before the result would be printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from benchmark import harness  # first: its clock of set-up starts with the process

# every build and kernel cache in fixed directories inside the checkout
_CACHE = harness.ROOT / "build" / "benchmark"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")

FORBIDDEN = ("jax", "jaxlib", "flax", "iv_interpolation_tpu")


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that the benchmark must never load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return {"nvidia_smi": out}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import compare

    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: cell {cell.name} needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = cell.module("driver")
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {}
    if args.trace:
        summary = run.ctx["trace"]
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(m["name"])(run.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    else:
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}

    from iv_interpolation_tpu_torch.ops.cuda.stream_agg import aggregate_ohlcv_cuda
    from iv_interpolation_tpu_torch.ops.cuda.tridiag import tridiag_solve_cuda
    print(json.dumps({"notes": run.notes, "setup_s": run.setup_s, **card(),
                      "b1_launches_by_route": dict(tridiag_solve_cuda.launches_by_route),
                      "b2_launches": aggregate_ohlcv_cuda.launches}), flush=True)

    # the reference runs after the window, with the program's state freed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = driver.judge(cell, run)
    print(json.dumps({"compared": numbers, "reference_s": time.perf_counter() - t0}), flush=True)
    correct, checks = compare.judge(numbers, cell.limits["numbers"])
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device, **result, "checks": checks}
    # after everything the process ran, the comparison included
    found = loaded_forbidden()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
