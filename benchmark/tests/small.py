"""Cells cut to a size a CPU test holds: the widths stay, the batch, the
universe, the window and the load shrink. The cells are BENCHMARK.json's
and, after them, those of ``held_out.json`` that it does not hold yet."""

from benchmark import harness

HELD_OUT = harness.HERE / "tests" / "held_out.json"


def spec() -> dict:
    """BENCHMARK.json's entries, then each held-out entry whose name it
    does not hold (a cell promoted into BENCHMARK.json is read from there)."""
    spec = harness.entries()
    held = harness.entries(HELD_OUT)
    for key, items in spec.items():
        names = {item["name"] for item in items}
        items += [item for item in held[key] if item["name"] not in names]
    return spec


def load_cell(name: str):
    return harness.load_cell(name, spec=spec())


def small_cell(name: str):
    cell = load_cell(name)
    if name.startswith("surface"):
        cell.config = dict(cell.config, batch=32)
        cell.traffic = dict(cell.traffic, pool=2, warm_calls=1, sample_calls=2, trace_calls=2)
    else:
        cell.config = dict(cell.config, underlyings=48, window_minutes=40, tick_capacity=256)
        cell.traffic = dict(cell.traffic, rate=40.0, warm_batches=2, sample_batches=3,
                            trace_batches=4, ticks_per_minute=4.0)
    return cell


def run_and_judge(cell, seed=2**33 + 7, seconds=0.3, control=False, traced=False):
    """A run on CPU tensors and its compared numbers and verdict."""
    from benchmark import compare

    driver = cell.module("driver")
    run = driver.run(cell, seed, seconds, traced, "cpu", control=control)
    numbers = driver.judge(cell, run)
    correct, _ = compare.judge(numbers, cell.limits["numbers"])
    return run, numbers, correct
