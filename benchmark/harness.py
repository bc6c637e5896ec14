"""What every driver shares: the cell's files found by name, the run's
record, the sample of answers kept for the comparison, and the clock of
set-up.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` is these files, and
no code: its configuration (the ``file`` of its ``configs`` entry), its
traffic ``benchmark/traffic/<cell>.json`` (which names its driver and
entry), its limits ``benchmark/limits/<cell>.json``, and a reader
``benchmark/metrics/<metric>.py`` for each per-layer metric it reports.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import random
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (0.0 where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0
    return age if 0.0 <= age < 3600.0 else 0.0


# the set-up clock starts when the process did
STARTED = time.perf_counter() - process_age_s()


def quiet_collector() -> None:
    """At the end of set-up: collect once and freeze what set-up made, so
    that the garbage collector's passes in the window scan only what the
    window makes."""
    gc.collect()
    gc.freeze()


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def module(self, kind: str):
        """The traffic's ``driver`` (``benchmark/drivers/``) or ``entry``
        (``benchmark/entries/``) module."""
        package = {"driver": "drivers", "entry": "entries"}[kind]
        return importlib.import_module(f"benchmark.{package}.{self.traffic[kind]}")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def entries(path: Path = ROOT / "BENCHMARK.json") -> dict:
    """The entries of ``BENCHMARK.json``, or of another file with its keys
    (a draft that names a cell before it is proven)."""
    spec = _json(path)
    return {key: spec[key] for key in ("configs", "workloads", "end_to_end", "per_layer")}


def load_cell(name: str, root: Path = ROOT, spec: dict | None = None) -> Cell:
    """Cell ``name`` of ``spec`` (default ``BENCHMARK.json``'s entries),
    with its files read from ``root``."""
    spec = entries(root / "BENCHMARK.json") if spec is None else spec
    workloads = {w["name"]: w for w in spec["workloads"]}
    if name not in workloads:
        raise SystemExit(f"no workload {name!r}: {sorted(workloads)}")
    workload = workloads[name]
    config_entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
    traffic = _json(root / "benchmark" / "traffic" / f"{name}.json")
    if traffic.get("traffic") != workload["traffic"]:
        raise SystemExit(f"traffic file of {name} is for {traffic.get('traffic')!r}")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, workload=workload, config=_json(root / config_entry["file"]),
                traffic=traffic, limits=_json(root / "benchmark" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    """What a driver hands back: the set-up seconds, the end-to-end
    readings, the work attempted and failed, what the per-layer readers
    read (``ctx``), the device's peak memory, the answers kept for the
    comparison (``kept``, with what the driver needs to recompute them in
    ``state``) and lines to print before the result."""
    setup_s: float
    e2e: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    ctx: dict
    kept: list
    state: dict
    notes: dict


class Sample:
    """Answers kept for the comparison: for each of the first ``size``
    input slots, one of the calls made on it, drawn uniformly from the seed
    (reservoir sampling, so the count of calls need not be known), so that
    the answers compared come from distinct inputs."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items: dict = {}
        self.seen: dict = {}

    def wants(self, slot: int) -> bool:
        """Whether the answer of this call on ``slot`` replaces the one kept."""
        if slot >= self.size:
            return False
        self.seen[slot] = self.seen.get(slot, 0) + 1
        return self.rng.randrange(self.seen[slot]) == 0

    def kept(self) -> list:
        return [self.items[slot] for slot in sorted(self.items)]
