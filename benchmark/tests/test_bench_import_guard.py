"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``iv_interpolation_tpu_torch`` is not
``iv_interpolation_tpu``), and the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
import types

import pytest

from benchmark import harness, run

MODULES = sorted(
    "benchmark." + str(p.relative_to(harness.HERE).with_suffix("")).replace("/", ".")
    for p in harness.HERE.rglob("*.py")
    if "tests" not in p.parts and "metrics" not in p.parts and p.name != "__init__.py")

CHECK = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
from benchmark import harness
for p in (harness.HERE / "metrics").glob("*.py"):
    harness.reader(p.name[:-3])
{extra}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _tops(modules, extra=""):
    code = CHECK.format(root=str(harness.ROOT), modules=modules, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_modules_load_no_jax():
    tops = _tops(MODULES)
    assert not tops & set(run.FORBIDDEN)


# ``run.main`` on CPU tensors: the look for a card answers yes, each cell is
# cut small, and its driver runs on the CPU; the rest of main runs as it is
MAIN_ON_CPU = """
import torch
from benchmark import harness, run
from benchmark.drivers import closed_loop_batches, open_loop_stream
from benchmark.tests.small import small_cell
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda *a: "cpu"
torch.cuda.empty_cache = lambda: None
cells = {{name: small_cell(name) for name in {names!r}}}
harness.load_cell = lambda name, *a, **k: cells[name]
for driver in (closed_loop_batches, open_loop_stream):
    driver.run = (lambda real: lambda cell, seed, seconds, traced, device, **kw:
                  real(cell, seed, seconds, traced, "cpu", **kw))(driver.run)
for name in cells:
    assert run.main(["--workload", name, "--seed", str(2**33 + 5), "--seconds", "0.2",
                     "--trace", "0"]) == 0, name
"""
CELLS = ("surface_cubic_30x50.own_strikes", "surface_cubic_30x50.common_grid",
         "stream_refit_1k.steady")


def test_a_run_of_each_driver_loads_no_jax():
    """Through all of ``run.main``, past the window: the port's counters,
    the reference and the comparison load no JAX either."""
    tops = _tops(MODULES, MAIN_ON_CPU.format(names=CELLS))
    assert "iv_interpolation_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def test_a_module_loaded_after_the_window_withholds_the_result(monkeypatch, capsys):
    """A forbidden module that only the comparison loads, once the window
    has closed, still ends the run with no result line."""
    import torch

    from benchmark.drivers import closed_loop_batches
    from benchmark.tests.small import small_cell

    cell = small_cell("surface_cubic_30x50.common_grid")
    real_run, real_judge = closed_loop_batches.run, closed_loop_batches.judge

    def judge(cell, r):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real_judge(cell, r)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(harness, "load_cell", lambda name, *a, **k: cell)
    monkeypatch.setattr(closed_loop_batches, "run",
                        lambda c, seed, s, traced, device, **kw:
                        real_run(c, seed, s, traced, "cpu", **kw))
    monkeypatch.setattr(closed_loop_batches, "judge", judge)
    assert run.main(["--workload", cell.name, "--seed", "3", "--seconds", "0.2"]) == 3
    out = capsys.readouterr()
    assert '"correct"' not in out.out
    assert "['jax']" in out.err


def test_reference_imports_nothing_of_the_port():
    tops = _tops(["benchmark.reference.spline", "benchmark.reference.stream"])
    assert "iv_interpolation_tpu_torch" not in tops and "iv_interpolation_tpu" not in tops
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] in ("torch", "numpy", "typing", "math", "__future__",
                                           "benchmark") for n in names), (path, names)
            assert all(not n.startswith("benchmark.") or n.startswith("benchmark.reference")
                       for n in names), (path, names)


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "iv_interpolation_tpu_torch_probe", types.ModuleType("x"))
    assert "iv_interpolation_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "iv_interpolation_tpu.ops", types.ModuleType("y"))
    assert run.loaded_forbidden() == ["iv_interpolation_tpu"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "surface_cubic_30x50.own_strikes", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
