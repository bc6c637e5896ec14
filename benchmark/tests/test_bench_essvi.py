"""The eSSVI cell ``surface_essvi_30x50.own_strikes`` on CPU tensors at a
small batch: it loads by name, with the quotes of cubic own_strikes; its
driver runs end to end and its sound run is correct; a stale answer, the
fit stopped after its first iteration and one altered grid value come out
not correct; its reference loads nothing of the port or of JAX.

The fit at half its iterations is no fault here: the joint LM reaches the
float64 calibration's cost to within float32 rounding in about four of its
50 iterations (``tests/test_torch_essvi_book.py``), so at 25 it answers as
at 50."""

import ast

import pytest

from benchmark import harness
from benchmark.drivers.closed_loop_essvi import launches_inside
from benchmark.tests.small import load_cell, run_and_judge, small_cell
from benchmark.tests.test_bench_faults import _altered, _stale
from benchmark.tests.test_bench_import_guard import _tops

CELL = "surface_essvi_30x50.own_strikes"
METRICS = ("essvi_linearize_ms.essvi", "essvi_solve_ms.essvi", "essvi_step_ms.essvi",
           "essvi_solve_launches.essvi")


def test_the_cell_loads_by_name():
    cell = load_cell(CELL)
    assert cell.config["method"] == "essvi" and cell.config["lm_iters"] == 50
    assert cell.config["calendar_weight"] == 10.0 and cell.config["n_penalty_grid"] == 33
    assert cell.traffic["driver"] == "closed_loop_essvi"
    assert {m["name"] for m in cell.end_to_end} == {"surfaces_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS) | {
        "device_ms_per_batch.surface", "launches_per_batch.surface",
        "device_idle_share.surface"}
    cubic = load_cell("surface_cubic_30x50.own_strikes").traffic
    generator_keys = set(cubic) - {
        "driver", "entry", "why", "pool", "warm_calls", "sample_calls", "trace_calls"}
    assert {key: cell.traffic[key] for key in generator_keys} == {
        key: cubic[key] for key in generator_keys}


def test_sound_run_is_correct_and_hands_over_the_essvi_counters():
    run, numbers, correct = run_and_judge(small_cell(CELL), traced=True)
    assert correct, numbers
    assert numbers["structure_violations"] == 0
    assert run.ctx["essvi"] == {"calls": 2, "iterations": 100, "surfaces": 64,
                                "by_solver": {"block": 2, "dense": 0}}
    # CPU tensors launch nothing on a device: no span time, no kernel
    for name in METRICS[:3]:
        assert harness.reader(name)(run.ctx) is None
    assert harness.reader("essvi_solve_launches.essvi")(run.ctx) == 0
    assert harness.reader("essvi_solve_launches.essvi")({"calls": 1}) is None


def _kernel(ts, correlation):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": 1,
            "args": {"correlation": correlation}}


def _launch(ts, correlation, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": tid, "args": {"correlation": correlation}}


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_launches_inside_counts_kernels_launched_in_the_span():
    events = [_span("bench.slice", 0, 1000), _span("iv.essvi.solve", 10, 20),
              _span("iv.essvi.solve", 50, 20), _span("iv.essvi.step", 30, 20),
              _launch(12, 1), _launch(29, 2), _launch(35, 3), _launch(55, 4),
              _launch(60, 5, tid=2), _launch(75, 6)]
    events += [_kernel(100 + i, i) for i in range(1, 7)]
    assert launches_inside(events, "iv.essvi.solve") == 3
    assert launches_inside(events, "iv.essvi.step") == 1
    assert launches_inside(events, "iv.essvi.linearize") is None


def _first_iteration(fn):
    """The fit stopped after the first of its Levenberg-Marquardt iterations."""
    def broken(*args, **kwargs):
        return fn(*args, **dict(kwargs, svi_iters=1))
    return broken


@pytest.mark.parametrize("fault", [_stale, _first_iteration, _altered])
def test_fault_is_caught(fault, monkeypatch):
    from iv_interpolation_tpu_torch.surface import surface
    monkeypatch.setattr(surface, "fit_eval_surface", fault(surface.fit_eval_surface))
    _, numbers, correct = run_and_judge(small_cell(CELL))
    assert not correct, numbers


def test_tf32_reference_control_is_not_correct():
    _, numbers, correct = run_and_judge(small_cell(CELL), control=True)
    assert not correct, numbers


def test_reference_imports_nothing_of_the_port_or_jax():
    tops = _tops(["benchmark.reference.essvi"])
    assert not tops & {"iv_interpolation_tpu_torch", "iv_interpolation_tpu", "jax", "jaxlib"}
    source = (harness.HERE / "reference" / "essvi.py").read_text()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom):
            assert node.module in ("__future__", "torch", "benchmark.reference.spline"), node.module
        elif isinstance(node, ast.Import):
            assert [a.name for a in node.names] == ["torch"]
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in source
    assert "torch.backends.cudnn.allow_tf32 = False" in source
