"""The raw-SVI cell ``surface_svi_30x50.own_strikes`` on CPU tensors at a
small batch: it loads by name, its driver runs end to end and its sound
run is correct; a stale answer, the fit at half its iterations and one
altered grid value come out not correct; its reference loads nothing of
the port or of JAX."""

import ast

import pytest

from benchmark import harness
from benchmark.tests.small import load_cell, run_and_judge, small_cell
from benchmark.tests.test_bench_faults import _altered, _stale
from benchmark.tests.test_bench_import_guard import _tops

CELL = "surface_svi_30x50.own_strikes"


def test_the_cell_loads_by_name():
    cell = load_cell(CELL)
    assert cell.config["method"] == "svi" and cell.config["lm_iters"] == 50
    assert cell.traffic["driver"] == "closed_loop_calibration"
    assert {m["name"] for m in cell.end_to_end} == {"surfaces_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} >= {
        "lm_linearize_ms.svi", "lm_normal_ms.svi", "lm_solve_ms.svi", "lm_step_ms.svi"}
    generator_keys = set(load_cell("surface_cubic_30x50.own_strikes").traffic) - {
        "driver", "entry", "why", "pool", "warm_calls", "sample_calls", "trace_calls"}
    assert {key: cell.traffic[key] for key in generator_keys} == {
        key: load_cell("surface_cubic_30x50.own_strikes").traffic[key] for key in generator_keys}


def test_sound_run_is_correct_and_hands_over_the_lm_counters():
    run, numbers, correct = run_and_judge(small_cell(CELL), traced=True)
    assert correct, numbers
    assert run.ctx["lm"] == {"calls": 2, "iterations": 100, "problems": 100 * 32 * 30}
    # CPU tensors launch nothing on a device: the readers find no span time
    for name in ("lm_linearize_ms.svi", "lm_solve_ms.svi"):
        assert harness.reader(name)(run.ctx) is None
    assert harness.reader("lm_step_ms.svi")({}) is None


def _half_iterations(fn):
    """The fit stopped at half its Levenberg-Marquardt iterations."""
    def broken(*args, **kwargs):
        return fn(*args, **dict(kwargs, svi_iters=kwargs["svi_iters"] // 2))
    return broken


@pytest.mark.parametrize("fault", [_stale, _half_iterations, _altered])
def test_fault_is_caught(fault, monkeypatch):
    from iv_interpolation_tpu_torch.surface import surface
    monkeypatch.setattr(surface, "fit_eval_surface", fault(surface.fit_eval_surface))
    _, numbers, correct = run_and_judge(small_cell(CELL))
    assert not correct, numbers


def test_tf32_reference_control_is_not_correct():
    _, numbers, correct = run_and_judge(small_cell(CELL), control=True)
    assert not correct, numbers


def test_reference_imports_nothing_of_the_port_or_jax():
    tops = _tops(["benchmark.reference.svi"])
    assert not tops & {"iv_interpolation_tpu_torch", "iv_interpolation_tpu", "jax", "jaxlib"}
    tree = ast.parse((harness.HERE / "reference" / "svi.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.module in ("__future__", "torch", "benchmark.reference.spline"), node.module
        elif isinstance(node, ast.Import):
            assert [a.name for a in node.names] == ["torch"]
    source = (harness.HERE / "reference" / "svi.py").read_text()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in source
    assert "torch.backends.cudnn.allow_tf32 = False" in source
