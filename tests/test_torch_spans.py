"""The port's named spans (``monitoring.metrics.span``) in the surface step.

A span is a ``torch.profiler.record_function`` only while a profiler
records; otherwise one shared no-op. Under ``profile_trace`` the Chrome
trace holds the stages of ``fit_eval_surface`` (``iv.surface.fit``,
``.grid``, ``.eval``, ``.diagnostics``, ``.fit_rmse``), its two spline
evaluations (each with its bracket search) and its one B1 solve, and
``fit_eval_surface_grid``'s contraction and diagnostics; outputs are bit-equal with and without
them. CPU tensors, CPU activity only.
"""

import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from iv_interpolation_tpu_torch.monitoring import metrics
from iv_interpolation_tpu_torch.monitoring.metrics import StepMetrics, profile_trace, span
from iv_interpolation_tpu_torch.ops.spline_matrix import (build_surface_operators,
                                                          fit_eval_surface_grid)
from iv_interpolation_tpu_torch.surface.surface import common_support_grid, fit_eval_surface

REPO = Path(__file__).resolve().parent.parent
STAGES = ("iv.surface.fit", "iv.surface.grid", "iv.surface.eval", "iv.surface.diagnostics",
          "iv.surface.fit_rmse")


def _smiles(B=3, E=4, n=9, dtype=torch.float64, seed=3):
    """Convex smiles on ascending, per-expiry jittered strikes."""
    g = torch.Generator().manual_seed(seed)
    base = torch.linspace(-0.4, 0.4, n, dtype=torch.float64)
    k = base + 0.02 * torch.rand(B, E, n, generator=g, dtype=torch.float64)
    T = torch.linspace(0.1, 1.5, E, dtype=torch.float64).expand(B, E).contiguous()
    iv = 0.2 + 0.3 * k * k - 0.05 * k + 1e-3 * torch.rand(B, E, n, generator=g,
                                                           dtype=torch.float64)
    return k.to(dtype), iv.to(dtype), T.to(dtype)


def _spans(directory: Path) -> list:
    """The ``iv.`` spans of the one trace in ``directory``, as (name, start, end)
    in start order."""
    (path,) = directory.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("iv."))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_calls_no_record_function(monkeypatch):
    made = []

    class Counting:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with span("iv.a"):
        with span("iv.b"):
            pass
    assert made == []
    assert span("iv.a") is span("iv.b")          # the one shared no-op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("iv.c"):
            pass
    assert made == ["iv.c"]


def test_span_module_imports_no_torch():
    """The monitor's process loads ``monitoring.metrics`` without torch; a
    span there is the no-op and loads none either."""
    code = ("import sys; from iv_interpolation_tpu_torch.monitoring.metrics import span\n"
            "with span('iv.x'):\n    pass\n"
            "print('torch' in sys.modules)")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fit_eval_surface_trace_holds_each_stage_once(tmp_path, dtype):
    B, E, n = 3, 4, 9
    k, iv, T = _smiles(B, E, n, dtype)
    with profile_trace(str(tmp_path)):
        fit_eval_surface(k, iv, T, n_grid=11, spline_bc="not-a-knot")
    spans = _spans(tmp_path)
    counts = Counter(name for name, _, _ in spans)
    kind = str(dtype)[6:]
    b1 = f"iv.tridiag.b1[plain n={n - 2} batch={B * E} {kind}]"
    on_grid = f"iv.spline.eval[plain n={n} m=11 slices={B * E} {kind}]"
    at_quotes = f"iv.spline.eval[plain n={n} m={n} slices={B * E} {kind}]"
    assert counts == Counter({**dict.fromkeys(STAGES, 1), "iv.spline.bracket": 2, b1: 1,
                              on_grid: 1, at_quotes: 1})
    stage = {s[0]: s for s in spans if s[0] in STAGES}
    # the stages follow one another without overlap, in the call's order
    order = [stage[name] for name in STAGES]
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    # B1 under the fit; one evaluation (w, w', w'') with its bracket under
    # the evaluation stage, one (w at the quotes) under fit_rmse
    (solve,) = [s for s in spans if s[0] == b1]
    assert _inside(solve, stage["iv.surface.fit"])
    (grid_eval,) = [s for s in spans if s[0] == on_grid]
    (quote_eval,) = [s for s in spans if s[0] == at_quotes]
    assert _inside(grid_eval, stage["iv.surface.eval"])
    assert _inside(quote_eval, stage["iv.surface.fit_rmse"])
    brackets = [s for s in spans if s[0] == "iv.spline.bracket"]
    assert sum(_inside(s, grid_eval) for s in brackets) == 1
    assert sum(_inside(s, quote_eval) for s in brackets) == 1


def test_fit_eval_surface_grid_trace_holds_contraction_and_diagnostics(tmp_path):
    k, iv, T = _smiles(3, 4, 9, torch.float32)
    knots = k[0]
    ops = build_surface_operators(knots, common_support_grid(knots, 11)[0],
                                  bc_type="not-a-knot")
    with profile_trace(str(tmp_path)):
        fit_eval_surface_grid(ops, iv, T[0])
    spans = _spans(tmp_path)
    assert [name for name, _, _ in spans] == ["iv.grid.contract", "iv.surface.diagnostics"]
    assert spans[0][2] <= spans[1][1]


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[key], b[key]) for key in a)
    return all(_equal(getattr(a, f), getattr(b, f)) for f in ("k", "expiries", "w", "coefs"))


@pytest.mark.parametrize("method,bc", [("cubic_spline", "not-a-knot"), ("cubic_spline", "natural"),
                                       ("smoothing_spline", "natural"), ("svi", "natural"),
                                       ("sabr", "natural")])
def test_outputs_are_bit_equal_with_spans(tmp_path, method, bc):
    k, iv, T = _smiles(2, 3, 9, torch.float64)
    kwargs = dict(method=method, n_grid=11, spline_bc=bc, svi_iters=4, smoothing_lam=1e-4)
    plain = fit_eval_surface(k, iv, T, **kwargs)
    with profile_trace(str(tmp_path)):
        traced = fit_eval_surface(k, iv, T, **kwargs)
    assert _equal(plain, traced)
    assert Counter(name for name, _, _ in _spans(tmp_path) if name in STAGES) == Counter(STAGES)


def test_grid_outputs_are_bit_equal_with_spans(tmp_path):
    k, iv, T = _smiles(3, 4, 9, torch.float32)
    ops = build_surface_operators(k[0], common_support_grid(k[0], 11)[0])
    plain = fit_eval_surface_grid(ops, iv, T[0])
    with profile_trace(str(tmp_path)):
        traced = fit_eval_surface_grid(ops, iv, T[0])
    assert _equal(plain, traced)


def test_step_leaves_its_span_in_the_trace(tmp_path):
    steps = StepMetrics()
    with profile_trace(str(tmp_path)):
        with steps.step("fused/L64", items=5):
            torch.ones(64).cumsum(0)
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events if e.get("cat") == "user_annotation"] == ["fused/L64"]
    (rec,) = steps.steps
    assert rec["name"] == "fused/L64" and rec["items"] == 5 and rec["wall_s"] > 0
    with steps.step("fused/L64"):                  # no profiler: the no-op
        assert metrics.span("x") is metrics.span("y")
    assert len(steps.steps) == 2
