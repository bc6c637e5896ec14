"""Device time by the program's spans (``benchmark.spans``): credit through
launch correlation, on a synthetic trace; a traced run of a cell's own
driver hands its slice's spans over; on a card, the stages of a traced
own_strikes run add up to its device time and B1's span names B1's shapes."""

import re

import pytest
import torch

from benchmark import harness, spans, trace
from benchmark.tests import small

STAGES = ("iv.surface.fit", "iv.surface.grid", "iv.surface.eval", "iv.surface.diagnostics",
          "iv.surface.fit_rmse")


def _correlated():
    """A slice 0-1000 us. Host thread 1 launches inside nested spans; the
    device runs each kernel well after its launch, while later spans are
    open. Thread 2 holds a span that covers every launch of thread 1."""
    def ev(name, cat, ts, dur, corr=None, tid=1):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    return [
        ev("bench.slice", "user_annotation", 0.0, 1000.0),
        ev("iv.surface.fit", "user_annotation", 100.0, 100.0),
        ev("cudaLaunchKernel", "cuda_runtime", 110.0, 2.0, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 120.0, 2.0, corr=6),
        ev("iv.tridiag.b1[staged n=48 batch=10 float32]", "user_annotation", 150.0, 30.0),
        ev("cudaLaunchKernel", "cuda_runtime", 160.0, 2.0, corr=2),
        ev("iv.surface.eval", "user_annotation", 200.0, 100.0),
        ev("iv.spline.bracket", "user_annotation", 210.0, 30.0),
        ev("iv.spline.bracket", "user_annotation", 215.0, 20.0),     # nested, same name
        ev("cuLaunchKernel", "cuda_driver", 220.0, 2.0, corr=3),
        ev("cudaLaunchKernel", "cuda_runtime", 250.0, 2.0, corr=4),
        ev("cudaMemcpyAsync", "cuda_runtime", 320.0, 2.0, corr=5),  # under no span
        ev("iv.surface.diagnostics", "user_annotation", 100.0, 300.0, tid=2),
        # the device: the fit's kernel runs while the host is in the evaluation
        ev("k_fit", "kernel", 250.0, 50.0, corr=1, tid=30),
        ev("thomas_staged", "kernel", 300.0, 20.0, corr=2, tid=30),
        ev("searchsorted", "kernel", 320.0, 10.0, corr=3, tid=30),
        ev("k_eval", "kernel", 330.0, 5.0, corr=4, tid=30),
        ev("Memcpy DtoH", "gpu_memcpy", 340.0, 7.0, corr=5, tid=30),
        ev("k_orphan", "kernel", 350.0, 3.0, corr=99, tid=30),      # no launch in the trace
        ev("k_late", "kernel", 1200.0, 9.0, corr=6, tid=30),        # starts after the slice
    ]


def test_credit_goes_to_the_span_of_the_launch():
    got = spans.device_by_span(_correlated())
    us = {name: s * 1e6 for name, s in got.seconds.items()}
    # k_fit ran during the evaluation but was launched in the fit
    assert us["iv.surface.fit"] == pytest.approx(50 + 20)
    assert us["iv.surface.eval"] == pytest.approx(10 + 5)
    # a span of another thread covers the launches' times, and gets nothing
    assert "iv.surface.diagnostics" not in got.seconds
    assert got.count["iv.surface.diagnostics"] == 1
    assert got.device_s * 1e6 == pytest.approx(50 + 20 + 10 + 5 + 7 + 3)


def test_nested_spans_of_one_name_are_credited_once():
    got = spans.device_by_span(_correlated())
    assert got.seconds["iv.spline.bracket"] * 1e6 == pytest.approx(10)
    assert got.count["iv.spline.bracket"] == 2


def test_a_name_with_brackets_groups_under_its_prefix():
    got = spans.device_by_span(_correlated())
    assert got.seconds["iv.tridiag.b1"] * 1e6 == pytest.approx(20)
    assert got.count["iv.tridiag.b1"] == 1
    assert not any("[" in name for name in list(got.seconds) + list(got.count))


def test_work_launched_outside_every_span_is_unspanned():
    got = spans.device_by_span(_correlated())
    # the copy launched under no span, the kernel whose launch is missing
    assert got.unspanned_s * 1e6 == pytest.approx(7 + 3)
    reading = spans.per_call(got, calls=2)
    assert reading["unspanned_share"] == pytest.approx(100 * 10 / 95)
    assert reading["stage_ms"]["iv.surface.fit"] == pytest.approx(70e-3 / 2)
    assert reading["spans_per_call"]["iv.spline.bracket"] == 1.0
    assert reading["device_ms"] == pytest.approx(95e-3 / 2)


def test_a_trace_without_the_programs_spans_is_all_unspanned():
    bare = [e for e in _correlated() if not e["name"].startswith("iv.")]
    got = spans.device_by_span(bare)
    assert got.count == {} and got.seconds == {}
    assert got.unspanned_s == pytest.approx(got.device_s)


@pytest.mark.parametrize("name, stages", [
    ("surface_cubic_30x50.own_strikes", STAGES),
    ("surface_cubic_30x50.common_grid", ("iv.grid.contract", "iv.surface.diagnostics"))])
def test_a_traced_run_hands_its_spans_over(name, stages):
    cell = small.small_cell(name)
    run, got = spans.traced_run(cell, 2**33 + 5, 0.2, "cpu")
    calls = run.ctx["calls"]
    for stage in stages:
        assert got.count[stage] == calls
    brackets = 4 * calls if name.endswith("own_strikes") else 0
    assert got.count.get("iv.spline.bracket", 0) == brackets
    # the harness's own reduction ran on the same slice, and is restored
    assert run.ctx["trace"].window_s > 0
    assert trace.summarize.__name__ == "summarize"


@pytest.mark.card
def test_own_strikes_stages_add_up_on_the_card(cuda):
    cell = small.small_cell("surface_cubic_30x50.own_strikes")
    cell.config = dict(cell.config, batch=2048)
    run, got = spans.traced_run(cell, 2**33 + 11, 1.0, cuda)
    ctx = run.ctx
    total = harness.reader("device_ms_per_batch.surface")(ctx)
    reading = spans.per_call(got, ctx["calls"])
    assert sum(reading["stage_ms"][name] for name in STAGES) == pytest.approx(total, rel=0.02)
    assert reading["unspanned_share"] < 2.0
    assert got.count["iv.spline.bracket"] == 4 * ctx["calls"]
    # B1's span names the shapes the harness's recording captured
    entry = cell.module("entry")
    slot = sorted(run.state["pool"])[0]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        entry.call(run.state, slot)
        torch.cuda.synchronize()
    (name,) = {e.name for e in prof.events() if e.name.startswith("iv.tridiag.b1[")}
    route, n, batch, dtype = re.fullmatch(r"iv\.tridiag\.b1\[(\w+) n=(\d+) batch=(\d+) (\w+)\]",
                                          name).groups()
    width = torch.empty(0, dtype=getattr(torch, dtype)).element_size()
    assert {(int(n), int(batch), width)} == set(ctx["b1"])
    assert route == "staged"
