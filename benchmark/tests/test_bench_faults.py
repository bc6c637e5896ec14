"""``correct`` comes out false when the timed path is broken underneath:
the rest of a run is driven on CPU tensors at a small size (the harness's
look for a card skipped), with each fault a cell can have planted in the
program. The exchange between chips is no fault of these one-chip cells.
The unbroken runs come out correct."""

import pytest
import torch

from benchmark.tests.small import load_cell, run_and_judge, small_cell

SURFACE = {
    "surface_cubic_30x50.own_strikes": ("iv_interpolation_tpu_torch.surface.surface",
                                        "fit_eval_surface"),
    "surface_cubic_30x50.common_grid": ("iv_interpolation_tpu_torch.ops.spline_matrix",
                                        "fit_eval_surface_grid"),
}
OUTPUTS = ("w_grid", "iv_grid", "butterfly_ok", "calendar_ok")


def _stale(fn):
    """A step that returns its state unchanged: every call answers with the
    first call's result."""
    first = []

    def broken(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]
    return broken


def _half(fn):
    """Half of the batch left out: the second half answers the mean of the
    first half's results."""
    def broken(*args, **kwargs):
        out = dict(fn(*args, **kwargs))
        half = out["w_grid"].shape[0] // 2
        for name in ("w_grid", "iv_grid"):
            a = out[name].clone()
            a[half:] = a[:half].mean(dim=0)
            out[name] = a
        return out
    return broken


def _altered(fn):
    """One answer altered where it is produced: one grid value of one
    surface moved by 10 % of itself."""
    def broken(*args, **kwargs):
        out = dict(fn(*args, **kwargs))
        w = out["w_grid"].clone()
        w[0, 0, 7] *= 1.1
        out["w_grid"] = w
        return out
    return broken


@pytest.mark.parametrize("name", sorted(SURFACE) + ["stream_refit_1k.steady"])
def test_sound_run_is_correct(name):
    _, numbers, correct = run_and_judge(small_cell(name))
    assert correct, numbers


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("name", sorted(SURFACE))
def test_surface_fault_is_caught(name, fault, monkeypatch):
    module, attr = SURFACE[name]
    mod = __import__(module, fromlist=[attr])
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    _, numbers, correct = run_and_judge(small_cell(name))
    assert not correct, numbers


def _session():
    from iv_interpolation_tpu_torch.pipeline import stream_service
    return stream_service.StreamingSession


def test_stream_state_unchanged_is_caught(monkeypatch):
    cls = _session()
    real = cls.ingest_ticks
    calls = []

    def ingest(self, ticks):
        """Fills the history, then acknowledges every batch and drops it:
        the ring keeps its state."""
        calls.append(1)
        return real(self, ticks) if len(calls) == 1 else len(ticks["minute"])

    monkeypatch.setattr(cls, "ingest_ticks", ingest)
    _, numbers, correct = run_and_judge(small_cell("stream_refit_1k.steady"))
    assert not correct and numbers["candle_mismatches"] > 0, numbers


def _patch_refit(monkeypatch, change):
    cls = _session()
    real = cls.refit

    def refit(self, now_minute=None):
        out = real(self, now_minute)
        return change(out)

    monkeypatch.setattr(cls, "refit", refit)


def test_stream_half_batch_is_caught(monkeypatch):
    def change(out):
        half = out.w_grid.shape[0] // 2
        w, rv = out.w_grid.clone(), out.realized_vol.clone()
        w[half:] = w[:half].mean(dim=0)
        rv[half:] = rv[:half].mean()
        return out._replace(w_grid=w, realized_vol=rv)

    _patch_refit(monkeypatch, change)
    _, numbers, correct = run_and_judge(small_cell("stream_refit_1k.steady"))
    assert not correct, numbers


def test_stream_altered_answer_is_caught(monkeypatch):
    def change(out):
        w = out.w_grid.clone()
        w[0, 0, 11] *= 1.1
        return out._replace(w_grid=w)

    _patch_refit(monkeypatch, change)
    _, numbers, correct = run_and_judge(small_cell("stream_refit_1k.steady"))
    assert not correct, numbers


@pytest.mark.parametrize("name", ["surface_cubic_30x50.own_strikes", "stream_refit_1k.steady"])
def test_tf32_reference_control_is_not_correct(name):
    """The control of the general surface path and of the stream: the
    reference in the program's place, computed in TF32."""
    _, numbers, correct = run_and_judge(small_cell(name), control=True)
    assert not correct, numbers


@pytest.mark.card
def test_tf32_program_control_is_not_correct_on_the_card(cuda):
    """The control of the operator form: the program with its TF32
    contraction on (cuBLAS on a card; the CPU has no TF32), at the cell's
    own batch: at a few dozen surfaces cuBLAS takes a kernel that TF32
    leaves alone."""
    from benchmark import compare
    cell = small_cell("surface_cubic_30x50.common_grid")
    cell.config = dict(cell.config, batch=load_cell(cell.name).config["batch"])
    driver = cell.module("driver")
    run = driver.run(cell, 2**33 + 9, 0.3, False, "cuda", control=True)
    correct, _ = compare.judge(driver.judge(cell, run), cell.limits["numbers"])
    assert not correct
    assert not torch.backends.cuda.matmul.allow_tf32
