"""Driver ``closed_loop_batches``: one caller sends batch after batch,
each as soon as the last is enqueued, cycling over a pool of input batches
made in set-up; the window ends in a synchronise.

Traffic keys: ``entry`` (a module of ``benchmark/entries``), ``pool``
(input batches made in set-up), ``warm_calls``, ``sample_calls`` (calls
whose answers are kept, drawn from the seed), ``trace_calls`` (calls in
the profiled slice), and the generator's parameters
(``benchmark.generators.surface_batch``). Reports ``surfaces_per_s``:
every surface of every call enqueued in the window over the window's
seconds, from its start to the synchronise after the last call.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, harness, trace
from benchmark.harness import STARTED, Run, Sample
from benchmark.reference import spline


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, traced: bool, device, control: bool = False) -> Run:
    cfg, traffic = cell.config, cell.traffic
    t_driver = time.perf_counter()
    entry = cell.module("entry")
    state = entry.setup(cfg, traffic, seed, device)
    pool = len(state["pool"])
    _sync(device)
    t_inputs = time.perf_counter()
    for i in range(traffic["warm_calls"]):
        entry.call(state, i % pool)
    _sync(device)
    if traced:
        trace.warm_up(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    harness.quiet_collector()
    t_warm = time.perf_counter()
    setup_s = t_warm - STARTED
    # set-up by phase: imports to the driver, the card's first use and the
    # input pool, the warm-up calls
    phases = {"to_driver": t_driver - STARTED, "inputs": t_inputs - t_driver,
              "warm_up": t_warm - t_inputs}

    sample = Sample(traffic["sample_calls"], seed)
    ctx = {"calls": 0}
    i = 0

    def one_call(kept_here=True):
        nonlocal i
        slot = i % pool
        if control:
            out = entry.control(state, slot)
            if kept_here and sample.wants(slot):
                sample.items[slot] = (slot, out)
        else:
            out = entry.call(state, slot)
            if kept_here and sample.wants(slot):
                sample.items[slot] = (slot, entry.keep(out))
        del out
        i += 1

    t0 = time.perf_counter()
    if traced:
        # a third of the window, a profiled slice from an empty queue, the rest
        while time.perf_counter() < t0 + seconds / 3:
            one_call()
        _sync(device)
        b1 = []
        from iv_interpolation_tpu_torch.ops import tridiag

        def record_b1(args, kwargs, x):
            d = args[1]
            b1.append((d.shape[0], d[0].numel(), d.element_size()))

        def slice_calls():
            # no answer is copied for the comparison inside the slice, so
            # every call in it launches the same kernels
            for _ in range(traffic["trace_calls"]):
                one_call(kept_here=False)

        with trace.recording(tridiag, "tridiag_solve_cuda", record_b1):
            ctx["trace"] = trace.profile(slice_calls)
        ctx.update(calls=traffic["trace_calls"], b1=b1)
    while time.perf_counter() < t0 + seconds:
        one_call()
    _sync(device)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    batch = state["batch"]
    kept = sample.kept()
    slots = {slot for slot, _ in kept}
    state["pool"] = {slot: state["pool"][slot] for slot in slots}
    state.pop("ops", None)
    return Run(setup_s=setup_s, e2e={"surfaces_per_s": i * batch / window}, attempted=i,
               failed=0, memory_peak_bytes=int(peak), ctx=ctx, kept=kept, state=state,
               notes={"calls": i, "window_s": window, "batch": batch,
                      "slots_compared": sorted(slots), "setup_phases_s": phases})


def judge(cell, run: Run) -> dict:
    """The compared numbers over every kept call, against the float64
    reference worked out from the slot's raw quotes, block by block."""
    cfg, limits = cell.config, cell.limits
    entry = cell.module("entry")
    block = spline.BLOCK
    numbers: dict = {}
    for slot, got in run.kept:
        x = entry.inputs(run.state, slot)
        for lo in range(0, x["iv"].shape[0], block):
            sl = slice(lo, lo + block)
            ref = spline.surface(*(x[name][sl].double() for name in ("k", "iv", "T")),
                                 cfg["n_grid"], cfg["butterfly_tolerance"],
                                 cfg["calendar_tolerance"])
            part = compare.surface_numbers({name: got[name][sl] for name in got}, ref,
                                           limits["flag_band_g"], limits["flag_band_w"])
            compare.merge(numbers, part)
    return numbers
