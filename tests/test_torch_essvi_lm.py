"""The joint eSSVI calibration kernel's wrapper (``ops/cuda/essvi_lm.py``),
the block route's choice between it and the eager loop in
``ops.essvi.fit_essvi_batched``, its counters, and the benchmark's reader of
its span (``benchmark/metrics/essvi_kernel_ms.essvi.py``).

The kernel's plain version is the eager loop ``ops.essvi._fit_essvi_block``
itself, which ``tests/test_torch_essvi.py`` holds to the JAX package. On the
CPU the wrapper runs it and is held to it exactly.

The ``card`` tests hold the kernel to the eager loop on the card and skip
without one. Tolerances and their reasons:

  * float64: parameters and cost within 1e-10 of their size (a parameter's
    size taken as at least 1e-4), the port's tolerance against the
    reference; in an edge case, within ten times the eager loop's own gap
    between the card and CPU tensors where that is larger (one 1-day slice
    alone is ill-conditioned enough to move both by about 1e-9). Both run
    one algorithm from one start; the kernel's
    closed-form slice Jacobian, its sums' order and its fused multiply-adds
    round differently from forward mode and the einsums (the gap reads about
    1e-14 on the book's surfaces). Accepted-step counts and convergence
    flags are equal, except on a surface where some trial's cost ties the
    current one within 1e-12 of it (float64 rounding, magnified by the
    normal equations, can then decide the other way); such surfaces are
    counted and reported, and where their decisions differ their
    parameters are not compared;
  * float32: two float32 LMs that round differently take different
    accept/reject decisions, so the kernel is held to the cell's own limits
    against the float64 reference calibration (``benchmark/reference/
    essvi.py``, ``benchmark/limits``): its worse-fit share within the
    cell's limit and no slice off the structural guarantees.

This file imports no JAX, so the card runs it as it is:
``python3 -m pytest --noconftest -o addopts="" -m card tests/test_torch_essvi_lm.py``.
"""

import torch_threads  # noqa: F401

import json
from pathlib import Path

import pytest
import torch

from benchmark import generators, harness
from benchmark.reference import essvi as reference
from iv_interpolation_tpu_torch import _build
from iv_interpolation_tpu_torch.ops import essvi
from iv_interpolation_tpu_torch.ops.cuda import essvi_lm as K
from iv_interpolation_tpu_torch.ops.svi import vega_weights

REPO = Path(__file__).resolve().parent.parent
CELL = "surface_essvi_30x50.own_strikes"
TRAFFIC = json.loads((REPO / "benchmark" / "traffic" / f"{CELL}.json").read_text())
LIMITS = json.loads((REPO / "benchmark" / "limits" / f"{CELL}.json").read_text())
CONFIG = json.loads((REPO / "benchmark" / "configs" / "surface_essvi_30x50.json").read_text())
CW, M, ITERS = CONFIG["calendar_weight"], CONFIG["n_penalty_grid"], CONFIG["lm_iters"]
F32, F64 = torch.float32, torch.float64
SEEDS = [2**33 + 7, 4_000_000_017]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _book(seed: int, batch: int, dtype, device="cpu", E: int = 30, n: int = 50) -> dict:
    """The cell's quotes at ``batch`` surfaces of E x n: k, w = iv^2 T in
    ``dtype``, and iv, T (E = 1 takes the ladder's shortest rung)."""
    q = generators.surface_batch(seed, 0, batch, max(E, 2), n, TRAFFIC, device)
    k, iv, T = (q[name][:, :E].to(dtype) for name in ("k", "iv", "T"))
    return {"k": k.contiguous(), "w": (iv * iv * T[..., None]).contiguous(), "iv": iv, "T": T}


def _grid(k, weights, m: int = M):
    return essvi._penalty_grid(k, torch.ones_like(k) if weights is None else weights,
                               m).to(k.dtype).contiguous()


def _eager(k, w, weights=None, iters=ITERS, cw=CW, m=M):
    wt = torch.ones_like(w) if weights is None else weights
    return essvi._fit_essvi_block(k, w, wt, _grid(k, weights, m), iters, cw)


def _wrapper(k, w, weights=None, iters=ITERS, cw=CW, m=M):
    return K.essvi_lm_cuda(k, w, weights, _grid(k, weights, m), iters, cw)


def _equal(a, b) -> None:
    """Bit for bit, NaN for NaN."""
    for x, y in zip(a, b):
        x, y = x.cpu(), y.cpu()
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype.is_floating_point:
            assert torch.equal(torch.isnan(x), torch.isnan(y))
            x, y = torch.nan_to_num(x), torch.nan_to_num(y)
        assert torch.equal(x, y)


# -- the wrapper on CPU tensors: the eager loop itself ----------------------------

@pytest.mark.parametrize("dtype,weighted", [(F32, False), (F64, False), (F64, True)])
def test_wrapper_runs_the_eager_loop_on_cpu_tensors(dtype, weighted):
    b = _book(SEEDS[0], 3, dtype)
    weights = vega_weights(b["k"], b["w"]).contiguous() if weighted else None
    before = (K.essvi_lm_cuda.launches, K.essvi_lm_cuda.surfaces)
    got = _wrapper(b["k"], b["w"], weights, iters=6)
    _equal(got, _eager(b["k"], b["w"], weights, iters=6))
    assert got.n_accepted.dtype == torch.int32 and got.converged.dtype == torch.bool
    assert (K.essvi_lm_cuda.launches, K.essvi_lm_cuda.surfaces) == before


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    b = _book(SEEDS[0], 2, F32)
    k, w = b["k"], b["w"]
    kp = _grid(k, None)
    call = lambda *a, iters=5, cw=CW: K.essvi_lm_cuda(*a, iters, cw)
    with pytest.raises(TypeError):
        call(k, w.double(), None, kp)
    with pytest.raises(TypeError):
        call(k.half(), w.half(), None, kp.half())
    with pytest.raises(TypeError):
        call(k, w, None, kp.double())
    with pytest.raises(ValueError):
        call(k, w[..., :-1], None, kp)
    with pytest.raises(ValueError):
        call(k, w, w[..., :-1], kp)
    with pytest.raises(ValueError):
        call(k.reshape(-1, 50), w.reshape(-1, 50), None, kp)
    with pytest.raises(ValueError):
        call(k, w, None, kp[:1])
    with pytest.raises(ValueError):
        call(k.repeat(1, 2, 1)[:, :33], w.repeat(1, 2, 1)[:, :33], None, kp)
    with pytest.raises(ValueError):
        call(k[..., :0], w[..., :0], None, kp)
    with pytest.raises(ValueError):
        call(k.transpose(1, 2).contiguous().transpose(1, 2), w, None, kp)
    with pytest.raises(ValueError):
        call(k.to("meta"), w.to("meta"), None, kp.to("meta"))
    with pytest.raises(ValueError):
        call(k, w, None, kp, iters=-1)
    with pytest.raises(TypeError):
        call(k, w, None, kp, iters=2.5)
    with pytest.raises(ValueError):
        call(k, w, None, kp, cw=-1.0)


# -- the block route's choice ---------------------------------------------------

ROUTES = [  # (name, keywords, dtype, E, whether the kernel takes it)
    ("block_f32", {}, F32, 6, True),
    ("block_f64", {}, F64, 6, True),
    ("block_f64_vega", {"vega": True}, F64, 6, True),
    ("block_f64_no_hinge", {"calendar_weight": 0.0}, F64, 6, True),
    ("block_E32", {}, F64, 32, True),
    ("block_E33", {}, F64, 33, False),
    ("dense", {"solver": "dense"}, F64, 6, False),
    ("huber", {"loss": "huber"}, F64, 6, False),
]


@pytest.mark.parametrize("name,kw,dtype,E,kernel", ROUTES, ids=[r[0] for r in ROUTES])
def test_fit_essvi_batched_takes_the_kernel_by_the_rule(monkeypatch, name, kw, dtype, E, kernel):
    """With the device check stubbed to see a card: the kernel for the
    block route (linear loss) in float32 or float64 with E <= 32, the
    eager loop or the dense route otherwise; the weights the caller gave
    (None for unit weights) go to the kernel. On CPU tensors the stubbed
    kernel runs the eager loop, so both routes give the eager loop's fit."""
    b = _book(SEEDS[1], 2, dtype, E=E, n=9)
    kw = dict(kw)
    weights = vega_weights(b["k"], b["w"]) if kw.pop("vega", False) else None
    want = essvi.fit_essvi_batched(b["k"], b["w"], weights, max_iters=3, n_penalty_grid=7, **kw)
    calls = []

    def spy(k, w, wt, k_pen, iters, cw):
        calls.append((wt, iters, cw))
        return K.essvi_lm_cuda(k, w, wt, k_pen, iters, cw)

    monkeypatch.setattr(essvi, "_on_card", lambda t: True)
    monkeypatch.setattr(essvi, "essvi_lm_cuda", spy)
    fit = essvi.fit_essvi_batched
    before = (fit.calls, dict(fit.by_solver), K.essvi_lm_cuda.launches)
    got = fit(b["k"], b["w"], weights, max_iters=3, n_penalty_grid=7, **kw)
    assert len(calls) == int(kernel)
    if kernel:
        wt, iters, cw = calls[0]
        assert (wt is None) == (weights is None) and iters == 3
        assert cw == kw.get("calendar_weight", 10.0)
    _equal(got, want)
    route = "dense" if kw.get("solver") == "dense" or kw.get("loss") == "huber" else "block"
    assert fit.calls - before[0] == 1
    assert {key: fit.by_solver[key] - before[1][key] for key in before[1]} == {
        "block": int(route == "block"), "dense": int(route == "dense")}
    # the plain version on CPU tensors launches nothing
    assert K.essvi_lm_cuda.launches == before[2]


def test_cpu_tensors_keep_the_eager_loop(monkeypatch):
    b = _book(SEEDS[0], 2, F64)
    calls = []
    monkeypatch.setattr(essvi, "essvi_lm_cuda", lambda *a: calls.append(a))
    got = essvi.fit_essvi_batched(b["k"], b["w"], max_iters=4)
    assert calls == []
    _equal(got, _eager(b["k"], b["w"], iters=4))


# -- the benchmark's reader of the kernel's span ------------------------------------

def test_kernel_ms_reader_reads_the_span_and_nothing_without_it():
    from benchmark.spans import DeviceBySpan
    read = harness.reader("essvi_kernel_ms.essvi")
    by = lambda seconds: DeviceBySpan(seconds=seconds, count={}, unspanned_s=0.0, device_s=1.0)
    assert read({}) is None
    assert read({"calls": 2}) is None
    assert read({"spans": by({"iv.essvi.linearize": 2.0}), "calls": 1}) is None
    assert read({"spans": by({"iv.essvi.lm": 0.05}), "calls": 0}) is None
    assert read({"spans": by({"iv.essvi.lm": 0.05, "iv.essvi.init": 0.01}), "calls": 2}) == 25.0


# -- on the card ---------------------------------------------------------------

def _kernel(k, w, weights=None, iters=ITERS, cw=CW, m=M):
    before = (K.essvi_lm_cuda.launches, K.essvi_lm_cuda.surfaces)
    got = _wrapper(k, w, weights, iters, cw, m)
    torch.cuda.synchronize()
    assert (K.essvi_lm_cuda.launches, K.essvi_lm_cuda.surfaces) == (before[0] + 1,
                                                                    before[1] + k.shape[0])
    return got


def _ties(monkeypatch, run) -> torch.Tensor:
    """Surfaces where some trial's cost came within 1e-12 of the current
    cost in the eager loop ``run()``, read from the costs it hands
    ``lm_accept``; and the loop's result."""
    seen = []
    real = essvi.lm_accept

    def watching(state, z_new, cost_new, accept):
        seen.append((cost_new - state[2]).abs() <= 1e-12 * state[2].abs())
        return real(state, z_new, cost_new, accept)

    monkeypatch.setattr(essvi, "lm_accept", watching)
    out = run()
    monkeypatch.setattr(essvi, "lm_accept", real)
    tie = torch.stack(seen).any(dim=0) if seen else torch.zeros_like(out.converged)
    return tie, out


def _close64(monkeypatch, got, run_eager, what: str, tol: float = 1e-10) -> None:
    """The float64 kernel against the eager loop: parameters and cost within
    ``tol`` of their size (the module's tolerance) on every surface whose
    counts and flags are equal; counts and flags equal on every surface
    without a tied trial cost."""
    tie, want = _ties(monkeypatch, run_eager)
    same = (got.n_accepted == want.n_accepted) & (got.converged == want.converged)
    print(f"{what}: {int(tie.sum())} of {tie.numel()} surfaces with a tied trial cost, "
          f"{int((~same).sum())} of them with other decisions")
    assert bool(same[~tie].all())
    keep = same
    assert torch.equal(torch.isnan(got.params), torch.isnan(want.params))
    pa, pb = torch.nan_to_num(got.params[keep]), torch.nan_to_num(want.params[keep])
    gap = (pa - pb).abs() / pb.abs().clamp_min(1e-4)
    assert float(gap.max()) <= tol, float(gap.max())
    ca, cb = got.cost[keep], want.cost[keep]
    assert float(((ca - cb).abs() / cb.abs()).max()) <= tol


@pytest.mark.card
@pytest.mark.parametrize("batch,seed", [(8, SEEDS[0]), (64, SEEDS[1])])
def test_float64_kernel_matches_the_eager_loop(cuda, monkeypatch, batch, seed):
    b = _book(seed, batch, F64, cuda)
    got = _kernel(b["k"], b["w"])
    _close64(monkeypatch, got, lambda: _eager(b["k"], b["w"]), f"book {batch}")


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_float32_kernel_meets_the_cells_limits(cuda, seed):
    b = _book(seed, 512, F32, cuda)
    got = _kernel(b["k"], b["w"])
    assert reference.structure_violations(got.params) == 0
    k, iv, T = (b[name].double() for name in ("k", "iv", "T"))
    w = iv * iv * T[..., None]
    cost = reference.cost(got.params.double(), k, w, reference.penalty_grid(k, M), CW)
    _, best = reference.calibrate(k, iv, T, ITERS, CW, M)
    bad = ~(cost <= best * (1.0 + LIMITS["worse_fit_rel"]) + LIMITS["worse_fit_floor"])
    share = float(bad.double().mean())
    print(f"float32 kernel: worse-fit share {share:.4f}, largest cost over the reference's "
          f"{float((cost / best).max()):.6f}")
    assert share <= LIMITS["numbers"]["worse_fit_share"]


EDGES = ["masked_quotes", "vega_weights", "no_hinge", "crossings", "E1", "E7", "E32",
         "global_route"]


def _edge(name: str, device) -> dict:
    """Quotes and keywords of an edge case, float64."""
    E, n = {"E1": (1, 50), "E7": (7, 50), "E32": (32, 50), "global_route": (32, 100)}.get(
        name, (30, 50))
    b = _book(SEEDS[1], 24, F64, device, E=E, n=n)
    kw: dict = {}
    if name == "masked_quotes":
        weights = torch.ones_like(b["w"])
        weights[:, :, ::7] = 0.0       # every seventh quote masked
        weights[3, 11] = 0.0           # one slice masked whole
        kw["weights"] = weights.contiguous()
    elif name == "vega_weights":
        kw["weights"] = vega_weights(b["k"], b["w"]).contiguous()
    elif name == "no_hinge":
        kw["cw"] = 0.0
    elif name == "crossings":
        # expiries 10 and 11, 20 and 21 quote each other's smiles: the fit
        # cannot follow both without crossing, so hinges are active and the
        # slice-space system couples adjacent expiries
        w = b["w"].clone()
        w[:, [10, 11, 20, 21]] = b["w"][:, [11, 10, 21, 20]]
        return {"k": b["k"], "w": w.contiguous(), "kw": kw}
    return {"k": b["k"], "w": b["w"], "kw": kw}


@pytest.mark.card
@pytest.mark.parametrize("name", EDGES)
def test_kernel_edge_cases_match_the_eager_loop(cuda, monkeypatch, name):
    """Zero-weight quotes and a masked slice, vega weights, no hinge,
    calendar crossings (the coupled system's elimination), one, 7 and 32
    expiries, and quotes that do not fit in shared memory (32 x 100 in
    float64: the kernel reads them in device memory)."""
    case = _edge(name, cuda)
    got = _kernel(case["k"], case["w"], **case["kw"])
    assert bool(torch.isfinite(got.params).all())
    if name == "crossings":
        wp = essvi.essvi_w(got.params, _grid(case["k"], None)[:, None, :])
        assert bool(((wp[:, 1:] - wp[:, :-1]) < 0).any(dim=(-1, -2)).all())
    # where a book's normal equations are ill-conditioned (one 1-day slice)
    # float64 rounding is magnified: the eager loop itself then moves as
    # far between the card and CPU tensors, and the kernel is held to ten
    # times that where it exceeds the module's tolerance
    on_cpu = {key: v.cpu() if isinstance(v, torch.Tensor) else v for key, v in case["kw"].items()}
    own = _eager(case["k"], case["w"], **case["kw"]).params.cpu()
    own_gap = float(((own - _eager(case["k"].cpu(), case["w"].cpu(), **on_cpu).params).abs()
                     / own.abs().clamp_min(1e-4)).max())
    _close64(monkeypatch, got, lambda: _eager(case["k"], case["w"], **case["kw"]), name,
             max(1e-10, 10 * own_gap))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, F64])
def test_fit_essvi_batched_routes_on_the_card(cuda, monkeypatch, dtype):
    """One kernel launch a block call and no eager loop; the dense route,
    the Huber loss and E > 32 keep their paths."""
    eager = []
    real = essvi._fit_essvi_block
    monkeypatch.setattr(essvi, "_fit_essvi_block", lambda *a, **kw: eager.append(1) or real(*a, **kw))
    b = _book(SEEDS[0], 16, dtype, cuda)
    counts = lambda: (K.essvi_lm_cuda.launches, K.essvi_lm_cuda.launches_by_dtype[str(dtype)[6:]],
                      K.essvi_lm_cuda.surfaces, len(eager))
    before = counts()
    fit = essvi.fit_essvi_batched(b["k"], b["w"], max_iters=10)
    assert tuple(a - c for a, c in zip(counts(), before)) == (1, 1, 16, 0)
    assert fit.params.shape == (16, 30, 3) and fit.params.dtype == dtype
    essvi.fit_essvi_batched(b["k"], b["w"], vega_weights(b["k"], b["w"]), max_iters=3)
    assert tuple(a - c for a, c in zip(counts(), before)) == (2, 2, 32, 0)
    essvi.fit_essvi_batched(b["k"][:2], b["w"][:2], max_iters=2, solver="dense")
    essvi.fit_essvi_batched(b["k"][:2], b["w"][:2], max_iters=2, loss="huber")
    wide = _book(SEEDS[0], 2, dtype, cuda, E=33, n=9)
    essvi.fit_essvi_batched(wide["k"], wide["w"], max_iters=2)
    assert tuple(a - c for a, c in zip(counts(), before)) == (2, 2, 32, 1)


@pytest.mark.card
def test_no_host_read_in_the_kernel_route(cuda):
    b = _book(SEEDS[1], 64, F32, cuda)
    essvi.fit_essvi_batched(b["k"], b["w"], max_iters=4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit = essvi.fit_essvi_batched(b["k"], b["w"], max_iters=ITERS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(fit.params).all())


@pytest.mark.card
def test_a_refused_launch_raises(cuda):
    b = _book(SEEDS[0], 2, F32, cuda)
    k, w = b["k"], b["w"]
    kp = _grid(k, None)
    before = K.essvi_lm_cuda.launches
    lib = _build.load_library()
    out = [torch.empty(s, dtype=t, device=cuda)
           for s, t in (((2, 30, 3), F32), ((2,), F32), ((2,), torch.int32), ((2,), torch.bool))]
    z0 = essvi.essvi_init(k, w).contiguous()
    # 33 expiries: more than a warp's lanes; the library refuses it unlaunched
    err = lib.ivt_essvi_lm_f32(k.data_ptr(), w.data_ptr(), None, kp.data_ptr(), z0.data_ptr(),
                               *(a.data_ptr() for a in out), 2, 33, 50, M, ITERS, CW, K.LAMBDA0,
                               K.TOL, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError):
        _build.check_launch(err, "eSSVI calibration")
    with pytest.raises(TypeError):
        K.essvi_lm_cuda(k, w.double(), None, kp, 5, CW)
    with pytest.raises(ValueError):
        K.essvi_lm_cuda(k, w.cpu(), None, kp, 5, CW)
    with pytest.raises(ValueError):
        K.essvi_lm_cuda(k.transpose(1, 2).contiguous().transpose(1, 2), w, None, kp, 5, CW)
    assert K.essvi_lm_cuda.launches == before
