"""The raw-SVI calibration kernel's plain version and wrapper
(``ops/cuda/svi_lm.py``), and the routing of ``ops.svi.fit_svi_batched``.

On the CPU the wrapper runs the plain version, which repeats the kernel's
arithmetic: the closed-form Jacobian, the 21 sums taken in quote order,
the damped 5 x 5 Cholesky with reciprocal pivots, the generic loop's
acceptance, lambda and convergence rules. It is held to the generic loop
(``ops.lm.levenberg_marquardt_batched`` over ``ops.svi._svi_residual``)
on the benchmark's own slices and on edge cases. Tolerances and their
reasons:

  * float64: parameters within 1e-8 of each other relative to the
    parameter's size (taken as at least 1e-4), equal accepted-step counts and
    convergence flags on at least 99.9 % of slices. Both run the same
    schedule from the same start; the Jacobian (forward mode against the
    closed form with a reciprocal) and the 5 x 5 solve (LAPACK against
    the elementwise factorization) round differently, and along SVI's flat
    (m, sigma) valleys the normal equations magnify a rounding by their
    condition (the gap reads under 1e-9 on the book's slices);
  * float32: two float32 LMs whose roundings differ take different
    accept/reject decisions, so they are held to the float64 reference
    calibration instead (``benchmark/reference/svi.py``): the plain
    version's share of slices that fit worse than the reference by the
    cell's margin is at most the generic loop's plus 0.005.

The ``card`` tests hold the kernel to the plain version on the card and
skip without one: bit for bit (same IEEE operations in the same order,
none fused), against the plain version run on the card and on CPU
tensors. This file imports no JAX, so the card runs it as it is:
``python3 -m pytest --noconftest -o addopts="" -m card tests/test_torch_svi_lm.py``.
"""

import json
from functools import partial
from pathlib import Path

import pytest
import torch

from benchmark import generators
from benchmark.reference import svi as reference
from iv_interpolation_tpu_torch.ops import lm, svi
from iv_interpolation_tpu_torch.ops.cuda import svi_lm as K

REPO = Path(__file__).resolve().parent.parent
CELL = "surface_svi_30x50.own_strikes"
TRAFFIC = json.loads((REPO / "benchmark" / "traffic" / f"{CELL}.json").read_text())
LIMITS = json.loads((REPO / "benchmark" / "limits" / f"{CELL}.json").read_text())
F32, F64 = torch.float32, torch.float64
ITERS = 50
SEEDS = [2**33 + 7, 4_000_000_017]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _book(seed: int, batch: int, device="cpu") -> dict:
    """The cell's quotes at ``batch`` surfaces: k, iv, T as the generator
    draws them (float32)."""
    return generators.surface_batch(seed, 0, batch, 30, 50, TRAFFIC, device)


def _slices(q: dict, dtype) -> tuple:
    """(B E, 50) k and w = iv^2 T in ``dtype``, as the surface step forms them."""
    k, iv, T = (q[name].to(dtype) for name in ("k", "iv", "T"))
    w = iv * iv * T[..., None]
    return k.reshape(-1, 50).contiguous(), w.reshape(-1, 50).contiguous()


def _plain(k, w, weights=None, p0=None, iters=ITERS, lambda0=lm.LAMBDA0):
    p0 = svi.svi_init(k, w) if p0 is None else p0
    return K.svi_lm_plain(k, w, weights, p0, iters, lambda0, lm.TOL, svi.SVI_LOWER,
                          svi.SVI_UPPER)


def _generic(k, w, weights=None, p0=None, iters=ITERS, lambda0=lm.LAMBDA0):
    p0 = svi.svi_init(k, w) if p0 is None else p0
    return lm.levenberg_marquardt_batched(
        partial(svi._svi_residual, butterfly_penalty=0.0), p0, k, w,
        torch.ones_like(w) if weights is None else weights, max_iters=iters, lambda0=lambda0,
        lower=svi.SVI_LOWER, upper=svi.SVI_UPPER)


def _close(a: lm.LMResult, b: lm.LMResult, same_share: float = 1.0) -> None:
    """float64 results of the plain version and the generic loop: the
    module's tolerance, NaN where the other has NaN."""
    assert torch.equal(torch.isnan(a.params), torch.isnan(b.params))
    pa, pb = torch.nan_to_num(a.params), torch.nan_to_num(b.params)
    gap = (pa - pb).abs() / pb.abs().clamp_min(1e-4)
    assert float(gap.max()) <= 1e-8, float(gap.max())
    same = (a.n_accepted == b.n_accepted) & (a.converged == b.converged)
    assert float(same.double().mean()) >= same_share


def _equal(a: lm.LMResult, b: lm.LMResult) -> None:
    """Bit for bit, NaN for NaN."""
    for x, y in zip(a, b):
        x, y = x.cpu(), y.cpu()
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype.is_floating_point:
            assert torch.equal(torch.isnan(x), torch.isnan(y))
            x, y = torch.nan_to_num(x), torch.nan_to_num(y)
        assert torch.equal(x, y)


# -- the plain version against the generic loop --------------------------------

def test_plain_version_matches_the_generic_loop_in_float64():
    k, w = _slices(_book(SEEDS[0], 256), F64)
    _close(_plain(k, w), _generic(k, w), same_share=0.999)


def _worse_fit_share(fit: lm.LMResult, q: dict, best: torch.Tensor) -> float:
    k, iv, T = (q[name].double() for name in ("k", "iv", "T"))
    cost = reference.cost(fit.params.double().reshape(*k.shape[:-1], 5), k, iv * iv * T[..., None])
    bad = ~(cost <= best * (1.0 + LIMITS["worse_fit_rel"]) + LIMITS["worse_fit_floor"])
    return float(bad.double().mean())


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_plain_version_fits_as_well_as_the_generic_loop(seed):
    q = _book(seed, 256)
    k, w = _slices(q, F32)
    _, best = reference.calibrate(*(q[name].double() for name in ("k", "iv", "T")), ITERS)
    plain = _worse_fit_share(_plain(k, w), q, best)
    generic = _worse_fit_share(_generic(k, w), q, best)
    assert plain <= generic + 0.005, (plain, generic)
    assert plain <= LIMITS["numbers"]["worse_fit_share"]


# -- edge cases ----------------------------------------------------------------

def _edge(name: str, dtype=F64, device="cpu") -> dict:
    """Slices, keywords and what each case must show. Every case holds
    some ordinary slices beside the odd ones, which must come out as they
    do without them."""
    q = _book(SEEDS[1], 1)
    k, w = (a[:6] for a in _slices(q, dtype))
    kw: dict = {}
    odd = []
    if name in ("nan_quote", "inf_quote"):
        w = w.clone()
        w[1, 7] = float("nan") if name == "nan_quote" else float("inf")
        odd = [1]
    elif name == "indefinite":
        kw = {"lambda0": -2.0, "iters": 1}    # damping -2 diag: negative pivots
    elif name == "bounds":
        x = torch.linspace(-1.0, 1.0, 50, dtype=dtype)
        k = torch.cat([k[:3], x.expand(3, 50)])
        w = torch.cat([w[:3], torch.stack([0.04 + 0.3 * x.clamp_min(0.0),
                                           0.04 + 0.3 * (-x).clamp_min(0.0),
                                           0.05 + 0.2 * x.abs()])])
    elif name == "vega_weights":
        kw = {"weights": svi.vega_weights(k, w).contiguous()}
    elif name in ("iters_0", "iters_1"):
        kw = {"iters": int(name[-1])}
    elif name == "early_convergence":
        x = torch.linspace(-1.0, 1.0, 50, dtype=dtype)
        p = torch.tensor([0.02, 0.1, -0.3, 0.05, 0.2], dtype=dtype)
        k = torch.cat([k[:3], x.expand(1, 50)])
        w = torch.cat([w[:3], svi.svi_total_variance(p, x)[None]])
    k, w = k.contiguous().to(device), w.contiguous().to(device)
    kw = {key: (v.to(device) if isinstance(v, torch.Tensor) else v) for key, v in kw.items()}
    return {"k": k, "w": w, "kw": kw, "odd": odd}


EDGES = ["nan_quote", "inf_quote", "indefinite", "bounds", "vega_weights", "iters_0",
         "iters_1", "early_convergence"]


@pytest.mark.parametrize("name", EDGES)
def test_edge_case(name):
    case = _edge(name)
    k, w, kw, odd = case["k"], case["w"], case["kw"], case["odd"]
    got = _plain(k, w, **kw)
    ref = _generic(k, w, **kw)
    _close(got, ref)
    assert got.n_accepted.dtype == torch.int32 and got.converged.dtype == torch.bool
    p0 = torch.clamp(svi.svi_init(k, w), svi._bound(svi.SVI_LOWER, w), svi._bound(svi.SVI_UPPER, w))
    if odd:
        # a non-finite cost: every step rejected, nothing moves; the other
        # slices come out as they do alone
        i = odd[0]
        assert int(got.n_accepted[i]) == 0 and not bool(got.converged[i])
        assert not bool(torch.isfinite(got.cost[i]))
        assert torch.equal(torch.nan_to_num(got.params[i]), torch.nan_to_num(p0[i]))
        rest = [j for j in range(k.shape[0]) if j != i]
        _equal(lm.LMResult(*(a[rest] for a in got)), _plain(k[rest], w[rest], **kw))
    if name == "indefinite":
        # one iteration whose damped system has negative pivots: the step
        # is NaN and rejected everywhere
        assert bool((got.n_accepted == 0).all()) and torch.equal(got.params, p0)
        lam_ok = _plain(k, w, iters=1)
        assert bool((lam_ok.n_accepted > 0).any())
    if name == "bounds":
        lo, hi = svi._bound(svi.SVI_LOWER, w), svi._bound(svi.SVI_UPPER, w)
        assert float(got.params[3, 2]) == float(hi[2]) and float(got.params[4, 2]) == float(lo[2])
        assert float(got.params[5, 4]) == float(lo[4])
    if name == "iters_0":
        assert torch.equal(got.params, p0) and bool((got.n_accepted == 0).all())
        assert not bool(got.converged.any())
    if name == "early_convergence":
        # the exact smile converges within a few steps and stays frozen; the
        # improvement test stops it within 1e-9 of the smile's parameters
        assert bool(got.converged[3]) and int(got.n_accepted[3]) < 10
        longer = _plain(k, w, iters=ITERS + 30)
        _equal(lm.LMResult(*(a[3:] for a in longer)), lm.LMResult(*(a[3:] for a in got)))
        torch.testing.assert_close(got.params[3], torch.tensor([0.02, 0.1, -0.3, 0.05, 0.2],
                                                               dtype=F64), rtol=0, atol=1e-8)


# -- the wrapper and the routing on the CPU -------------------------------------

def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    k, w = _slices(_book(SEEDS[0], 2), F32)
    p0 = svi.svi_init(k, w)
    before = (K.svi_lm_cuda.launches, K.svi_lm_cuda.problems)
    got = K.svi_lm_cuda(k, w, None, p0, 7, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER, svi.SVI_UPPER)
    _equal(got, _plain(k, w, p0=p0, iters=7))
    assert (K.svi_lm_cuda.launches, K.svi_lm_cuda.problems) == before


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    k, w = _slices(_book(SEEDS[0], 1), F32)
    p0 = svi.svi_init(k, w)
    call = lambda *a: K.svi_lm_cuda(*a, 5, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER, svi.SVI_UPPER)
    with pytest.raises(TypeError):
        call(k, w.double(), None, p0)
    with pytest.raises(TypeError):
        call(k.half(), w.half(), None, p0.half())
    with pytest.raises(ValueError):
        call(k, w[:, :-1], None, p0)
    with pytest.raises(ValueError):
        call(k, w, w[:, :-1], p0)
    with pytest.raises(ValueError):
        call(k, w, None, p0[:, :4])
    with pytest.raises(ValueError):
        call(k.t().contiguous().t(), w, None, p0)
    with pytest.raises(ValueError):
        call(k[:, :0], w[:, :0], None, p0)
    with pytest.raises(ValueError):
        call(k.to("meta"), w.to("meta"), None, p0.to("meta"))
    with pytest.raises(ValueError):
        K.svi_lm_cuda(k, w, None, p0, -1, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER, svi.SVI_UPPER)
    with pytest.raises(TypeError):
        K.svi_lm_cuda(k, w, None, p0, 2.5, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER, svi.SVI_UPPER)
    with pytest.raises(ValueError):
        K.svi_lm_cuda(k, w, None, p0, 5, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER[:4], svi.SVI_UPPER)


def test_cpu_tensors_keep_the_generic_loop():
    q = _book(SEEDS[0], 2)
    k, w = (a.reshape(2, 30, 50) for a in _slices(q, F64))
    before = (lm.levenberg_marquardt_batched.calls, K.svi_lm_cuda.launches)
    got = svi.fit_svi_batched(k, w, max_iters=6)
    after = (lm.levenberg_marquardt_batched.calls, K.svi_lm_cuda.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    kf, wf = k.reshape(-1, 50), w.reshape(-1, 50)
    want = _generic(kf, wf, iters=6)
    _equal(lm.LMResult(*(a.reshape(60, *a.shape[2:]) for a in got)), want)


# -- on the card ---------------------------------------------------------------

def _kernel(k, w, weights=None, p0=None, iters=ITERS, lambda0=lm.LAMBDA0):
    p0 = svi.svi_init(k, w) if p0 is None else p0
    before = (K.svi_lm_cuda.launches, K.svi_lm_cuda.problems)
    got = K.svi_lm_cuda(k, w, weights, p0, iters, lambda0, lm.TOL, svi.SVI_LOWER,
                        svi.SVI_UPPER)
    torch.cuda.synchronize()
    assert (K.svi_lm_cuda.launches, K.svi_lm_cuda.problems) == (before[0] + 1,
                                                                before[1] + k.shape[0])
    return got


def _on_cpu(k, w, weights=None, **kw):
    return _plain(k.cpu(), w.cpu(), None if weights is None else weights.cpu(), **kw)


@pytest.mark.card
@pytest.mark.parametrize("batch,dtype", [(32768, F32), (32768, F64), (333, F32), (333, F64)])
def test_kernel_matches_the_plain_version_on_the_card(cuda, batch, dtype):
    """The book's slices at the cell's 32,768 x 30 and at a batch that is
    no multiple of a block (333 x 30 = 9,990 slices): bit for bit."""
    k, w = _slices(_book(SEEDS[0], batch, cuda), dtype)
    got = _kernel(k, w)
    _equal(got, _plain(k, w))
    cut = slice(0, 4096)
    _equal(lm.LMResult(*(a[cut] for a in got)), _on_cpu(k[cut], w[cut]))


@pytest.mark.card
@pytest.mark.parametrize("n,weighted", [(186, False), (187, False), (124, True), (125, True)])
def test_both_routes_match_the_plain_version_on_the_card(cuda, n, weighted):
    """Either side of the largest n whose quotes a block stages in shared
    memory (2 or 3 arrays x n x 33 x 4 bytes within 48 KiB); beyond it the
    kernel reads them in device memory."""
    gen = torch.Generator().manual_seed(n)
    x = torch.linspace(-1.0, 1.0, n)
    k = (x + 0.01 * torch.rand(40, n, generator=gen)).contiguous().to(cuda)
    w = (0.04 + 0.1 * x * x + 1e-4 * torch.randn(40, n, generator=gen)).contiguous().to(cuda)
    weights = svi.vega_weights(k, w).contiguous() if weighted else None
    got = _kernel(k, w, weights)
    _equal(got, _plain(k, w, weights))
    _equal(got, _on_cpu(k, w, weights))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", EDGES)
def test_kernel_edge_cases_on_the_card(cuda, name, dtype):
    case = _edge(name, dtype, cuda)
    kw = dict(case["kw"])
    got = _kernel(case["k"], case["w"], **kw)
    _equal(got, _plain(case["k"], case["w"], **kw))
    _equal(got, _on_cpu(case["k"], case["w"], **kw))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, F64])
def test_fit_svi_batched_routes_on_the_card(cuda, dtype):
    q = _book(SEEDS[1], 64, cuda)
    k, w = (a.reshape(64, 30, 50) for a in _slices(q, dtype))
    counters = lambda: (lm.levenberg_marquardt_batched.calls, K.svi_lm_cuda.launches,
                        K.svi_lm_cuda.launches_by_dtype[str(dtype)[6:]])
    before = counters()
    fit = svi.fit_svi_batched(k, w, max_iters=20)
    assert tuple(b - a for a, b in zip(before, counters())) == (0, 1, 1)
    assert fit.params.shape == (64, 30, 5) and fit.params.dtype == dtype
    weights = svi.vega_weights(k, w)
    svi.fit_svi_batched(k, w, weights=weights, max_iters=5, init="quasi")
    assert tuple(b - a for a, b in zip(before, counters())) == (0, 2, 2)
    # a longer or transformed residual takes the generic loop
    for kw in ({"loss": "huber"}, {"butterfly_penalty": 10.0}):
        svi.fit_svi_batched(k, w, max_iters=3, **kw)
    assert tuple(b - a for a, b in zip(before, counters())) == (2, 2, 2)


@pytest.mark.card
def test_wrapper_raises_on_the_card(cuda):
    k, w = _slices(_book(SEEDS[0], 2, cuda), F32)
    p0 = svi.svi_init(k, w)
    call = lambda *a: K.svi_lm_cuda(*a, 5, lm.LAMBDA0, lm.TOL, svi.SVI_LOWER, svi.SVI_UPPER)
    before = K.svi_lm_cuda.launches
    with pytest.raises(TypeError):
        call(k, w.double(), None, p0)
    with pytest.raises(ValueError):
        call(k.t().contiguous().t(), w, None, p0)
    with pytest.raises(ValueError):
        call(k, w[:, :-1], None, p0)
    with pytest.raises(ValueError):
        call(k, w.cpu(), None, p0)
    assert K.svi_lm_cuda.launches == before
