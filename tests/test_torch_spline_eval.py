"""The spline-evaluation kernel's plain version, launch plan and wrapper
(``ops/cuda/spline_eval.py``), and the evaluation functions of
``ops/cubic_spline.py`` that go through it.

On the CPU the wrapper runs the plain version: one bracket search, one
gather of each knot array, then S, S' and S''. It equals the three
separate evaluations it replaced (``_three_passes`` below, their code as
it stood) bit for bit, at the shape of every caller of the evaluation.

The ``card`` tests hold the kernel to the plain version on the card and
skip without one. This file imports no JAX, so the card runs it as it is:
``python3 -m pytest --noconftest -o addopts="" -m card tests/test_torch_spline_eval.py``.
"""

import json
from pathlib import Path

import pytest
import torch

from iv_interpolation_tpu_torch.ops import cubic_spline as cs
from iv_interpolation_tpu_torch.ops.cuda import spline_eval as se
from iv_interpolation_tpu_torch.surface.surface import common_support_grid, fit_eval_surface

REPO = Path(__file__).resolve().parent.parent
F32, F64 = torch.float32, torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _three_passes(x, y, M, t):
    """S, S' and S'' as the three evaluation functions computed them
    before they shared one bracket: each its own search and gathers."""
    def interval(*arrays):
        idx = cs._bracket(arrays[0], t)
        batch = idx.shape[:-1]
        lo = [torch.gather(a.expand(*batch, a.shape[-1]), -1, idx) for a in arrays]
        hi = [torch.gather(a.expand(*batch, a.shape[-1]), -1, idx + 1) for a in arrays]
        return lo, hi

    x, y, M = torch.broadcast_tensors(x, y, M)
    (x0, y0, M0), (x1, y1, M1) = interval(x, y, M)
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh
    S = (a * y0 + b * y1
         + ((a * a * a - a) * M0 + (b * b * b - b) * M1) * (hh * hh) / 6.0)
    (x0, y0, M0), (x1, y1, M1) = interval(x, y, M)
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh
    dS = ((y1 - y0) / hh
          + ((-3 * (a * a) + 1) * M0 + (3 * (b * b) - 1) * M1) * hh / 6.0)
    (x0, M0), (x1, M1) = interval(x, M)
    hh = x1 - x0
    d2S = ((x1 - t) * M0 + (t - x0) * M1) / hh
    return S, dS, d2S


def _knots(gen, batch, n, dtype, device="cpu"):
    """Sorted, jittered knots, smile-like values and curvatures."""
    base = torch.linspace(-1.0, 1.0, n, dtype=F64)
    x = base + (0.4 / n) * torch.rand(*batch, n, generator=gen, dtype=F64)
    y = 0.04 + 0.05 * x * x + 1e-3 * torch.rand(*batch, n, generator=gen, dtype=F64)
    M = 0.1 + torch.randn(*batch, n, generator=gen, dtype=F64)
    return [a.to(dtype).to(device) for a in (x, y, M)]


def _case(name, dtype=F32, device="cpu", seed=5):
    """(x, y, M, t) at one caller's shape, small."""
    gen = torch.Generator().manual_seed(seed)
    if name == "grid":                  # fit_eval_surface's grid: stride 0 over expiries
        x, y, M = _knots(gen, (3, 4), 9, dtype, device)
        t = common_support_grid(x, 11)
        assert t.stride()[1] == 0
    elif name == "quotes":              # fit_rmse: the quotes themselves
        x, y, M = _knots(gen, (3, 4), 9, dtype, device)
        t = x
    elif name == "one_point":           # eval_surface: a one-point slice a query
        x, y, M = _knots(gen, (2, 7), 12, dtype, device)
        t = (2.4 * torch.rand(2, 7, generator=gen, dtype=F64) - 1.2).to(dtype).to(device)
        t = t[..., :, None]
    elif name == "timeline":            # cubic_resample: n=719, one timeline for the batch
        x, y, M = _knots(gen, (3,), 719, dtype, device)
        x = (x + 1.0) * 360.0
        t = torch.arange(721, dtype=dtype, device=device).expand(3, 721)
        assert t.stride()[0] == 0
    elif name == "shared_knots":        # knots broadcast against a batch of queries
        x, y, M = _knots(gen, (), 9, dtype, device)
        t = (2.4 * torch.rand(5, 13, generator=gen, dtype=F64) - 1.2).to(dtype).to(device)
    else:
        raise ValueError(name)
    return x, y, M, t


CASES = [("grid", F32), ("quotes", F32), ("one_point", F32), ("timeline", F32),
         ("shared_knots", F32), ("grid", F64), ("quotes", F64), ("timeline", F64)]


@pytest.mark.parametrize("name,dtype", CASES)
def test_plain_route_equals_the_three_evaluations_bit_for_bit(name, dtype):
    x, y, M, t = _case(name, dtype)
    want = _three_passes(x, y, M, t)
    got = cs.eval_cubic_spline_all(x, y, M, t, order=2)
    singles = (cs.eval_cubic_spline(x, y, M, t), cs.eval_cubic_spline_deriv(x, y, M, t),
               cs.eval_cubic_spline_second_deriv(x, y, M, t))
    for w, g, one in zip(want, got, singles):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(one, w)
    assert torch.equal(cs.eval_cubic_spline_all(x, y, M, t, order=0), want[0])
    S, dS = cs.eval_cubic_spline_all(x, y, M, t, order=1)
    assert torch.equal(S, want[0]) and torch.equal(dS, want[1])


@pytest.mark.parametrize("dtype", [F32, F64])
def test_queries_on_knots_and_outside_the_support(dtype):
    gen = torch.Generator().manual_seed(7)
    x, y, M = _knots(gen, (4,), 10, dtype)
    t = torch.cat([x, x[:, :1] - 3.0, x[:, -1:] + 3.0, x[:, :1] - 1e-3,
                   x[:, -1:] + 1e-3], dim=-1)
    want = _three_passes(x, y, M, t)
    got = cs.eval_cubic_spline_all(x, y, M, t)
    for w, g in zip(want, got):
        assert torch.equal(g, w) and bool(torch.isfinite(g).all())
    # on a knot the spline takes the knot's value, to rounding
    tol = 8 * torch.finfo(dtype).eps * float(y.abs().max())
    assert float((got[0][:, :10] - y).abs().max()) <= tol


@pytest.mark.parametrize("n", [2, 3, 4])
def test_few_knots(n):
    gen = torch.Generator().manual_seed(n)
    x, y, M = _knots(gen, (3, 2), n, F64)
    if n == 2:
        M = torch.zeros_like(M)       # the straight line a 2-knot fit gives
    t = (3.0 * torch.rand(3, 2, 17, generator=gen, dtype=F64) - 1.5)
    want = _three_passes(x, y, M, t)
    got = cs.eval_cubic_spline_all(x, y, M, t)
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    if n == 2:
        slope = (y[..., 1:] - y[..., :1]) / (x[..., 1:] - x[..., :1])
        line = y[..., :1] + slope * (t - x[..., :1])
        torch.testing.assert_close(got[0], line, rtol=0, atol=1e-12)
        torch.testing.assert_close(got[1], slope.expand_as(t), rtol=0, atol=1e-12)
        assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("n,m,dtype,slices,want", [
    # the surface step's grid and quotes: 40 slices of 50 a block, 24,320 B
    (50, 50, F32, 983_040, ("staged", 40, 50)),
    # float64 parity mode: the same slices a block, twice the bytes
    (50, 50, F64, 983_040, ("staged", 40, 50)),
    # eval_surface's one-point slices: capped by the 48 KiB of knots
    (50, 1, F32, 65_536, ("staged", 80, 1)),
    # the 30-day timeline: 2 slices of 721 queries a block
    (719, 721, F32, 768, ("staged", 2, 721)),
    (719, 721, F64, 768, ("staged", 2, 721)),
    # a row longer than a block's outputs is cut into chunks
    (30, 5000, F32, 8, ("staged", 1, 2048)),
    # fewer slices than a block would take
    (9, 11, F64, 3, ("staged", 3, 11)),
    # knots beyond 48 KiB: searched in device memory, a slice a block
    (4095, 16, F32, 4, ("staged", 1, 16)),
    (4096, 16, F32, 4, ("global", 1, 16)),
    (2047, 16, F64, 4, ("staged", 1, 16)),
    (2048, 16, F64, 4, ("global", 1, 16)),
])
def test_launch_plan_by_shape(n, m, dtype, slices, want):
    plan = se.spline_eval_plan(n, m, dtype, slices)
    assert tuple(plan) == want
    # a staged block's knots and query offsets fit the kernel's 48 KiB
    if plan.route == "staged":
        assert plan.slices * (3 * n * dtype.itemsize + 8) <= se.SMEM
    assert plan.slices * plan.queries <= max(se.OUTPUTS_A_BLOCK, plan.queries)


def test_launch_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        se.spline_eval_plan(1, 10, F32, 4)
    with pytest.raises(ValueError):
        se.spline_eval_plan(10, 0, F32, 4)


@pytest.mark.parametrize("shape,strides,want", [
    ((32768, 30, 50), (50, 0, 1), (30, 50, 0)),      # the grid over expiries
    ((32768, 30, 50), (1500, 50, 1), (983_040, 0, 50)),  # contiguous quotes
    ((768, 721), (0, 1), (768, 0, 0)),                 # the timeline
    ((4, 7, 1), (7, 1, 1), (28, 0, 1)),                # one-point slices
    ((50,), (1,), (1, 0, 0)),                          # one slice
    ((2, 1, 3, 5), (15, 99, 5, 1), (6, 0, 5)),         # a size-1 dimension drops
    ((2, 3, 4, 5), (60, 0, 5, 1), None),               # three levels: no layout
])
def test_query_layout(shape, strides, want):
    layout = se.query_layout(shape, strides)
    assert layout == want
    if want is None:
        return
    # every slice's row starts where the strides put it
    inner, outer, stride = layout
    batch = shape[:-1]
    for s in range(min(200, torch.Size(batch).numel())):
        idx, rest = [], s
        for size in reversed(batch):
            idx.append(rest % size)
            rest //= size
        offset = sum(i * st for i, st in zip(reversed(idx), strides[:-1]))
        assert (s // inner) * outer + (s % inner) * stride == offset


def test_wrapper_raises_on_what_it_does_not_take():
    x, y, M, t = _case("grid")
    with pytest.raises(TypeError):
        se.spline_eval_cuda(x, y, M.double(), t)
    with pytest.raises(TypeError):
        se.spline_eval_cuda(x, y, M, t.double())
    with pytest.raises(TypeError):
        se.spline_eval_cuda(x.half(), y.half(), M.half(), t.half())
    with pytest.raises(ValueError):                     # mixed devices
        se.spline_eval_cuda(x, y, M, t.to("meta"))
    with pytest.raises(ValueError):                     # no kernel for the device
        se.spline_eval_cuda(*(a.to("meta") for a in (x, y, M, t)))
    with pytest.raises(ValueError):                     # knots of two shapes
        se.spline_eval_cuda(x, y[..., :-1], M, t)
    with pytest.raises(ValueError):                     # batches that do not broadcast
        se.spline_eval_cuda(x, y, M, t[:2, :3])
    with pytest.raises(ValueError):                     # a query with no last dimension
        se.spline_eval_cuda(x[0, 0], y[0, 0], M[0, 0], torch.tensor(0.0))
    with pytest.raises(ValueError):                     # n < 2
        se.spline_eval_cuda(x[..., :1], y[..., :1], M[..., :1], t)
    for results in ((), (0, 0), (3,), (1, 0)):
        with pytest.raises(ValueError):
            se.spline_eval_cuda(x, y, M, t, results)
    with pytest.raises(ValueError):
        cs.eval_cubic_spline_all(x, y, M, t, order=3)


def test_cpu_calls_launch_nothing_and_return_what_was_asked():
    x, y, M, t = _case("grid", F64)
    before = (se.spline_eval_cuda.launches, dict(se.spline_eval_cuda.launches_by_route))
    (d2S,) = se.spline_eval_cuda(x, y, M, t, (2,))
    S, dS = se.spline_eval_cuda(x, y, M, t, (0, 1))
    S2, d2S2 = se.spline_eval_cuda(x, y, M, t, (0, 2))
    want = _three_passes(x, y, M, t)
    assert all(torch.equal(a, b) for a, b in zip((S, dS, d2S, S2, d2S2),
                                                  (want[0], want[1], want[2], want[0], want[2])))
    assert (se.spline_eval_cuda.launches, se.spline_eval_cuda.launches_by_route) == before
    empty = se.spline_eval_cuda(x, y, M, t[..., :0])
    assert all(a.shape == (3, 4, 0) for a in empty)


# -- on the card -------------------------------------------------------------

def _ulps(got, want, dtype, r, x, y, M):
    """Largest |got - want| of result ``r`` (0: S, 1: S', 2: S'') on each
    slice, in units of the dtype's epsilon times the slice's size in that
    result: its largest |value| there, and at least the size of its knots
    in that order (|y|, the secant slopes, |M|), so that a value that
    cancels to near 0 is not measured against itself."""
    knots = (y.abs(), (torch.diff(y, dim=-1) / torch.diff(x, dim=-1)).abs(), M.abs())[r]
    size = torch.maximum(want.abs().amax(dim=-1, keepdim=True),
                         knots.amax(dim=-1, keepdim=True).to(want.device))
    size = size.clamp_min(torch.finfo(dtype).tiny)
    return float(((got - want).abs() / size).max()) / torch.finfo(dtype).eps


# The kernel runs the plain version's operations in its order, each
# rounded on its own with IEEE division, so against the plain version on
# CPU tensors it should read 0. Against the plain version on the card it
# may differ where PyTorch's card kernels do: a division by the scalar 6
# runs there as a product with a rounded 1/6 (at most an ulp in that term
# and an ulp in the sum). ULPS bounds both: 4 ulps of each slice's size.
ULPS = 4.0

CARD_CASES = CASES + [("surface_grid", F32), ("surface_quotes", F32)]


def _card_case(name, dtype, device):
    if name.startswith("surface_"):             # the benchmark's own generator, 4,096 surfaces
        from benchmark import generators
        traffic = json.loads((REPO / "benchmark/traffic/surface_cubic_30x50.own_strikes.json")
                             .read_text())
        q = generators.surface_batch(3_000_000_019, 0, 4096, 30, 50, traffic, device)
        w = q["iv"] * q["iv"] * q["T"][..., None]
        M = cs.fit_cubic_spline(q["k"], w, bc_type="not-a-knot")
        t = common_support_grid(q["k"], 50) if name == "surface_grid" else q["k"]
        return q["k"], w, M, t
    return _case(name, dtype, device)


@pytest.mark.card
@pytest.mark.parametrize("name,dtype", CARD_CASES)
def test_kernel_matches_the_plain_version_on_the_card(cuda, name, dtype):
    x, y, M, t = _card_case(name, dtype, cuda)
    before = se.spline_eval_cuda.launches
    got = se.spline_eval_cuda(x, y, M, t)
    torch.cuda.synchronize()
    assert se.spline_eval_cuda.launches == before + 1
    on_card = se.spline_eval_plain(*torch.broadcast_tensors(x, y, M), t)
    on_cpu = se.spline_eval_plain(*(a.cpu() for a in torch.broadcast_tensors(x, y, M)), t.cpu())
    for r, g, w, c in zip(se.RESULTS, got, on_card, on_cpu):
        assert g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _ulps(g, w, dtype, r, x, y, M) <= ULPS
        assert _ulps(g.cpu(), c, dtype, r, x, y, M) <= ULPS
    # each result alone, and a pair, write what the three together write
    for results in ((0,), (1,), (2,), (0, 2)):
        alone = se.spline_eval_cuda(x, y, M, t, results)
        assert all(torch.equal(a, got[r]) for a, r in zip(alone, results))


@pytest.mark.card
def test_global_route_on_the_card(cuda):
    gen = torch.Generator().manual_seed(9)
    x, y, M = _knots(gen, (3,), 4200, F32, cuda)
    t = (2.4 * torch.rand(3, 300, generator=gen) - 1.2).to(cuda)
    assert se.spline_eval_plan(4200, 300, F32, 3).route == "global"
    routes = dict(se.spline_eval_cuda.launches_by_route)
    got = se.spline_eval_cuda(x, y, M, t)
    assert se.spline_eval_cuda.launches_by_route["global"] == routes["global"] + 1
    want = se.spline_eval_plain(x.cpu(), y.cpu(), M.cpu(), t.cpu())
    for r, g, w in zip(se.RESULTS, got, want):
        assert _ulps(g.cpu(), w, F32, r, x, y, M) <= ULPS


@pytest.mark.card
@pytest.mark.parametrize("seed", [3_000_000_011, 3_000_000_013, 3_170_000_001])
def test_surface_flags_equal_the_plain_path_on_the_card(cuda, seed, monkeypatch):
    from benchmark import generators
    traffic = json.loads((REPO / "benchmark/traffic/surface_cubic_30x50.own_strikes.json")
                         .read_text())
    q = generators.surface_batch(seed, 0, 8192, 30, 50, traffic, cuda)
    kw = dict(method="cubic_spline", n_grid=50, spline_bc="not-a-knot")
    launches = se.spline_eval_cuda.launches
    by = (dict(se.spline_eval_cuda.launches_by_route), dict(se.spline_eval_cuda.launches_by_dtype))
    got = fit_eval_surface(q["k"], q["iv"], q["T"], **kw)
    torch.cuda.synchronize()
    # one launch for w, w' and w'' on the grid, one for w at the quotes
    assert se.spline_eval_cuda.launches == launches + 2
    assert se.spline_eval_cuda.launches_by_route["staged"] == by[0]["staged"] + 2
    assert se.spline_eval_cuda.launches_by_dtype["float32"] == by[1]["float32"] + 2
    monkeypatch.setattr(cs, "spline_eval_cuda",
                        lambda x, y, M, t, results=se.RESULTS: se.spline_eval_plain(x, y, M, t,
                                                                                    results))
    plain = fit_eval_surface(q["k"], q["iv"], q["T"], **kw)
    assert se.spline_eval_cuda.launches == launches + 2
    for key in ("butterfly_ok", "calendar_ok"):
        assert torch.equal(got[key], plain[key]), key
    # w on the grid: S of the spline through (k, w)
    w = q["iv"] * q["iv"] * q["T"][..., None]
    assert _ulps(got["w_grid"], plain["w_grid"], F32, 0, q["k"], w, w) <= ULPS
    assert torch.equal(got["fit"].coefs, plain["fit"].coefs)
