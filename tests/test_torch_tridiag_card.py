"""Kernel B1 on batch-last systems, on the card.

B1's staged route reads (n, batch) arrays that are the transposes of
row-major (batch, n) ones in place, through its batch-last kernel, where
n is a multiple of 16 bytes and the arrays are 16-byte aligned, and
returns x in that layout. Its arithmetic is the system-major kernel's,
the same expressions in the same order, so both give x bit for bit. Other
shapes, other routes and unaligned arrays are copied to row-major and
launch as before.

Every test here needs a card and skips without one. This file imports no
JAX, so the card runs it as it is:
``python3 -m pytest --noconftest -o addopts="" -m card tests/test_torch_tridiag_card.py``.
"""

import torch_threads  # noqa: F401

import json
from pathlib import Path

import pytest
import torch

from iv_interpolation_tpu_torch.ops import tridiag as ops_tridiag
from iv_interpolation_tpu_torch.ops.cubic_spline import fit_cubic_spline
from iv_interpolation_tpu_torch.ops.cuda import tridiag as b1
from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

REPO = Path(__file__).resolve().parent.parent
F32, F64 = torch.float32, torch.float64
CELL = "surface_cubic_30x50"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(n, batch, dtype, device, scale=1.0):
    """Diagonally dominant systems as row-major (batch, n) arrays; at a
    large ``scale`` the diagonals lie near float32's largest values, so
    their reciprocals are subnormal and the kernel's full-division sweep
    runs."""
    g = torch.Generator(device=device).manual_seed(n * 7919 + batch)
    u = lambda lo, hi: torch.empty((batch, n), dtype=dtype, device=device).uniform_(
        lo * scale, hi * scale, generator=g)
    d, dl, du = (u(2.0, 3.0), u(-0.1, 0.1), u(-0.1, 0.1)) if scale > 1 else (
        u(4.0, 6.0), u(-1.0, 1.0), u(-1.0, 1.0))
    b = torch.randn((batch, n), dtype=dtype, device=device, generator=g) * max(1.0, scale / 10)
    return dl, d, du, b


def _layouts():
    return dict(b1.tridiag_solve_cuda.launches_by_layout)


def _row_major_b1(*arrays):
    """B1 as every call reached it before batch-last arrays did: on
    row-major copies."""
    return b1.tridiag_solve_cuda(*(a.contiguous() for a in arrays))


# n=48 x 983,040: the surface step; 166 x 768: the cubic batch (float32
# rows no multiple of 16 bytes); n=3 and n=47: rows no multiple of 16 bytes
# in either dtype; batch 1,000: a partial block; the last case the
# full-division sweep. Where the batch-last kernel does not take the rows,
# the wrapper copies them to row-major and launches the system-major kernel.
CASES = [(48, 983_040, 1.0), (166, 768, 1.0), (3, 4096, 1.0), (47, 4096, 1.0),
         (48, 1000, 1.0), (24, 4096, 1e38)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n,batch,scale", CASES)
def test_batch_last_equals_system_major_bit_for_bit(cuda, n, batch, scale, dtype):
    rows = _rows(n, batch, dtype, cuda, scale)
    plan = b1.thomas_plan(n, dtype, batch, "batch_last")
    lay = "batch_last" if n * dtype.itemsize % 16 == 0 else "system_major"
    assert plan.route == "staged" and plan.layout == lay
    before = _layouts()
    want = b1.tridiag_solve_cuda(*(a.mT.contiguous() for a in rows))
    got = b1.tridiag_solve_cuda(*(a.mT for a in rows))
    torch.cuda.synchronize()
    assert _layouts() == {
        "system_major": before["system_major"] + 1 + (lay == "system_major"),
        "batch_last": before["batch_last"] + (lay == "batch_last")}
    assert got.shape == (n, batch)
    assert got.stride() == ((1, n) if lay == "batch_last" else (batch, 1))
    assert torch.equal(got, want)
    # and the plain loop within 256 ulps of max |x|, as chip_smoke.py holds B1
    plain = b1.tridiag_solve_plain(*(a.mT.contiguous() for a in rows))
    scale_x = max(1.0, float(plain.abs().max()))
    assert float((got - plain).abs().max()) <= 256 * torch.finfo(dtype).eps * scale_x


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, F64])
def test_unaligned_batch_last_arrays_are_copied(cuda, dtype):
    """Batch-last arrays that start off a 16-byte boundary take the copies
    and the system-major kernel, with the same x."""
    n, batch = 48, 1000
    rows = _rows(n, batch, dtype, cuda)
    off = [torch.empty(batch * n + 1, dtype=dtype, device=cuda)[1:].view(batch, n).copy_(a)
           for a in rows]
    assert all(a.data_ptr() % 16 for a in off)
    before = _layouts()
    got = b1.tridiag_solve_cuda(*(a.mT for a in off))
    want = b1.tridiag_solve_cuda(*(a.mT for a in rows))
    torch.cuda.synchronize()
    assert _layouts() == {"system_major": before["system_major"] + 1,
                          "batch_last": before["batch_last"] + 1}
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, F64])
def test_partitioned_shape_launches_the_system_major_kernel(cuda, dtype):
    rows = _rows(719, 768, dtype, cuda)
    assert b1.thomas_plan(719, dtype, 768).route == "partitioned"
    before = _layouts()
    want = b1.tridiag_solve_cuda(*(a.mT.contiguous() for a in rows))
    got = b1.tridiag_solve_cuda(*(a.mT for a in rows))
    torch.cuda.synchronize()
    assert _layouts() == {"system_major": before["system_major"] + 2,
                          "batch_last": before["batch_last"]}
    assert got.is_contiguous() and torch.equal(got, want)


def _cell_quotes(device):
    """One batch of the own_strikes cell, from the benchmark's generator."""
    from benchmark import generators
    cfg = json.loads((REPO / f"benchmark/configs/{CELL}.json").read_text())
    traffic = json.loads((REPO / f"benchmark/traffic/{CELL}.own_strikes.json").read_text())
    q = generators.surface_batch(3_000_000_019, 0, cfg["batch"], cfg["expiries"],
                                 cfg["strikes"], traffic, device)
    return cfg, q


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F32, F64])
def test_fit_is_identical_through_both_layouts(cuda, monkeypatch, dtype):
    _, q = _cell_quotes(cuda)
    k = q["k"].to(dtype)
    w = (q["iv"] * q["iv"] * q["T"][..., None]).to(dtype)
    slope = torch.zeros(k.shape[:-1], dtype=dtype, device=cuda)
    m, batch = k.shape[-1], slope.numel()
    # natural and clamped solve all m knots (50: float32 rows no multiple of
    # 16 bytes, so copied to row-major), not-a-knot the m - 2 inner ones
    for bc, kw, n in (("natural", {}, m), ("clamped", dict(fp0=slope, fpn=slope), m),
                      ("not-a-knot", {}, m - 2)):
        lay = b1.thomas_plan(n, dtype, batch, "batch_last").layout
        assert lay == ("batch_last" if n * dtype.itemsize % 16 == 0 else "system_major")
        before = _layouts()
        got = fit_cubic_spline(k, w, bc_type=bc, **kw)
        torch.cuda.synchronize()
        assert _layouts() == {la: before[la] + (la == lay) for la in b1.LAYOUTS}, bc
        with monkeypatch.context() as mp:
            mp.setattr(ops_tridiag, "tridiag_solve_cuda", _row_major_b1)
            want = fit_cubic_spline(k, w, bc_type=bc, **kw)
        assert torch.equal(got, want), bc
        # batch-last, x comes back as contiguous (..., n) rows
        assert got.is_contiguous() or lay == "system_major", bc


@pytest.mark.card
def test_one_surface_step_launches_b1_once_batch_last(cuda, monkeypatch):
    cfg, q = _cell_quotes(cuda)
    kw = dict(method=cfg["method"], n_grid=cfg["n_grid"], spline_bc=cfg["spline_bc"])
    before = _layouts()
    got = fit_eval_surface(q["k"], q["iv"], q["T"], **kw)
    torch.cuda.synchronize()
    assert _layouts() == {"system_major": before["system_major"],
                          "batch_last": before["batch_last"] + 1}
    with monkeypatch.context() as m:
        m.setattr(ops_tridiag, "tridiag_solve_cuda", _row_major_b1)
        want = fit_eval_surface(q["k"], q["iv"], q["T"], **kw)
    assert torch.equal(got["fit"].coefs, want["fit"].coefs)
    for key, value in got.items():
        if isinstance(value, torch.Tensor):
            other = want[key]
            if value.is_floating_point():
                assert torch.equal(torch.isnan(value), torch.isnan(other)), key
                value, other = torch.nan_to_num(value), torch.nan_to_num(other)
            assert torch.equal(value, other), key
