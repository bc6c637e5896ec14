"""The comparison that decides ``correct``: the numbers compared between
what the timed path produced and the plain reference, and the judgement
against each number's limit (``benchmark/limits/<cell>.json``).

Every gap is a maximum over all the values compared and every mismatch a
count, so a number from many samples is the worst of them; a value that
is not finite counts as an infinite gap.
"""

from __future__ import annotations

import math
import sys

import torch

INF = float("inf")


def _worst(gap: torch.Tensor) -> float:
    if gap.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(gap, nan=INF).max())


def surface_numbers(prog: dict, ref: dict, band_g: float, band_w: float) -> dict:
    """Gaps of one block of surfaces.

    ``w_rel_gap``: the largest |w - w_ref| over a slice's grid, as a share
    of the largest |w_ref| on that slice. ``iv_rel_gap``: the largest
    |iv - iv_ref| / iv_ref. ``flag_mismatches``: butterfly and calendar
    flags that differ from the reference's, counted where the reference's
    margin lies more than ``band_g`` (g) or ``band_w`` (w) from the test's
    threshold: nearer, the flag's value is within the rounding of a float32
    evaluation. ``flags_undecided`` counts those left out.
    """
    w_ref = ref["w_grid"]
    w = prog["w_grid"].to(w_ref.dtype)
    scale = w_ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    iv_ref = ref["iv_grid"]
    iv = prog["iv_grid"].to(iv_ref.dtype)
    decided_b = ref["butterfly_margin"].abs() > band_g
    decided_c = ref["calendar_margin"].abs() > band_w
    bad_b = (prog["butterfly_ok"].bool() != (ref["butterfly_margin"] >= 0)) & decided_b
    bad_c = (prog["calendar_ok"].bool() != (ref["calendar_margin"] >= 0)) & decided_c
    return {
        "w_rel_gap": _worst((w - w_ref).abs() / scale),
        "iv_rel_gap": _worst((iv - iv_ref).abs() / iv_ref.abs().clamp_min(1e-300)),
        "flag_mismatches": int(bad_b.sum()) + int(bad_c.sum()),
        "flags_undecided": int((~decided_b).sum()) + int((~decided_c).sum()),
        "butterfly_fail_share": float((ref["butterfly_margin"] < 0).double().mean()),
    }


def candle_numbers(prog, ref: dict) -> dict:
    """Candles of the program (a ``Candles`` of tensors) against the
    reference's (a dict of arrays or tensors). open, high, low and close
    are selections of tick prices and count and valid are integers, so
    each must equal the reference's exactly (NaN where a bucket is empty):
    ``candle_mismatches`` counts the values that differ. ``volume_rel_gap``
    is the largest relative gap of the volumes, a float32 sum against a
    float64 one."""
    as_t = lambda a: torch.as_tensor(a)
    mismatches = 0
    for name in ("open", "high", "low", "close"):
        got = getattr(prog, name).cpu()
        want = as_t(ref[name]).to(got.dtype)
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        mismatches += int((~same).sum())
    mismatches += int((prog.count.cpu().long() != as_t(ref["count"]).long()).sum())
    mismatches += int((prog.valid.cpu().bool() != as_t(ref["valid"]).bool()).sum())
    vol_ref = as_t(ref["volume"]).double()
    vol = prog.volume.cpu().double()
    return {"candle_mismatches": mismatches,
            "volume_rel_gap": _worst((vol - vol_ref).abs() / vol_ref.abs().clamp_min(1e-30))}


def median_scaled_gap(got: torch.Tensor, want) -> float:
    """Largest |got - want| as a share of the median of the nonzero |want|.
    For a realized vol this is steady from seed to seed, where the gap
    relative to each value is not: a row whose few returns nearly cancel
    has a tiny vol whose float32 rounding is a large share of it."""
    want = torch.as_tensor(want).double().cpu()
    got = got.double().cpu()
    nonzero = want.abs()[want != 0]
    scale = float(nonzero.median()) if nonzero.numel() else 1.0
    return _worst((got - want).abs() / scale)


def merge(total: dict, part: dict) -> dict:
    """Worst of two readings: gaps by maximum, counts by sum."""
    for key, value in part.items():
        if key not in total:
            total[key] = value
        elif isinstance(value, int):
            total[key] += value
        else:
            total[key] = max(total[key], value)
    return total


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and the compared numbers beside their limits. Every
    number the limits name must be present, finite and within its limit;
    the numbers and limits go to standard error as the run's last lines."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, INF)
        good = isinstance(value, (int, float)) and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if math.isfinite(value) else str(value),
                        "limit": limit}
    for name, entry in checks.items():
        print(f"check {name} {entry['value']} limit {entry['limit']}", file=sys.stderr)
    print(f"correct {ok}", file=sys.stderr)
    return ok, checks
