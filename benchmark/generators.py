"""Inputs of every cell, made from ``--seed`` on the device in plain torch.

The formulas follow the port's own bench generators
(``iv_interpolation_tpu_torch/bench.py``: a uniform ATM level and
curvature per surface plus 1e-4 normal noise; grid-scale wiggles for the
adversarial surfaces; sorted tick minutes and a random walk of prices),
widened to what a cell's traffic file asks for. Nothing here imports the
port: the program under test receives only what these functions return.

Every draw comes from a ``torch.Generator`` on the device seeded from
``(seed, stream)``, so one seed gives the same inputs on every run, and
every seed draws the same shapes and the same number of values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
MINUTES_PER_YEAR = 365.25 * 24 * 60
_MIX = 0x9E3779B97F4A7C15  # splits one seed into independent streams


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for draw stream ``stream`` of ``seed``
    (any non-negative integer; the mix keeps it under 2**63)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * _MIX + int(stream) * 0x632BE59BD9B4E019) % (2**63 - 1))
    return gen


def _uniform(gen, lo_hi, shape, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=F32)


def expiry_ladder(gen, batch: int, E: int, days, jitter: float, device) -> torch.Tensor:
    """(batch, E) ascending maturities in years on a geometric ladder from
    ``days[0]`` to ``days[1]`` days; each rung moves by up to ``jitter``
    of a step (below 0.5, so the order and a gap always stay)."""
    lo, hi = math.log(days[0] / 365.0), math.log(days[1] / 365.0)
    rung = torch.arange(E, device=device, dtype=F32).expand(batch, E)
    u = jitter * (2.0 * torch.rand((batch, E), generator=gen, device=device, dtype=F32) - 1.0)
    pos = (rung + u).clamp(0.0, E - 1.0)
    return torch.exp(lo + (hi - lo) * pos / (E - 1))


def own_strikes(gen, batch: int, E: int, n: int, T: torch.Tensor, span, jitter: float,
                device) -> torch.Tensor:
    """(batch, E, n) sorted log-moneyness knots, each expiry its own: a
    standardised span [-z_lo, z_hi] drawn per expiry, knots evenly spaced
    in it and moved by up to ``jitter`` of a spacing (the ends stay), then
    scaled by sqrt(T)."""
    z_lo = _uniform(gen, span, (batch, E, 1), device)
    z_hi = _uniform(gen, span, (batch, E, 1), device)
    j = torch.arange(n, device=device, dtype=F32)
    v = jitter * (2.0 * torch.rand((batch, E, n), generator=gen, device=device, dtype=F32) - 1.0)
    v[..., 0] = 0.0
    v[..., -1] = 0.0
    z = -z_lo + (z_lo + z_hi) * (j + v) / (n - 1)
    return z * torch.sqrt(T)[..., None]


def smiles(gen, k: torch.Tensor, T: torch.Tensor, params: dict, device) -> torch.Tensor:
    """(batch, E, n) implied vols: a smile in standardised moneyness
    z = k / sqrt(T), atm + skew z + curv z^2 with one level, skew and
    curvature a surface, plus normal noise; a share of the surfaces is
    adversarial, with alternating knot wiggles of a drawn amplitude."""
    batch, E, n = k.shape[0], T.shape[-1], k.shape[-1]
    z = k / torch.sqrt(T)[..., None]
    atm = _uniform(gen, params["atm"], (batch, 1, 1), device)
    skew = _uniform(gen, params["skew"], (batch, 1, 1), device)
    curv = _uniform(gen, params["curv"], (batch, 1, 1), device)
    noise = params["noise"] * torch.randn((batch, E, n), generator=gen, device=device, dtype=F32)
    bad = torch.rand((batch, 1, 1), generator=gen, device=device) < params["adversarial_share"]
    amp = _uniform(gen, params["wiggle"], (batch, 1, 1), device)
    sign = 1.0 - 2.0 * (torch.arange(n, device=device) % 2).to(F32)
    return atm + skew * z + curv * z * z + noise + torch.where(bad, amp, 0.0) * sign


def surface_batch(seed: int, slot: int, batch: int, E: int, n: int, params: dict,
                  device) -> dict:
    """One batch of quote surfaces for pool slot ``slot``.

    ``params["strikes"]`` is ``"own"`` (every surface and expiry its own
    strikes and maturities) or ``"common"`` (one standardised grid
    ``linspace(-z, z, n)`` and one maturity ladder for every surface:
    ``k`` is then (E, n) and ``T`` (E,)).
    """
    gen = generator(seed, slot, device)
    if params["strikes"] == "own":
        T = expiry_ladder(gen, batch, E, params["expiry_days"], params["expiry_jitter"], device)
        k = own_strikes(gen, batch, E, n, T, params["span"], params["strike_jitter"], device)
        iv = smiles(gen, k, T, params, device)
        return {"k": k, "iv": iv, "T": T}
    if params["strikes"] == "common":
        T = expiry_ladder(gen, 1, E, params["expiry_days"], 0.0, device)[0]
        z = torch.linspace(-params["grid_z"], params["grid_z"], n, device=device, dtype=F32)
        k = z * torch.sqrt(T)[:, None]
        iv = smiles(gen, k.expand(batch, E, n), T.expand(batch, E), params, device)
        return {"k": k, "iv": iv, "T": T}
    raise ValueError(f"unknown strike layout {params['strikes']!r}")


def chains(seed: int, U: int, E: int, n: int, params: dict, device) -> dict:
    """The stream's quote chains: (U, E, n) own strikes, vols and (U, E)
    maturities, drawn as an own-strikes surface batch is."""
    return surface_batch(seed, 10**6, U, E, n, dict(params, strikes="own"), device)


def tick_stream(seed: int, U: int, minutes: int, params: dict, device) -> dict:
    """Every tick of ``minutes`` market minutes for ``U`` underlyings, in
    arrival order, as host arrays.

    Underlying of popularity rank r (1-based, row r - 1) gets
    Poisson(rate * r^-alpha) ticks a minute. Prices follow a GBM per
    underlying at a drawn annual vol from a drawn start price, with a
    little tick noise; sizes are exponential with the stated mean. A
    share of the ticks arrive late: they are stamped 1..late_max minutes
    before the minute whose batch carries them. Within a minute's batch
    the ticks of all underlyings arrive in a random order.

    Returns ``batch`` (the arrival minute of each tick, ascending),
    ``underlying`` (row), ``minute`` (stamp, relative to minute 0),
    ``price`` and ``size`` (float32), numpy arrays of one length.
    """
    gen = generator(seed, 2 * 10**6, device)
    rank = torch.arange(1, U + 1, device=device, dtype=torch.float64)
    lam = (params["ticks_per_minute"] * rank ** (-params["alpha"])).to(F32)
    counts = torch.poisson(lam.expand(minutes, U).contiguous(), generator=gen).long()
    flat = counts.reshape(-1)
    cell = torch.repeat_interleave(torch.arange(flat.numel(), device=device), flat)
    batch = cell // U
    und = cell % U
    n_ticks = cell.numel()
    late = torch.rand(n_ticks, generator=gen, device=device) < params["late_share"]
    lag = torch.randint(1, params["late_minutes"] + 1, (n_ticks,), generator=gen, device=device)
    stamp = (batch - torch.where(late, lag, 0)).clamp_min(0)
    vol = _uniform(gen, params["vol"], (U,), device).double()
    p0 = _uniform(gen, params["start_price"], (U,), device).double()
    dt = 1.0 / MINUTES_PER_YEAR
    steps = (vol * math.sqrt(dt) * torch.randn((minutes, U), generator=gen, device=device,
                                                dtype=torch.float64)
             - 0.5 * vol * vol * dt)
    log_path = torch.log(p0) + torch.cumsum(steps, dim=0)
    tick_noise = params["tick_noise"] * torch.randn(n_ticks, generator=gen, device=device,
                                                    dtype=torch.float64)
    price = torch.exp(log_path[stamp, und] + tick_noise).to(F32)
    size = (-params["size_mean"]
            * torch.log1p(-torch.rand(n_ticks, generator=gen, device=device,
                                      dtype=torch.float64))).to(F32)
    # arrival order within a minute: a random key, one sort of all ticks
    key = torch.rand(n_ticks, generator=gen, device=device, dtype=torch.float64)
    order = torch.argsort(batch.double() + key)
    host = lambda a: a[order].cpu().numpy()
    return {"batch": host(batch), "underlying": host(und).astype(np.int32),
            "minute": host(stamp), "price": host(price), "size": host(size)}


def schedule(n: int, traffic: dict) -> np.ndarray:
    """Due times in seconds from the window's start of ``n`` batches at the
    traffic's fixed rate (batches/s). With ``burst_factor`` > 1 the rate is
    that many times higher for the first ``burst_s`` seconds of every
    ``burst_every_s`` seconds."""
    rate = float(traffic["rate"])
    factor = float(traffic.get("burst_factor", 1.0))
    if factor == 1.0:
        return np.arange(n) / rate
    every, burst = float(traffic["burst_every_s"]), float(traffic["burst_s"])
    out, t = np.empty(n), 0.0
    for count in range(n):
        out[count] = t
        inside = t - math.floor(t / every) * every < burst
        t += 1.0 / (rate * factor if inside else rate)
    return out
