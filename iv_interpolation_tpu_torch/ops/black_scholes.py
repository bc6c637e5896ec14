"""Vectorised Black-Scholes pricing, Greeks and implied vol (port of
``iv_interpolation_tpu/ops/black_scholes.py``).

Unit conventions as in the reference: theta per day (/365), vega and rho
per 1 % (/100). ``norm.cdf`` is ``torch.special.ndtr``; ``norm.pdf`` is
the closed form ``exp(-x^2 / 2) / sqrt(2 pi)``.
"""

from __future__ import annotations

import math

import torch
from torch.special import ndtr

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _d1_d2(S, K, T, r, sigma):
    sqrtT = torch.sqrt(T)
    d1 = (torch.log(S / K) + (r + 0.5 * sigma**2) * T) / (sigma * sqrtT)
    d2 = d1 - sigma * sqrtT
    return d1, d2


def bs_price(S, K, T, r, sigma, is_call) -> torch.Tensor:
    """Black-Scholes European option price; ``is_call`` is a bool tensor."""
    d1, d2 = _d1_d2(S, K, T, r, sigma)
    disc = torch.exp(-r * T)
    call = S * ndtr(d1) - K * disc * ndtr(d2)
    put = K * disc * ndtr(-d2) - S * ndtr(-d1)
    return torch.where(is_call, call, put)


def bs_greeks(S, S_, T, r, sigma, is_call) -> dict:
    """Closed-form Greeks (broadcastable tensors).

    Args:
      S: underlying price; S_: strike; T: time to maturity (years);
      r: rate; sigma: implied vol; is_call: bool tensor.

    Returns a dict of delta, gamma, theta (per day), vega (per 1 %) and
    rho (per 1 %).
    """
    K = S_
    d1, d2 = _d1_d2(S, K, T, r, sigma)
    sqrtT = torch.sqrt(T)
    pdf_d1 = _pdf(d1)
    disc = torch.exp(-r * T)
    cdf_d1 = ndtr(d1)

    delta = torch.where(is_call, cdf_d1, cdf_d1 - 1.0)
    gamma = pdf_d1 / (S * sigma * sqrtT)
    decay = -S * pdf_d1 * sigma / (2 * sqrtT)
    theta_call = decay - r * K * disc * ndtr(d2)
    theta_put = decay + r * K * disc * ndtr(-d2)
    theta = torch.where(is_call, theta_call, theta_put) / 365.0
    vega = S * pdf_d1 * sqrtT / 100.0
    rho = torch.where(is_call, K * T * disc * ndtr(d2),
                      -K * T * disc * ndtr(-d2)) / 100.0
    return {"delta": delta, "gamma": gamma, "theta": theta,
            "vega": vega, "rho": rho}


def implied_vol(price, S, K, T, r, is_call, sigma0=0.5,
                max_iters: int = 64) -> torch.Tensor:
    """Batched implied vol by safeguarded Newton (vega step, bisection
    fallback) over a fixed ``max_iters`` iterations."""
    lo = torch.full_like(price, 1e-4)
    hi = torch.full_like(price, 5.0)
    sigma = torch.as_tensor(sigma0, dtype=price.dtype,
                            device=price.device).expand(price.shape)
    for _ in range(max_iters):
        p = bs_price(S, K, T, r, sigma, is_call)
        d1, _ = _d1_d2(S, K, T, r, sigma)
        vega = S * _pdf(d1) * torch.sqrt(T)
        too_high = p > price
        lo = torch.where(too_high, lo, sigma)
        hi = torch.where(too_high, sigma, hi)
        newton = sigma - (p - price) / vega.clamp_min(1e-12)
        ok = (newton > lo) & (newton < hi) & torch.isfinite(newton)
        sigma = torch.where(ok, newton, 0.5 * (lo + hi))
    return sigma
