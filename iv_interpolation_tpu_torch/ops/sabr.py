"""SABR smile model: Hagan lognormal-vol expansion and batched calibration
(port of ``iv_interpolation_tpu/ops/sabr.py``).

Hagan et al. (2002) lognormal implied vol sigma_B(F, K) to O(T):

    z   = (nu/alpha) * (F K)^((1-beta)/2) * ln(F/K)
    x(z)= ln( (sqrt(1 - 2 rho z + z^2) + z - rho) / (1 - rho) )
    sigma = alpha / ( (FK)^((1-beta)/2) * (1 + (1-beta)^2/24 ln^2(F/K)
            + (1-beta)^4/1920 ln^4(F/K)) ) * z/x(z) * (1 + c1 T)
    c1  = (1-beta)^2/24 * alpha^2/(FK)^(1-beta)
          + rho beta nu alpha / (4 (FK)^((1-beta)/2)) + (2-3rho^2)/24 nu^2

The ATM limit (K -> F) is handled analytically. The calibration runs on
the shared batched LM engine (``ops.lm``).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from iv_interpolation_tpu_torch.ops.lm import LMResult, levenberg_marquardt_batched

# parameter order: (alpha, beta, rho, nu); beta usually fixed in [0, 1].
# numpy on purpose: placed on the inputs' device and dtype at call time
SABR_LOWER = np.array([1e-6, 0.0, -0.9999, 1e-6])
SABR_UPPER = np.array([10.0, 1.0, 0.9999, 10.0])


def _like(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device; a Python number takes
    ``like``'s dtype (not torch's default float32)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _per_slice(x, params: torch.Tensor) -> torch.Tensor:
    """F or T as a tensor beside ``params``: one value a slice (the batch
    shape of ``params``) gains the strike axis; anything else broadcasts
    as it is."""
    x = _like(x, params)
    return x[..., None] if x.dim() == params.dim() - 1 else x


def sabr_vol(params: torch.Tensor, F, K: torch.Tensor, T) -> torch.Tensor:
    """Hagan lognormal implied vol; broadcasts over K.

    params: (..., 4) = (alpha, beta, rho, nu); F, T scalars or (...,);
    K: (..., n).
    """
    alpha, beta, rho, nu = (params[..., i:i + 1] for i in range(4))
    F = _per_slice(F, params)
    T = _per_slice(T, params)

    omb = 1.0 - beta
    logFK = torch.log(F / K)
    FKmid = (F * K) ** (omb / 2.0)

    c1 = (omb**2 / 24.0 * alpha**2 / (F * K) ** omb
          + rho * beta * nu * alpha / (4.0 * FKmid)
          + (2.0 - 3.0 * rho**2) / 24.0 * nu**2)

    denom = FKmid * (1.0 + omb**2 / 24.0 * logFK**2
                     + omb**4 / 1920.0 * logFK**4)

    z = (nu / alpha) * FKmid * logFK
    sqrt_term = torch.sqrt(1.0 - 2.0 * rho * z + z * z)
    # x(z) = log((sqrt_term + z - rho)/(1 - rho)). The direct numerator
    # N = sqrt_term + z - rho cancels catastrophically for z << 0 (true
    # value ~ (1-rho^2)/(2|z|); float32 computes <= 0 and the log is NaN,
    # reachable on the deep-OTM-put wing mid-LM, where every step then
    # rejects and the fit returns its start). Conjugate identity:
    # N * (sqrt_term - z + rho) = 1 - rho^2 exactly, and the conjugate C
    # is large and stable precisely where N cancels (z < 0), while N is
    # the stable one where C cancels (z >> 0). Select by sign.
    N = sqrt_term + z - rho
    # safe denominator: the unselected branch must not divide by a
    # cancelling C (a NaN there would reach forward-mode derivatives)
    C = torch.where(z < 0.0, sqrt_term - z + rho, 1.0)
    num = torch.where(z < 0.0, (1.0 - rho * rho) / C, N)
    x = torch.log(num / (1.0 - rho))
    # z/x -> 1 as z -> 0; the series z/x ~ 1 + rho z/2 keeps derivatives finite
    small = z.abs() < 1e-7
    z_safe = torch.where(small, 1.0, z)
    x_safe = torch.where(small, 1.0, x)
    zx = torch.where(small, 1.0 + rho * z / 2.0, z_safe / x_safe)

    return alpha / denom * zx * (1.0 + c1 * T)


def sabr_init(k_strikes: torch.Tensor, iv: torch.Tensor, F, T,
              beta: float = 0.5) -> torch.Tensor:
    """Initial guess: alpha from the ATM vol level, modest rho and nu.
    ``k_strikes``, ``iv`` (..., n); F (...,) or scalar -> params (..., 4)."""
    F = _like(F, iv)
    atm_idx = torch.log(k_strikes / F[..., None]).abs().argmin(dim=-1, keepdim=True)
    atm_vol = torch.gather(iv, -1, atm_idx)[..., 0]
    alpha0 = atm_vol * F ** (1.0 - beta)
    return torch.stack([alpha0, torch.full_like(alpha0, beta),
                        torch.zeros_like(alpha0), torch.full_like(alpha0, 0.5)], dim=-1)


def _pin_beta(params: torch.Tensor, fix_beta: float) -> torch.Tensor:
    return torch.cat([params[..., :1], torch.full_like(params[..., 1:2], fix_beta),
                      params[..., 2:]], dim=-1)


def _sabr_residual(params, K, iv, F, T, weights, fix_beta):
    p = params if fix_beta is None else _pin_beta(params, fix_beta)
    return (sabr_vol(p, F, K, T) - iv) * weights


def _fit(K, iv, F, T, weights, params0, max_iters, fix_beta) -> LMResult:
    """(B, n) strikes and vols, (B,) forwards and maturities."""
    if weights is None:
        weights = torch.ones_like(iv)
    if params0 is None:
        params0 = sabr_init(K, iv, F, T, beta=0.5 if fix_beta is None else fix_beta)
    res = levenberg_marquardt_batched(
        partial(_sabr_residual, fix_beta=fix_beta),
        params0, K, iv, F, T, weights, max_iters=max_iters,
        lower=SABR_LOWER, upper=SABR_UPPER)
    if fix_beta is not None:
        res = res._replace(params=_pin_beta(res.params, fix_beta))
    return res


def fit_sabr(K: torch.Tensor, iv: torch.Tensor, F, T,
             weights: torch.Tensor | None = None, params0=None,
             max_iters: int = 64, fix_beta: float | None = 0.5) -> LMResult:
    """Calibrate one SABR slice (strikes K (n,) -> lognormal vols iv).

    ``fix_beta`` pins beta (standard practice); pass None to free it.
    """
    F, T = (_like(x, iv).reshape(1) for x in (F, T))
    one = lambda a: None if a is None else a[None]
    fit = _fit(K[None], iv[None], F, T, one(weights), one(params0), max_iters, fix_beta)
    return LMResult(*(a[0] for a in fit))


def fit_sabr_batched(K: torch.Tensor, iv: torch.Tensor, F: torch.Tensor,
                     T: torch.Tensor, max_iters: int = 64,
                     fix_beta: float | None = 0.5) -> LMResult:
    """Batched calibration: K/iv (..., n), F/T (...,)."""
    batch_shape = iv.shape[:-1]
    n = iv.shape[-1]
    fit = _fit(K.reshape(-1, n), iv.reshape(-1, n), F.reshape(-1), T.reshape(-1),
               None, None, max_iters, fix_beta)
    return LMResult(*(a.reshape(batch_shape + a.shape[1:]) for a in fit))
