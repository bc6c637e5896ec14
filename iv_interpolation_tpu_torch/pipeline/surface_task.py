"""Surface-fitting task: interpolated option rows -> fitted vol surfaces
with arbitrage diagnostics (port of
``iv_interpolation_tpu/pipeline/surface_task.py``).

Groups the interpolated rows by underlying, builds per-expiry smiles from
the latest snapshot, fits them with a ``models`` family on one device and
stores the evaluated grid and its diagnostics in ``vol_surfaces``.

Symbol convention as in the reference's data (``btc-20mar23-24500-c``):
underlying-expiry-strike-cp.

The computation runs in ``processing.dtype`` (float32 in production; the
JAX package's suite runs x64, which ``float64`` matches), on the card
unless ``device`` names another.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from iv_interpolation_tpu_torch import models
from iv_interpolation_tpu_torch.config import check_single_device
from iv_interpolation_tpu_torch.pipeline import storage as st

SURFACES = "vol_surfaces"
_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.float32}


def parse_symbol(symbol: str):
    """'btc-20mar23-24500-c' -> (underlying, expiry_str, strike, is_call)."""
    parts = symbol.split("-")
    if len(parts) < 4:
        return None
    try:
        strike = float(parts[-2])
    except ValueError:
        return None
    return parts[0], "-".join(parts[1:-2]), strike, parts[-1].lower() == "c"


def _latest_quotes(df: pd.DataFrame) -> pd.DataFrame:
    """Each parsable symbol's latest row by date, in symbol order, with
    its parsed underlying, expiry, strike and call flag."""
    df = df.assign(symbol=df["symbol"].astype(str))
    last = (df.sort_values(["symbol", "date"], kind="stable")
            .drop_duplicates("symbol", keep="last"))
    parsed = [parse_symbol(s) for s in last["symbol"]]
    ok = np.fromiter((p is not None for p in parsed), bool, len(parsed))
    last = last[ok]
    parsed = [p for p in parsed if p is not None]
    return last.assign(
        underlying=[p[0] for p in parsed], expiry=[p[1] for p in parsed],
        strike=np.array([p[2] for p in parsed], np.float64),
        is_call=np.array([p[3] for p in parsed], bool))


def build_chains(df: pd.DataFrame, min_strikes: int = 4,
                 device: torch.device | str = "cuda",
                 dtype: torch.dtype = torch.float64):
    """Latest-snapshot chains per (underlying, expiry): log-moneyness and
    iv arrays sorted by strike, in (underlying, expiry) order. Returns a
    list of dicts, chain for chain those of the JAX package's function.

    Quotes without a usable ``iv`` fall back to Black-Scholes inversion of
    ``mark_price`` (``ops.black_scholes.implied_vol``, on ``device`` in
    ``dtype``). The callers keep float64 whatever ``processing.dtype``
    says: a float32 price of a low-vega quote cancels to noise, and its
    inverted iv can be off by tenths (ROADMAP C7). Vectorised over
    symbols: one sort for the latest rows, one grouped mean per
    (underlying, expiry, strike)."""
    if df.empty:
        return []
    last = _latest_quotes(df)
    f64 = lambda col: last[col].to_numpy(np.float64)
    S, T, iv = f64("underlying_price"), f64("time_to_maturity"), f64("iv")
    has_iv = np.isfinite(iv) & (iv > 0)
    quotes = last[["underlying", "expiry", "strike"]].assign(S=S, T=T, iv=iv)
    frames = [quotes[has_iv]]
    if "mark_price" in last.columns:
        price = f64("mark_price")
        inv = ~has_iv & np.isfinite(price) & (price > 0)
        if inv.any():
            from iv_interpolation_tpu_torch.ops.black_scholes import implied_vol
            rate = (f64("interest_rate") if "interest_rate" in last.columns
                    else np.zeros(len(last)))
            put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                            device=device)
            ivs = implied_vol(put(price[inv]), put(S[inv]), put(quotes["strike"].to_numpy()[inv]),
                              put(np.maximum(T[inv], 1e-6)), put(rate[inv]),
                              torch.as_tensor(last["is_call"].to_numpy()[inv], device=device))
            ivs = ivs.cpu().numpy().astype(np.float64)
            good = np.isfinite(ivs) & (ivs > 1e-4) & (ivs < 4.9)
            frames.append(quotes[inv].assign(iv=ivs)[good])
    frame = pd.concat(frames, ignore_index=True)
    if frame.empty:
        return []
    per_strike = (frame.groupby(["underlying", "expiry", "strike"], sort=True)
                  [["iv", "S", "T"]].mean().reset_index())
    und = per_strike["underlying"].to_numpy()
    exp = per_strike["expiry"].to_numpy()
    cols = {c: per_strike[c].to_numpy(np.float64) for c in ("strike", "S", "iv", "T")}
    starts = np.flatnonzero(np.r_[True, (und[1:] != und[:-1]) | (exp[1:] != exp[:-1])])
    chains = []
    for lo, hi in zip(starts, np.r_[starts[1:], len(und)]):
        k = np.log(cols["strike"][lo:hi] / cols["S"][lo:hi])
        iv_c, T_c = cols["iv"][lo:hi], cols["T"][lo:hi]
        # dedupe at float32: two float64-distinct strikes whose
        # log-moneyness rounds to one float32 would make a zero-width knot
        # interval (h = 0 -> inf/NaN for that surface). Keep the first.
        keep = np.concatenate([[True], np.diff(k.astype(np.float32)) > 0])
        if not keep.all():
            k, iv_c, T_c = k[keep], iv_c[keep], T_c[keep]
        if len(k) < min_strikes:
            continue
        chains.append(dict(underlying=und[lo], expiry=exp[lo], k=k, iv=iv_c,
                           T=float(T_c.mean())))
    return chains


def pack_chain_group(group, E_pad: int, n_pad: int, dtype=np.float64):
    """Pad a list of ``(underlying, T-sorted slices)`` chains into one
    dense ``(B, E_pad, n_pad)`` batch: strike axes extend strictly
    monotonically, padded expiry slots repeat the last slice at
    epsilon-larger T (maturities stay strictly ascending), and
    ``quote_mask`` marks the real quotes. Shared by ``run_surface_fit``
    and ``serve.build_session``.

    Returns ``(k, iv, T, E_real, quote_mask)``.
    """
    B = len(group)
    k = np.zeros((B, E_pad, n_pad), dtype)
    iv = np.zeros((B, E_pad, n_pad), dtype)
    T = np.zeros((B, E_pad), dtype)
    E_real = np.zeros(B, np.int64)
    quote_mask = np.zeros((B, E_pad, n_pad), bool)
    for b, (_und, slices) in enumerate(group):
        E_real[b] = len(slices)
        for e in range(E_pad):
            c = slices[min(e, len(slices) - 1)]
            m = len(c["k"])
            k[b, e, :m] = c["k"]
            iv[b, e, :m] = c["iv"]
            quote_mask[b, e, :m] = e < len(slices)
            if m < n_pad:
                step = (c["k"][-1] - c["k"][0]) / max(m - 1, 1) or 1e-3
                k[b, e, m:] = c["k"][-1] + step * np.arange(1, n_pad - m + 1)
                iv[b, e, m:] = c["iv"][-1]
            T[b, e] = c["T"] + max(0, e - (len(slices) - 1)) * 1e-3
    return k, iv, T, E_real, quote_mask


def _pow2_at_least(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _bucket_frame(group, res: dict, T: np.ndarray, E_real: np.ndarray) -> pd.DataFrame:
    """The stored rows of one fitted bucket: per underlying (in group
    order) its real expiries' grid rows, as the JAX task writes them."""
    host = {key: v.cpu().numpy() for key, v in res.items()}
    B, E_pad, m = host["w_grid"].shape
    real = np.arange(E_pad)[None, :] < E_real[:, None]          # (B, E_pad)
    b_idx = np.repeat(np.nonzero(real)[0], m)
    grid = lambda key: host[key][real].ravel()
    frame = {
        "underlying": np.array([und for und, _ in group], dtype=object)[b_idx],
        "expiry_t": np.repeat(T[real], m),
        "log_moneyness": grid("k_grid"),
        "total_variance": grid("w_grid"),
        "iv": grid("iv_grid"),
    }
    if "w_grid_lo" in host:
        frame["total_variance_lo"] = grid("w_grid_lo")
    if "local_vol" in host:
        frame["local_vol"] = grid("local_vol")
        frame["density"] = grid("density")
    frame["butterfly_ok"] = host["butterfly_ok"][b_idx].astype(bool)
    frame["calendar_ok"] = host["calendar_ok"][b_idx].astype(bool)
    if "fit_rmse" in host:
        frame["fit_rmse"] = host["fit_rmse"][b_idx].astype(np.float64)
    return pd.DataFrame(frame)


def run_surface_fit(config, store, limit: Optional[int] = None,
                    method: Optional[str] = None,
                    device: torch.device | str = "cuda") -> dict:
    """Fit one surface per underlying from interpolated data and persist
    the evaluated grid + diagnostics.

    ``surface.smile_method`` selects the family (``models.available()``;
    the unported ones raise ``NotImplementedError`` naming their ROADMAP
    item); ``surface.spline_bc`` the cubic boundary condition,
    ``surface.smoothing_lam`` the smoothing penalty, ``surface.compensated``
    parity mode, and ``surface.compute_local_vol`` adds Dupire local vol and
    risk-neutral density columns. Runs in ``processing.dtype`` on
    ``device`` (the card unless told otherwise); a ``processing.mesh_shape``
    of more than one device raises. A family's exception is not caught.
    """
    check_single_device(config.processing)
    scfg = config.surface
    method = method or scfg.smile_method
    model = models.get(method)
    device = torch.device(device)
    dtype = _DTYPES[config.processing.dtype]
    df = store.read(st.INTERPOLATED)
    if df.empty:
        return {"surfaces": 0, "reason": "no interpolated data"}
    chains = build_chains(df, device=device)
    if limit:
        chains = chains[:limit]
    if not chains:
        return {"surfaces": 0, "reason": "no usable chains"}

    by_und = {}
    for c in chains:
        by_und.setdefault(c["underlying"], []).append(c)

    # shape-bucket the underlyings: (E_pad, n_pad) from a geometric
    # schedule, and underlyings sharing a bucket fit as one batch
    prepared = {}
    for und, slices in by_und.items():
        slices = sorted(slices, key=lambda c: c["T"])
        E = max(len(slices), 2)  # a surface needs >= 2 expiries
        n = max(len(c["k"]) for c in slices)
        shape = (_pow2_at_least(E, 2), _pow2_at_least(n, 8))
        prepared.setdefault(shape, []).append((und, slices))

    def dev(a):
        t = torch.as_tensor(np.asarray(a), device=device)
        return t.to(dtype) if t.is_floating_point() else t

    # Andreasen-Huge fits in chunks of at most surface.ah_max_batch
    # underlyings (identical results, bounded batches); a negative cap is
    # refused, not read as "no buckets"
    max_b = getattr(scfg, "ah_max_batch", None) if method == "ah" else None
    if max_b is not None and max_b < 0:
        raise ValueError(f"surface.ah_max_batch must be >= 0 or None, got {max_b}")
    buckets = []
    for shape, group in sorted(prepared.items()):
        if max_b:
            buckets += [(shape, group[i:i + max_b]) for i in range(0, len(group), max_b)]
        else:
            buckets.append((shape, group))

    out_frames = []
    for (E_pad, n_pad), group in buckets:
        k, iv, T, E_real, quote_mask = pack_chain_group(group, E_pad, n_pad)
        res_all = model.fit_eval(k, iv, T, quote_mask, scfg, dev=dev)
        keys = list(models.PERSIST_KEYS)
        if "w_grid_lo" in res_all:
            # parity mode: the low limb, so (total_variance,
            # total_variance_lo) gives the float64 surface
            keys.append("w_grid_lo")
        if scfg.compute_local_vol:
            res_all = model.attach_local_vol(res_all, T=dev(T), scfg=scfg)
            keys += ["local_vol", "density"]
        out_frames.append(_bucket_frame(group, {key: res_all[key] for key in keys}, T, E_real))

    result = pd.concat(out_frames, ignore_index=True)
    store.write(SURFACES, result, upsert_keys=["underlying", "expiry_t", "log_moneyness"])
    per = result.groupby("underlying")
    return {
        "surfaces": len(by_und),
        "grid_rows": len(result),
        "butterfly_ok": int(per["butterfly_ok"].first().sum()),
        "calendar_ok": int(per["calendar_ok"].first().sum()),
        "method": method,
    }
