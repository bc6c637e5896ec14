"""Port parity: the port's library tour (``iv_interpolation_tpu_torch/
quickstart.py``) section by section against the JAX functions that
``examples/quickstart.py`` calls, on the tour's own seeded inputs (CPU
tensors; JAX on CPU with x64 on). Section 3's reference comes from
``iv_interpolation_tpu.ops.smoothing_spline``: the JAX quickstart imports
``fit_smoothing_spline_autolam`` from ``models.spline``, which does not
define it (ROADMAP C11). Greeks are held on the port's own evaluated
grid, so both packages price the same inputs.

Tolerances (``quickstart.TOLERANCES``, which ``chip_smoke.py`` holds the
card's run to as well), each the module's own (its
``tests/test_torch_*.py``):
* float64: the cubic surface, ``eval_surface`` and smoothing values 1e-12
  (g 1e-12 of its scale); local vol, density and variance-swap strikes
  1e-10 of scale; eSSVI grids and rmse 1e-7 of scale; Greeks 1e-12 of
  scale; SVI w at the quotes 1e-8; smoothing curvatures 1e-10 of scale;
  RBF penalized surfaces 2e-6 of scale; streaming (a float32 ring)
  realized vol 64 float32 ulps relative and the grids twice that;
  Andreasen-Huge flags and its price_rmse within 1e-4 relative (the
  independent-fit policy of ``chip_smoke.py`` phase 10: a grid node lies
  2.2e-8 from a quote-cell boundary here, so theta in a cell the quotes
  barely see can move, ``tests/test_torch_andreasen_huge.py``);
* float32: the cubic surface 256 ulps of scale; eSSVI and SVI w within
  5e-5 of scale and squared rmse within a factor 1.5; Greeks 8 ulps of
  scale; streaming as above; Andreasen-Huge flags and price_rmse within
  1 %; RBF flags only and finite values (the penalized saddle system is
  conditioned near 1e15, so float32 keeps no digit in either package);
* every flag exact; section 7's Flight table equals the session's refit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from iv_interpolation_tpu_torch import quickstart

DTYPES = ("float32", "float64")


@pytest.fixture(scope="module", params=DTYPES)
def runs(request):
    """(dtype, the port's arrays, the JAX functions' arrays)."""
    dtype = request.param
    res = quickstart.main(device="cpu", dtype=dtype, verbose=False)
    got = quickstart.arrays(res)
    return dtype, got, _jax_sections(res["inputs"], np.dtype(dtype).type, res)


def _jax_sections(inp, npd, res):
    from iv_interpolation_tpu.ops.andreasen_huge import eval_ah, fit_eval_ah_surface
    from iv_interpolation_tpu.ops.rbf import eval_rbf, fit_rbf_arbfree
    from iv_interpolation_tpu.ops.smoothing_spline import fit_smoothing_spline_autolam
    from iv_interpolation_tpu.pipeline.stream_service import StreamingSession
    from iv_interpolation_tpu.surface import eval_surface, fit_eval_surface, local_vol_surface
    from iv_interpolation_tpu.surface.greeks import greek_surfaces
    from iv_interpolation_tpu.models.svi import fit_svi_batched, svi_total_variance

    J = jnp.asarray
    k, T, iv = J(inp["k"]), J(inp["T"]), J(inp["iv"])
    B, n_u, nah, mah = k.shape[0], len(inp["underlyings"]), quickstart.AH_SURFACES, quickstart.AH_STRIKES
    out = fit_eval_surface(k, iv, T, method="cubic_spline", n_grid=50)
    lv = local_vol_surface(out)
    e = fit_eval_surface(k, iv, T, method="essvi", n_grid=50, svi_iters=48)
    cubic = res["surfaces"]["cubic"]
    host = lambda t: J(t.numpy())
    g = greek_surfaces(host(cubic["k_grid"]), host(cubic["iv_grid"]),
                       host(cubic["fit"].expiries), jnp.full((B,), 25_000.0, npd), 0.03,
                       is_call=True)
    svi = fit_svi_batched(k, J(inp["w_slices"]), max_iters=60, init="quasi")
    sm = fit_smoothing_spline_autolam(k[0], J(inp["noisy"]), J(inp["lams"]))
    sess = StreamingSession(inp["underlyings"], k[:n_u], iv[:n_u], T[:n_u],
                            window_minutes=quickstart.WINDOW, n_grid=20)
    sess.ingest_ticks(inp["ticks"])
    st = sess.refit()
    rbf = fit_rbf_arbfree(J(inp["points"]), J(inp["wq"]), n_iters=24)
    ah = fit_eval_ah_surface(k[:nah, :, :mah], J(inp["iv_arby"]), T[:nah], n_grid=129,
                             n_iters=8)
    sections = {
        "surfaces": {"w_grid": out["w_grid"], "iv_grid": out["iv_grid"], "g": out["g"],
                     "butterfly_ok": out["butterfly_ok"], "calendar_ok": out["calendar_ok"],
                     "w_q": eval_surface(out["fit"], jnp.zeros((B, 1), npd),
                                         jnp.full((B, 1), 0.7, npd)),
                     "local_vol": lv["local_vol"], "density": lv["density"],
                     "local_vol_ok": lv["local_vol_ok"], "var_swap": lv["var_swap"],
                     "essvi_w_grid": e["w_grid"], "essvi_fit_rmse": e["fit_rmse"],
                     "essvi_butterfly_ok": e["butterfly_ok"],
                     "essvi_calendar_ok": e["calendar_ok"]},
        "greeks": g,
        "calibration": {"svi_w": svi_total_variance(svi.params, k), "smoothed_g": sm.g,
                        "smoothed_M": sm.M},
        "streaming": {"w_grid": st.w_grid, "iv_grid": st.iv_grid,
                      "realized_vol": st.realized_vol, "butterfly_ok": st.butterfly_ok,
                      "calendar_ok": st.calendar_ok},
        "rbf": {"w_at": eval_rbf(rbf, jnp.array([[0.0, 1.0]], npd)), "pen_w": rbf["pen_w"],
                "butterfly_ok": rbf["butterfly_ok"], "calendar_ok": rbf["calendar_ok"]},
        "ah": {"w_mid": eval_ah(ah["fit"], jnp.zeros((nah, 1), npd),
                                jnp.full((nah, 1), 0.5, npd)),
               "c": ah["fit"].c, "fit_rmse": ah["fit_rmse"],
               "butterfly_ok": ah["butterfly_ok"], "calendar_ok": ah["calendar_ok"]},
    }
    return {s: {name: np.asarray(a) for name, a in d.items()} for s, d in sections.items()}


@pytest.mark.parametrize("section", quickstart.SECTIONS[:-1])
def test_section_matches_jax(runs, section):
    dtype, got, want = runs
    assert set(got[section]) == set(want[section])
    errors = quickstart.hold(got[section], want[section], dtype, section)
    assert set(errors) == set(want[section])


def test_flight_section_serves_the_sessions_refit(runs):
    pytest.importorskip("pyarrow.flight")
    _, got, _ = runs
    flight, refit = got["flight"], got["streaming"]
    np.testing.assert_array_equal(flight["realized_vol"], refit["realized_vol"].astype(np.float64))
    m = refit["iv_grid"].shape[-1]
    np.testing.assert_array_equal(flight["atm_iv"],
                                  refit["iv_grid"][:, 0, m // 2].astype(np.float64))
    for flag in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(flight[flag], refit[flag])


def test_package_level_names_are_the_defining_objects():
    """The lazy re-exports of the top level, ``surface``, ``pipeline`` and
    ``monitoring``, and the models' public math, are the objects their
    modules define."""
    import iv_interpolation_tpu_torch as top
    from iv_interpolation_tpu_torch import config, monitoring, pipeline, surface
    from iv_interpolation_tpu_torch.models import spline
    from iv_interpolation_tpu_torch.monitoring import logging, metrics
    from iv_interpolation_tpu_torch.ops import cubic_spline, spline_matrix
    from iv_interpolation_tpu_torch.pipeline import manifest, runner, storage
    from iv_interpolation_tpu_torch.surface import arbitrage, localvol
    from iv_interpolation_tpu_torch.surface import surface as surf

    assert top.Config is config.Config and top.get_config is config.get_config
    for name in ("fit_surface", "eval_surface", "fit_eval_surface"):
        assert getattr(top, name) is getattr(surf, name) is getattr(surface, name)
    assert top.PipelineRunner is pipeline.PipelineRunner is runner.PipelineRunner
    assert top.RunManifest is pipeline.RunManifest is manifest.RunManifest
    assert top.get_store is pipeline.get_store is storage.get_store
    assert pipeline.MemoryStore is storage.MemoryStore
    assert pipeline.ParquetStore is storage.ParquetStore
    assert surface.SurfaceFit is surf.SurfaceFit
    for name in ("butterfly_g", "calendar_violations", "check_surface_arbitrage"):
        assert getattr(surface, name) is getattr(arbitrage, name)
    for name in ("local_variance_grid", "local_vol_surface", "risk_neutral_density",
                 "variance_swap_strike"):
        assert getattr(surface, name) is getattr(localvol, name)
    for name in ("PerformanceLogger", "get_logger", "setup_logging"):
        assert getattr(monitoring, name) is getattr(logging, name)
    assert monitoring.StepMetrics is metrics.StepMetrics
    assert spline.fit_eval_smile is cubic_spline.fit_eval_smile
    assert spline.fit_eval_surface_grid is spline_matrix.fit_eval_surface_grid
    assert spline.build_surface_operators is spline_matrix.build_surface_operators
    with pytest.raises(AttributeError):
        top.no_such_name  # noqa: B018
    with pytest.raises(ImportError):
        exec("from iv_interpolation_tpu_torch.pipeline import no_such_name")


def test_the_tour_runs_on_the_card_unless_asked_for_the_cpu():
    """``main()`` and the command line target ``"cuda"``; without a card
    they raise at the first tensor instead of running on the CPU."""
    import inspect

    import torch

    assert inspect.signature(quickstart.main).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run is the card's")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        quickstart.main(verbose=False)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        quickstart.cli([])
