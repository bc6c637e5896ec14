"""Entry points of the port: one forward step and the multi-rank dry
run (port of the root ``__graft_entry__.py``).

``entry()`` returns the flagship forward step, the fused surface fit +
dense-grid eval + arbitrage diagnostics, with an example batch on the
card. ``dryrun_multichip(n)`` runs the port's dry run
(``parallel/dryrun.py``) in a world of n CPU ranks, one process a rank:
it needs no card.

    python -m iv_interpolation_tpu_torch.graft_entry      # both, on the card
"""

from __future__ import annotations

import torch


def _example_batch(B=256, E=30, n=50, dtype=torch.float32, device="cuda"):
    """(k, iv, expiries): B surfaces of E expiries x n strikes on [-1, 1],
    smooth smiles that differ by surface."""
    k = torch.linspace(-1.0, 1.0, n, dtype=dtype, device=device).expand(B, E, n)
    T = torch.linspace(0.05, 2.0, E, dtype=dtype, device=device).expand(B, E)
    iv = 0.2 + 0.1 * k * k + 0.02 * torch.sin(
        torch.arange(B, dtype=dtype, device=device)[:, None, None])
    return k, iv, T


def entry(device="cuda"):
    """(forward, example_args): the surface fit + eval forward step, cubic
    spline with not-a-knot ends on a 50-point grid, and a B=256 x 30 x 50
    batch on ``device`` (the card unless the caller passes another).
    ``forward`` returns (w_grid, butterfly_ok, calendar_ok)."""
    from iv_interpolation_tpu_torch.surface.surface import fit_eval_surface

    def forward(k, iv, expiries):
        out = fit_eval_surface(k, iv, expiries, method="cubic_spline",
                               n_grid=50, spline_bc="not-a-knot")
        return out["w_grid"], out["butterfly_ok"], out["calendar_ok"]

    return forward, _example_batch(device=device)


def dryrun_multichip(n_devices: int) -> None:
    """Run the port's dry run in a launched world of ``n_devices`` CPU
    ranks (gloo): the sharded pipeline against the unsharded one, the
    per-method sharded surface parity, the collectives and the concurrent
    ``--shard`` processes. Prints the summary line; raises on any
    failure."""
    from iv_interpolation_tpu_torch.parallel import dryrun

    rc = dryrun.main(["--ranks", str(int(n_devices)), "--device", "cpu"])
    if rc != 0:
        raise RuntimeError(f"dryrun_multichip: the dry run exited {rc}")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(a.shape) for a in out])
    dryrun_multichip(8)
