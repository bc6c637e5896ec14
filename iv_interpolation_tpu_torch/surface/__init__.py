"""Surface fit/eval and no-arbitrage diagnostics."""
