"""Observability: logging, structured perf events, step metrics and the
live monitor. The package's public names load with their modules on
first access."""

from iv_interpolation_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "PerformanceLogger": "iv_interpolation_tpu_torch.monitoring.logging",
    "get_logger": "iv_interpolation_tpu_torch.monitoring.logging",
    "setup_logging": "iv_interpolation_tpu_torch.monitoring.logging",
    "StepMetrics": "iv_interpolation_tpu_torch.monitoring.metrics",
})
