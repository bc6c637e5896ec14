"""iv_interpolation_tpu_torch: the PyTorch / CUDA port of iv_interpolation_tpu.

The port runs on one NVIDIA H100 (Hopper, sm_90a). It mirrors the JAX
package's layout (``ops``, ``surface``, ``models``, ``pipeline``) so each counterpart
is easy to find, and is held against the JAX package by the CPU tests.
The JAX package's two Pallas kernels are hand-written CUDA here
(``csrc/``), wrapped in ``ops/cuda/`` beside their plain PyTorch versions;
``_build`` compiles them with nvcc on first use.

The top level serves the library's entry points: ``Config`` and
``get_config``, and on first access ``fit_surface``, ``eval_surface``,
``fit_eval_surface``, ``PipelineRunner``, ``RunManifest`` and
``get_store``. Importing the package imports neither torch nor JAX;
``python -m iv_interpolation_tpu_torch.quickstart`` tours the library.
"""

from iv_interpolation_tpu_torch._lazy import lazy_exports
from iv_interpolation_tpu_torch.config import Config, get_config  # noqa: F401

__version__ = "0.1.0"

__all__ = ["Config", "get_config", "__version__"]

__getattr__ = lazy_exports(__name__, {
    "fit_surface": "iv_interpolation_tpu_torch.surface.surface",
    "eval_surface": "iv_interpolation_tpu_torch.surface.surface",
    "fit_eval_surface": "iv_interpolation_tpu_torch.surface.surface",
    "PipelineRunner": "iv_interpolation_tpu_torch.pipeline.runner",
    "RunManifest": "iv_interpolation_tpu_torch.pipeline.manifest",
    "get_store": "iv_interpolation_tpu_torch.pipeline.storage",
})
