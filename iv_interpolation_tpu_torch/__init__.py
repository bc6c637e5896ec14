"""iv_interpolation_tpu_torch: the PyTorch / CUDA port of iv_interpolation_tpu.

The port runs on one NVIDIA H100 (Hopper, sm_90a). It mirrors the JAX
package's layout (``ops``, ``surface``, ``models``, ``pipeline``) so each counterpart
is easy to find, and is held against the JAX package by the CPU tests.
The JAX package's two Pallas kernels are hand-written CUDA here
(``csrc/``), wrapped in ``ops/cuda/`` beside their plain PyTorch versions;
``_build`` compiles them with nvcc on first use.

Importing the package imports torch and never JAX.
"""

__version__ = "0.1.0"
