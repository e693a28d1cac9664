"""neural-lam-tpu on PyTorch and CUDA: the port of ``neural_lam_tpu``.

The JAX package beside this one is the reference. This package mirrors
its layout and names module for module (``ops/interaction.py`` here is
the counterpart of ``neural_lam_tpu/ops/interaction.py``), written in
PyTorch, with the TPU's Pallas kernels replaced by CUDA kernels written
for Hopper (``csrc/``). It imports neither ``jax`` nor ``neural_lam_tpu``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"

from .loader import DataLoader, WeatherDataModule  # noqa: F401,E402
