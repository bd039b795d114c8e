"""PyTorch/CUDA port of :mod:`repro` (QR-based model reduction).

A second package beside the JAX reference, module for module:
``repro/core/greedy.py`` is ported as ``repro_torch/core/greedy.py``.  The
two Pallas TPU kernels of the main path are hand-written CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` at first use.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see
:mod:`repro_torch.device`, which also turns TF32 off).
"""

from repro_torch import device as _device  # noqa: F401  (TF32 switches)

__version__ = "0.1.0"
