"""Device resolution and float32 precision switches for the port.

Every entry point of :mod:`repro_torch` runs on ``cuda`` unless the caller
passes ``device="cpu"``.  Without a CUDA device an entry point that was not
asked for the CPU raises: it never carries on on the CPU quietly.

The two TF32 switches are set here, once, when the package is imported.
PyTorch may run float32 products on the tensor cores in TF32 (about three
decimal digits).  The parity tolerances of this package assume full fp32
(``dtype_tol`` scales with float32's eps), and the greedy pivot order is
decided by residuals that TF32 would perturb well above that, so TF32 is
off for matrix products and for cuDNN alike.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises ``RuntimeError`` when the resolved device is CUDA and no CUDA
    device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (``torch.complex64`` -> complex64)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((), np.dtype(dtype))).dtype
