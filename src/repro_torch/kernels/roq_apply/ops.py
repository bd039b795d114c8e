"""Wrapper of the CUDA interpolant apply (``csrc/roq_apply.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts calls that launched it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, check_tensor, kernel_dtype, ptr, raise_on_error, stream_ptr,
)
from repro_torch.kernels.roq_apply.ref import roq_apply_ref

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p]
_SIGNATURES = {f"roq_apply_{sfx}": (_ARGTYPES, ctypes.c_int)
               for sfx in DTYPE_SUFFIX.values()}


def roq_apply(B: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``out = B @ F`` with each column's bits independent of F's width.

    ``B`` (N, k) and ``F`` (k, nb) contiguous, of one dtype (f32, f64, c64
    or c128) and device.  Returns a new (N, nb) tensor.
    """
    global launches
    if B.device.type == "cpu":
        return roq_apply_ref(B, F)
    if B.device.type != "cuda":
        raise ValueError(f"roq_apply: no kernel for device {B.device}")
    sfx = kernel_dtype("roq_apply", B.dtype)
    if B.dim() != 2 or F.dim() != 2:
        raise ValueError("roq_apply: B and F must be 2-D")
    N, k = B.shape
    nb = F.shape[1]
    dev = B.device
    check_tensor("roq_apply", "B", B, B.dtype, (N, k), dev)
    check_tensor("roq_apply", "F", F, B.dtype, (k, nb), dev)
    out = torch.empty((N, nb), dtype=B.dtype, device=dev)
    if N == 0 or nb == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _build.load("roq_apply", _SIGNATURES)
    err = getattr(lib, f"roq_apply_{sfx}")(ptr(B), ptr(F), ptr(out), N, k,
                                           nb, stream_ptr(dev))
    raise_on_error(lib, "roq_apply", err)
    launches += 1
    return out
