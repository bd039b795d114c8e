"""Wrapper of the CUDA blocked sweep (``csrc/block_sweep.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts calls that launched it (a panel
wider than 32 runs as several launches of one call).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_sweep.ref import block_sweep_ref
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, check_tensor, kernel_dtype, ptr, raise_on_error, stream_ptr,
)

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p]
_SIGNATURES = {f"block_sweep_{sfx}": (_ARGTYPES, ctypes.c_int)
               for sfx in DTYPE_SUFFIX.values()}


def block_sweep(Qnew: torch.Tensor, S: torch.Tensor, acc: torch.Tensor):
    """Fused blocked sweep: ``C = Qnew^H S``, ``acc + sum_i |C_i|^2``.

    Same arguments and results as
    :func:`repro_torch.kernels.block_sweep.ref.block_sweep_ref`.  ``acc``
    is not modified (``acc_out`` is a new tensor).
    """
    global launches
    if S.device.type == "cpu":
        return block_sweep_ref(Qnew, S, acc)
    if S.device.type != "cuda":
        raise ValueError(f"block_sweep: no kernel for device {S.device}")
    sfx = kernel_dtype("block_sweep", S.dtype)
    if S.dim() != 2 or Qnew.dim() != 2:
        raise ValueError("block_sweep: S and Qnew must be 2-D")
    N, M = S.shape
    p = Qnew.shape[1]
    if N == 0 or M == 0 or p == 0:
        raise ValueError(f"block_sweep: empty S {tuple(S.shape)} or Qnew "
                         f"{tuple(Qnew.shape)}")
    dev = S.device
    check_tensor("block_sweep", "S", S, S.dtype, (N, M), dev)
    check_tensor("block_sweep", "Qnew", Qnew, S.dtype, (N, p), dev)
    check_tensor("block_sweep", "acc", acc, S.dtype.to_real(), (M,), dev)
    lib = _build.load("block_sweep", _SIGNATURES)
    C = torch.empty((p, M), dtype=S.dtype, device=dev)
    acc_out = torch.empty_like(acc)
    err = getattr(lib, f"block_sweep_{sfx}")(
        ptr(Qnew), ptr(S), ptr(acc), ptr(C), ptr(acc_out), N, M, p,
        stream_ptr(dev))
    raise_on_error(lib, "block_sweep", err)
    launches += 1
    return C, acc_out
