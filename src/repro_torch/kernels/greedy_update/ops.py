"""Wrapper of the CUDA pivot-search sweep (``csrc/greedy_update.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, check_tensor, kernel_dtype, ptr, raise_on_error, stream_ptr,
)
from repro_torch.kernels.greedy_update.ref import greedy_update_ref

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]
_SIGNATURES = {
    **{f"greedy_update_{sfx}": (_ARGTYPES, ctypes.c_int)
       for sfx in DTYPE_SUFFIX.values()},
    "greedy_update_num_blocks": ([ctypes.c_longlong], ctypes.c_longlong),
}


def greedy_update(q: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                  norms_sq: torch.Tensor):
    """Fused pivot-search update: c = q^H S, acc + |c|^2, residual argmax.

    Same arguments and results as
    :func:`repro_torch.kernels.greedy_update.ref.greedy_update_ref`; the
    argmax is the first index of the maximum on the card too.  ``acc`` is
    not modified (``acc_out`` is a new tensor).
    """
    global launches
    if S.device.type == "cpu":
        return greedy_update_ref(q, S, acc, norms_sq)
    if S.device.type != "cuda":
        raise ValueError(f"greedy_update: no kernel for device {S.device}")
    sfx = kernel_dtype("greedy_update", S.dtype)
    if S.dim() != 2:
        raise ValueError(f"greedy_update: S must be 2-D, got {S.dim()}-D")
    N, M = S.shape
    if N == 0 or M == 0:
        raise ValueError(f"greedy_update: empty S {tuple(S.shape)}")
    dev, rdt = S.device, S.dtype.to_real()
    check_tensor("greedy_update", "S", S, S.dtype, (N, M), dev)
    check_tensor("greedy_update", "q", q, S.dtype, (N,), dev)
    check_tensor("greedy_update", "acc", acc, rdt, (M,), dev)
    check_tensor("greedy_update", "norms_sq", norms_sq, rdt, (M,), dev)
    lib = _build.load("greedy_update", _SIGNATURES)
    nb = int(lib.greedy_update_num_blocks(M))
    c = torch.empty((M,), dtype=S.dtype, device=dev)
    acc_out = torch.empty((M,), dtype=rdt, device=dev)
    bmax = torch.empty((nb,), dtype=rdt, device=dev)
    bidx = torch.empty((nb,), dtype=torch.int64, device=dev)
    max_res = torch.empty((), dtype=rdt, device=dev)
    argmax = torch.empty((), dtype=torch.int64, device=dev)
    err = getattr(lib, f"greedy_update_{sfx}")(
        ptr(q), ptr(S), ptr(acc), ptr(norms_sq), ptr(c), ptr(acc_out),
        ptr(bmax), ptr(bidx), ptr(max_res), ptr(argmax), N, M,
        stream_ptr(dev))
    raise_on_error(lib, "greedy_update", err)
    launches += 1
    return c, acc_out, max_res, argmax
