"""Wrapper of the CUDA classical-GS pass (``csrc/imgs_project.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernels or raises.  ``launches`` counts calls that launched them (each
call is two dependent kernel launches: the projection, then the update).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, check_tensor, kernel_dtype, ptr, raise_on_error, stream_ptr,
)
from repro_torch.kernels.imgs_project.ref import imgs_project_ref

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]
_SIGNATURES = {f"imgs_project_{sfx}": (_ARGTYPES, ctypes.c_int)
               for sfx in DTYPE_SUFFIX.values()}


def imgs_project(v: torch.Tensor, Q: torch.Tensor):
    """One classical-GS pass: returns ``(v - Q Q^H v, Q^H v)``.

    Matches :func:`repro_torch.kernels.imgs_project.ref.imgs_project_ref`.
    """
    global launches
    if Q.device.type == "cpu":
        return imgs_project_ref(v, Q)
    if Q.device.type != "cuda":
        raise ValueError(f"imgs_project: no kernel for device {Q.device}")
    sfx = kernel_dtype("imgs_project", Q.dtype)
    if Q.dim() != 2:
        raise ValueError(f"imgs_project: Q must be 2-D, got {Q.dim()}-D")
    N, K = Q.shape
    if N == 0 or K == 0:
        raise ValueError(f"imgs_project: empty Q {tuple(Q.shape)}")
    dev = Q.device
    check_tensor("imgs_project", "Q", Q, Q.dtype, (N, K), dev)
    check_tensor("imgs_project", "v", v, Q.dtype, (N,), dev)
    lib = _build.load("imgs_project", _SIGNATURES)
    c = torch.empty((K,), dtype=Q.dtype, device=dev)
    v_out = torch.empty((N,), dtype=Q.dtype, device=dev)
    err = getattr(lib, f"imgs_project_{sfx}")(
        ptr(v), ptr(Q), ptr(c), ptr(v_out), N, K, stream_ptr(dev))
    raise_on_error(lib, "imgs_project", err)
    launches += 1
    return v_out, c
