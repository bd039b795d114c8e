"""Wrapper of the CUDA classical-GS panel pass (``csrc/imgs_panel.cu``).

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
from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p]
_SIGNATURES = {f"imgs_panel_{sfx}": (_ARGTYPES, ctypes.c_int)
               for sfx in DTYPE_SUFFIX.values()}


def imgs_panel(V: torch.Tensor, Q: torch.Tensor):
    """One classical-GS panel pass: returns ``(V - Q Q^H V, Q^H V)``.

    Matches :func:`repro_torch.kernels.imgs_panel.ref.imgs_panel_ref`.
    """
    global launches
    if Q.device.type == "cpu":
        return imgs_panel_ref(V, Q)
    if Q.device.type != "cuda":
        raise ValueError(f"imgs_panel: no kernel for device {Q.device}")
    sfx = kernel_dtype("imgs_panel", Q.dtype)
    if Q.dim() != 2 or V.dim() != 2:
        raise ValueError("imgs_panel: Q and V must be 2-D")
    N, K = Q.shape
    p = V.shape[1]
    if N == 0 or K == 0 or p == 0:
        raise ValueError(f"imgs_panel: empty Q {tuple(Q.shape)} or V "
                         f"{tuple(V.shape)}")
    dev = Q.device
    check_tensor("imgs_panel", "Q", Q, Q.dtype, (N, K), dev)
    check_tensor("imgs_panel", "V", V, Q.dtype, (N, p), dev)
    lib = _build.load("imgs_panel", _SIGNATURES)
    C = torch.empty((K, p), dtype=Q.dtype, device=dev)
    V_out = torch.empty_like(V)
    err = getattr(lib, f"imgs_panel_{sfx}")(
        ptr(V), ptr(Q), ptr(C), ptr(V_out), N, K, p, stream_ptr(dev))
    raise_on_error(lib, "imgs_panel", err)
    launches += 1
    return V_out, C
