"""Wrapper of the TaylorF2 tile generator (``csrc/taylorf2.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts calls that launched it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_tensor, ptr, raise_on_error, stream_ptr,
)
from repro_torch.kernels.taylorf2.ref import taylorf2_tile_ref

launches = 0

# Floating-point operations per element of the function, counted from the
# kernel's source: 25 rounded float64 multiplies and adds of the phase and
# the amplitude (element()), and the sincos, taken as 40 (an estimate: a
# three-constant Cody-Waite reduction and two degree-7 polynomials in
# psi^2 evaluated with multiply-adds of 2 operations each; libdevice's
# path was not profiled).  A normalized tile adds 4 per element for |h|^2
# and its running sum, and 2 for the scaling.
FLOPS_PER_ELEMENT = 25 + 40
FLOPS_NORM = 4 + 2

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 5 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_SIGNATURES = {f"taylorf2_tile_{sfx}": (_ARGTYPES, ctypes.c_int)
               for sfx in _SUFFIX.values()}


def flops(N: int, w: int, normalize: bool) -> int:
    """The float64 operations the function needs for an (N, w) tile: one
    evaluation of each element, plus its norm and scaling when normalized.
    The kernel does more than that: a normalized tile evaluates every
    element twice (its norm pass, then its store) instead of reading the
    tile back, a choice of its design that the bound leaves out."""
    per = FLOPS_PER_ELEMENT + (FLOPS_NORM if normalize else 0)
    return per * N * w


def taylorf2_tile(rows: torch.Tensor, cols: torch.Tensor, lo: int, hi: int,
                  normalize: bool = True,
                  dtype: torch.dtype = torch.complex64,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Columns ``[lo, hi)`` of the waveform grid whose terms are ``rows``
    (4, N) and ``cols`` (8, M) (float64,
    :func:`repro_torch.gw.waveform.taylorf2_terms`), as an (N, hi - lo)
    ``dtype`` tensor (complex64 or complex128).

    ``out``: where to write them, an (N, hi - lo) tensor of ``dtype`` whose
    rows may be strided (a column slice of a row-major matrix); a new
    tensor otherwise.  Each column's bits depend on its terms alone.
    """
    global launches
    M = cols.shape[1]
    if not 0 <= lo < hi <= M:
        raise ValueError(f"taylorf2_tile: columns [{lo}, {hi}) outside "
                         f"[0, {M})")
    N, w = rows.shape[1], hi - lo
    if dtype not in _SUFFIX:
        raise ValueError(f"taylorf2_tile: no kernel for dtype {dtype}; "
                         f"supported: {list(_SUFFIX)}")
    if out is not None and (out.shape != (N, w) or out.dtype != dtype
                            or out.device != rows.device
                            or (N > 1 and out.stride(1) != 1)):
        raise ValueError(
            f"taylorf2_tile: out must be an ({N}, {w}) {dtype} tensor on "
            f"{rows.device} with unit column stride")
    if rows.device.type == "cpu":
        tile = taylorf2_tile_ref(rows, cols[:, lo:hi], normalize, dtype)
        return tile if out is None else out.copy_(tile)
    if rows.device.type != "cuda":
        raise ValueError(f"taylorf2_tile: no kernel for device "
                         f"{rows.device}")
    dev = rows.device
    check_tensor("taylorf2_tile", "rows", rows, torch.float64, (4, N), dev)
    check_tensor("taylorf2_tile", "cols", cols, torch.float64, (8, M), dev)
    if out is None:
        out = torch.empty((N, w), dtype=dtype, device=dev)
    lib = _build.load("taylorf2", _SIGNATURES)
    err = getattr(lib, f"taylorf2_tile_{_SUFFIX[dtype]}")(
        ptr(rows), ptr(cols), N, M, lo, w, out.stride(0), int(normalize),
        ptr(out), stream_ptr(dev))
    raise_on_error(lib, "taylorf2_tile", err)
    launches += 1
    return out
