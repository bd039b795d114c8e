"""Wrapper of the fixed-order column-norm kernel (``csrc/column_norms.cu``).

:func:`column_norms_sq` gives ``sum_n |X[n, i]|^2`` of each column of a
2-D tensor with the bits of the plain halving tree
(:func:`.ref.column_norms_sq_ref`).  A CPU tensor takes the plain version;
a CUDA tensor gets the kernel or an error: one launch for any N up to
``CAP * 2**MAX_LEVEL`` rows (25,600), which reads each element once
whatever the view's row stride, and for a taller X partial stages first,
each one launch that writes level ``PARTIAL_LEVEL`` of the tree to a
scratch matrix.

``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.column_norms.ref import column_norms_sq_ref
from repro_torch.kernels.common import (
    kernel_dtype, ptr, raise_on_error, stream_ptr,
)

launches = 0

THREADS = 512
# shared memory of one CTA's folded level: two CTAs an SM
SMEM_BUDGET = 100 * 1024
# rows of the folded level: W columns of 4-byte reals (W 32) or of 8-byte
# ones (W 16) are 128 bytes a row either way
CAP = SMEM_BUDGET // 128
MAX_LEVEL = 5
PARTIAL_LEVEL = 4

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]
_SIGNATURES = {name: (_ARGTYPES, ctypes.c_int) for name in (
    "column_norms_f32", "column_norms_f64", "column_norms_c64",
    "column_norms_c128", "column_fold_f32", "column_fold_f64")}


def level_rows(n: int, level: int) -> int:
    """Rows of level ``level`` of the halving tree over ``n`` rows."""
    for _ in range(level):
        n -= n >> 1
    return n


def plan(n: int) -> list[tuple[int, bool, int]]:
    """The launches for an X of ``n >= 1`` rows: ``(level, final, rows)``
    each, ``rows`` the rows that launch reads.  The final launch folds
    level ``level`` (the smallest whose rows fit in ``CAP``) in shared
    memory; the ones before it write level ``PARTIAL_LEVEL``."""
    stages = []
    while True:
        for level in range(MAX_LEVEL + 1):
            if level_rows(n, level) <= CAP:
                stages.append((level, True, n))
                return stages
        stages.append((PARTIAL_LEVEL, False, n))
        n = level_rows(n, PARTIAL_LEVEL)


def column_norms_sq(X: torch.Tensor) -> torch.Tensor:
    """``sum_n |X[n, i]|^2`` per column of the 2-D ``X`` (float32, float64,
    complex64 or complex128, any strides), a real tensor of X's precision
    on X's device, each column's bits those of the plain halving tree."""
    global launches
    if X.dim() != 2:
        raise ValueError(f"column_norms: X must be 2-D, got shape "
                         f"{tuple(X.shape)}")
    sfx = kernel_dtype("column_norms", X.dtype)
    if X.device.type == "cpu":
        return column_norms_sq_ref(X)
    if X.device.type != "cuda":
        raise ValueError(f"column_norms: no kernel for device {X.device}")
    N, M = X.shape
    rdt = X.dtype.to_real()
    if N == 0 or M == 0:
        return torch.zeros(M, dtype=rdt, device=X.device)
    if max(N, M) >= 2 ** 31:
        raise ValueError(f"column_norms: shape {tuple(X.shape)} has a side "
                         f"of 2^31 or more")
    if X.data_ptr() % X.element_size():
        raise ValueError("column_norms: X must be aligned to its element "
                         "size")
    lib = _build.load("column_norms", _SIGNATURES)
    stream = stream_ptr(X.device)
    out = torch.empty(M, dtype=rdt, device=X.device)
    W = 32 if rdt.itemsize == 4 else 16  # columns a CTA owns
    src, rs, cs, name = X, X.stride(0), X.stride(1), f"column_norms_{sfx}"
    for level, final, rows in plan(N):
        if final:
            dst, smem = out, level_rows(rows, level) * W * rdt.itemsize
        else:
            dst = torch.empty((level_rows(rows, level), M), dtype=rdt,
                              device=X.device)
            smem = 0
        err = getattr(lib, name)(
            ptr(src), rs, cs, rows, M, level, int(final), ptr(dst),
            dst.stride(0), smem, stream)
        raise_on_error(lib, "column_norms", err)
        launches += 1
        src, rs, cs = dst, dst.stride(0), 1
        name = f"column_fold_{'f32' if rdt == torch.float32 else 'f64'}"
    return out
