"""Wrapper of the TaylorF2 tile generator: two hand-written kernels, chosen
by the grid's N and the output dtype alone.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
one of the two kernels, by the fixed rule of :func:`kernel_route`, or
raises:

* ``"sm90"`` (``csrc/taylorf2_sm90.cu``: a cluster of G CTAs holds a group
  of C whole columns in shared memory, each element evaluated once) takes
  every N whose slab of ceil(N / G) rows x C columns fits in a CTA's shared
  memory (:func:`plan`);
* ``"general"`` (``csrc/taylorf2.cu``, the first design: 32 columns a
  block, a normalized element evaluated twice) takes the rest.

The route, and with it the order of every column's norm, never depends on
the tile's width, its first column or ``out``'s row stride: the resident S
and every streamed tile, ragged last tile included, come from one kernel,
so a column has the same bits in all of them.

``launches`` counts calls that launched either kernel; ``launches_sm90``
and ``launches_general`` count them by route.
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
launches_sm90 = 0
launches_general = 0

# Float64 instructions per element, the unit the card issues them in (64
# lanes a clock an SM on the H100, so an unfused multiply or add costs what
# an FMA does: half the 34 TFLOP/s, which counts an FMA as two): the 25 of
# the phase and the amplitude, the sincos's fast path (2 DMUL, 17 DFMA, 1
# DSETP, counted in the sm90 kernel's SASS by tools/sass_mix.py), and with
# normalize 3 for |h|^2 and 1 for its running sum.
SINCOS_INSTRUCTIONS = 20
F64_NORM_INSTRUCTIONS = 4

SMEM_BUDGET = 227 * 1024    # shared memory a CTA of the sm90 kernel may take
STATIC_SMEM = 8 * 1024      # its static shared memory, rounded up
CLUSTER = 8                 # CTAs of a cluster (G in the kernel)
THREADS = 256               # of a CTA (THREADS in the kernel)
# (columns of a cluster C, unroll of the row loop) by output type and
# normalize: a normalized tile takes 32-byte row segments (a 40 KB slab at
# N 10,000, so 4 CTAs an SM), an unnormalized one, which needs no slab,
# 64-byte ones.  The fastest of each on the H100
# (tools/tune_torch_sm90_plans.py).  C sets a normalized column's
# summation order, so it depends on nothing but the type and normalize,
# which every tile of a grid shares.
LAUNCH = {(torch.complex64, True): (4, 1),
          (torch.complex64, False): (8, 2),
          (torch.complex128, True): (2, 1),
          (torch.complex128, False): (4, 2)}

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_LL = ctypes.c_longlong
_ARGS = [ctypes.c_void_p] * 2 + [_LL] * 5 + [ctypes.c_int, ctypes.c_void_p]
_LIBS = {
    "general": ("taylorf2", {
        f"taylorf2_tile_{sfx}": (_ARGS + [ctypes.c_void_p], ctypes.c_int)
        for sfx in _SUFFIX.values()}),
    "sm90": ("taylorf2_sm90", {
        f"taylorf2_tile_sm90_{sfx}": (_ARGS + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p], ctypes.c_int)
        for sfx in _SUFFIX.values()}),
}


def f64_instructions(N: int, w: int, normalize: bool) -> int:
    """The float64 instructions one evaluation of each element of an (N, w)
    tile issues (and its norm when normalized); the scaling is in the
    output type (a float32 multiply at complex64)."""
    per = 25 + SINCOS_INSTRUCTIONS + (F64_NORM_INSTRUCTIONS if normalize
                                      else 0)
    return per * N * w


def smem_bytes(N: int, dtype: torch.dtype, C: int | None = None) -> int:
    """Shared memory of a CTA of the sm90 kernel on a normalized tile: its
    slab of ceil(N / G) rows x C columns (padded to 16 bytes; C the
    normalized tile's by default) and STATIC_SMEM for the sums and
    scales."""
    C = LAUNCH[dtype, True][0] if C is None else C
    slab = -(-N // CLUSTER) * C * dtype.itemsize
    return -(-slab // 16) * 16 + STATIC_SMEM


def plan(N: int, dtype: torch.dtype):
    """``(G, rows_cta)`` of the sm90 kernel for a grid of N rows, or None
    where a normalized tile's slab does not fit in SMEM_BUDGET.  A function
    of (N, dtype) alone; the rest of a launch is ``LAUNCH``'s."""
    if (dtype, True) not in LAUNCH or smem_bytes(N, dtype) > SMEM_BUDGET:
        return None
    return CLUSTER, max(1, -(-N // CLUSTER))


def kernel_route(N: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes: ``"sm90"`` where :func:`plan` fits,
    else ``"general"``; from the grid's N and the dtype only."""
    return "sm90" if plan(N, dtype) is not None else "general"


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
    return _taylorf2_tile(rows, cols, lo, hi, normalize, dtype, out,
                          general=False)


def _taylorf2_tile_general(rows, cols, lo, hi, normalize=True,
                           dtype=torch.complex64, out=None):
    """:func:`taylorf2_tile` through the general kernel whatever
    :func:`kernel_route` says: the first design, timed beside the sm90
    kernel by ``chip_smoke.py`` and held to the plain version by the card
    tests at the shapes the sm90 kernel now takes."""
    return _taylorf2_tile(rows, cols, lo, hi, normalize, dtype, out,
                          general=True)


def _taylorf2_tile(rows, cols, lo, hi, normalize, dtype, out, general):
    global launches, launches_sm90, launches_general
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
    route = "general" if general else kernel_route(N, dtype)
    lib_name, signatures = _LIBS[route]
    lib = _build.load(lib_name, signatures)
    sfx = _SUFFIX[dtype]
    args = (ptr(rows), ptr(cols), N, M, lo, w, out.stride(0),
            int(normalize), ptr(out))
    if route == "sm90":
        _, rows_cta = plan(N, dtype)
        c, unroll = LAUNCH[dtype, bool(normalize)]
        err = getattr(lib, f"taylorf2_tile_sm90_{sfx}")(
            *args, c, rows_cta, unroll, stream_ptr(dev))
    else:
        err = getattr(lib, f"taylorf2_tile_{sfx}")(*args, stream_ptr(dev))
    raise_on_error(lib, f"taylorf2_tile ({route})", err)
    launches += 1
    if route == "sm90":
        launches_sm90 += 1
    else:
        launches_general += 1
    return out
