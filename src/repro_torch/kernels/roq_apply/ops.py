"""Wrapper of the CUDA interpolant apply: two hand-written kernels that give
the same bits, chosen by shape.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
one of the two kernels, by the fixed rule of :func:`kernel_route`, or
raises:

* ``"sm90"`` (``csrc/roq_apply_sm90.cu``: a panel of rows of B and the
  whole of F in shared memory, a register tile of outputs a thread) takes
  every (k, nb) for which F and at least one row of B fit in shared memory
  (:func:`plan`);
* ``"general"`` (``csrc/roq_apply.cu``, the first design: one thread per
  8 rows x 1 column, operands from global memory) takes the rest.

Both sum each output over j = 0 .. k-1 in order with the same multiply-adds,
so they give the same bits, and a column's bits never depend on nb: a
switch of route with the batch width keeps the padded-bucket contract.

``launches`` counts calls that launched either kernel; ``launches_sm90``
and ``launches_general`` count them by route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, base_aligned16, check_tensor, kernel_dtype, ptr,
    raise_on_error, stream_ptr,
)
from repro_torch.kernels.roq_apply.ref import roq_apply_ref

launches = 0
launches_sm90 = 0
launches_general = 0

MAX_THREADS = 512           # threads of a CTA of the sm90 kernel
SMEM_BUDGET = 227 * 1024    # dynamic shared memory a CTA may take

_LL, _INT = ctypes.c_longlong, ctypes.c_int
_LIBS = {
    "general": ("roq_apply", {
        f"roq_apply_{sfx}": ([ctypes.c_void_p] * 3 + [_LL] * 3
                             + [ctypes.c_void_p], ctypes.c_int)
        for sfx in DTYPE_SUFFIX.values()}),
    "sm90": ("roq_apply_sm90", {
        f"roq_apply_sm90_{sfx}": ([ctypes.c_void_p] * 3 + [_LL] * 3
                                  + [_INT] * 5 + [ctypes.c_void_p],
                                  ctypes.c_int)
        for sfx in DTYPE_SUFFIX.values()}),
}
_sm_count: dict = {}


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def smem_bytes(k: int, nb: int, bm: int, itemsize: int) -> int:
    """Shared memory of a CTA of the sm90 kernel: its mbarrier (16 bytes),
    F padded to 16 bytes, and bm rows of B."""
    return 16 + _round16(k * nb * itemsize) + bm * k * itemsize


def plan(N: int, k: int, nb: int, itemsize: int, sm_count: int):
    """``(rr, cc, tx, ty)`` of the sm90 kernel, or None where it cannot
    take the shape: a thread holds rr rows x cc columns of out, the CTA tx
    threads along the columns and ty along the rows, so bm = rr ty rows of
    B.  bm spreads N over one CTA per SM (``ceil(N / sm_count)`` rows), or
    two where that many rows would take more than MAX_THREADS threads, as
    far as shared memory allows.  The tile follows nb and the type (the
    fastest of each bucket's tiles at the GW basis on the H100,
    ``tools/tune_torch_sm90_plans.py``).  None where F and one row of B
    overflow SMEM_BUDGET or a row of tx threads exceeds MAX_THREADS.  The
    plan never changes what one output sums, or in what order."""
    if nb <= 4:
        rr, cc = 1, 1
    elif itemsize >= 16:   # complex128
        rr, cc = (2 if nb <= 8 else 4), (1 if nb <= 32 else 4)
    else:
        rr, cc = 4, (2 if nb <= 64 else 4)
    tx = -(-nb // cc)
    fit = (SMEM_BUDGET - smem_bytes(k, nb, 0, itemsize)) // (k * itemsize)
    if fit < 1 or tx > MAX_THREADS:
        return None
    while rr > fit:   # a tile height the kernel is built for: 4, 2, 1
        rr //= 2
    want = -(-max(N, 1) // sm_count)
    ty = -(-want // rr)
    if tx * ty > MAX_THREADS:
        ty = -(-want // (2 * rr))
    return rr, cc, tx, max(1, min(ty, MAX_THREADS // tx, fit // rr))


def kernel_route(dtype: torch.dtype, k: int, nb: int) -> str:
    """The kernel a CUDA call takes: ``"sm90"`` when F (k x nb) and one row
    of B fit in its shared memory (:func:`plan`), else ``"general"``.  It
    does not depend on N."""
    return "sm90" if plan(1, k, nb, dtype.itemsize, 1) is not None \
        else "general"


def roq_apply(B: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``out = B @ F`` with each column's bits independent of F's width.

    ``B`` (N, k) and ``F`` (k, nb) contiguous, of one dtype (f32, f64, c64
    or c128) and device.  Returns a new (N, nb) tensor.
    """
    return _roq_apply(B, F, general=False)


def _roq_apply_general(B: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """:func:`roq_apply` through the general kernel whatever
    :func:`kernel_route` says: the first design, which the sm90 kernel is
    held to bit for bit by ``chip_smoke.py`` and the card tests."""
    return _roq_apply(B, F, general=True)


def _roq_apply(B, F, general):
    global launches, launches_sm90, launches_general
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
    route = "general" if general else kernel_route(B.dtype, k, nb)
    lib_name, signatures = _LIBS[route]
    lib = _build.load(lib_name, signatures)
    stream = stream_ptr(dev)
    if route == "sm90":
        if dev not in _sm_count:
            _sm_count[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        rr, cc, tx, ty = plan(N, k, nb, B.dtype.itemsize, _sm_count[dev])
        aligned = base_aligned16(B, F) and \
            rr * ty * k * B.dtype.itemsize % 16 == 0
        err = getattr(lib, f"roq_apply_sm90_{sfx}")(
            ptr(B), ptr(F), ptr(out), N, k, nb, rr, cc, tx, ty, int(aligned),
            stream)
    else:
        err = getattr(lib, f"roq_apply_{sfx}")(ptr(B), ptr(F), ptr(out), N,
                                               k, nb, stream)
    raise_on_error(lib, f"roq_apply ({route})", err)
    launches += 1
    if route == "sm90":
        launches_sm90 += 1
    else:
        launches_general += 1
    return out
