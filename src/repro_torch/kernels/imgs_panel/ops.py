"""Wrapper of the CUDA classical-GS panel pass: two hand-written kernels,
chosen by shape.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
one of the two kernels, by the fixed rule of :func:`kernel_route`, or
raises:

* ``"sm90"`` (``csrc/imgs_panel_sm90.cu``: split-N over contiguous slabs of
  Q, a ticket-elected fixed-order fold) takes every K for which a slab of
  at least 8 rows fits in shared memory (:func:`fit_rows`);
* ``"general"`` (``csrc/imgs_panel.cu``, the first design) takes the rest.

Each call is two dependent launches per column panel of at most 32
(the projection, then the update).  ``launches`` counts calls that
launched either kernel; ``launches_sm90`` and ``launches_general`` count
them by route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, check_tensor, kernel_dtype, ptr,
    raise_on_error, scratch_buffer, stream_ptr, ticket_counters,
)
from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref

launches = 0
launches_sm90 = 0
launches_general = 0

PMAX = 32             # widest column panel of both kernels
SLAB_ROWS = 128       # rows of Q per CTA of the sm90 kernel, at most
SMEM_BUDGET = 224 * 1024  # dynamic shared memory a CTA of it may take

_LL = ctypes.c_longlong
_LIBS = {
    "general": ("imgs_panel", {
        f"imgs_panel_{sfx}": ([ctypes.c_void_p] * 4 + [_LL] * 3
                              + [ctypes.c_void_p], ctypes.c_int)
        for sfx in DTYPE_SUFFIX.values()}),
    "sm90": ("imgs_panel_sm90", {
        **{f"imgs_panel_sm90_{sfx}": ([ctypes.c_void_p] * 6 + [_LL] * 4
                                      + [ctypes.c_void_p], ctypes.c_int)
           for sfx in DTYPE_SUFFIX.values()},
        "imgs_panel_sm90_scratch": ([_LL] * 4, _LL),
        "imgs_panel_sm90_tickets": ([_LL] * 2, _LL),
    }),
}
_sm_count: dict = {}


def fit_rows(K: int, p: int, itemsize: int) -> int:
    """The most rows of Q a CTA of the sm90 kernel can hold: the projection
    keeps T x (Kp + P) elements in shared memory, the update T Kp + K P,
    with rows Kp = K | 1 elements apart and P the column panel's width
    rounded up to even (at most PMAX); K >= 1."""
    Kp, P = K | 1, min(p + p % 2, PMAX)
    cap = SMEM_BUDGET // itemsize
    return min(cap // (Kp + P), (cap - K * P) // Kp)


def slab_rows(N: int, K: int, p: int, itemsize: int, sm_count: int) -> int:
    """Rows T of Q per CTA of the sm90 kernel: one slab for each of
    ``sm_count`` SMs (T = ceil(N / SMs), at least 8), no more than fit in
    shared memory or SLAB_ROWS.  Fewer, larger slabs leave fewer partials
    to fold."""
    return min(max(8, -(-N // sm_count)), SLAB_ROWS,
               fit_rows(K, p, itemsize))


def kernel_route(dtype: torch.dtype, K: int, p: int) -> str:
    """The kernel a CUDA call takes: ``"sm90"`` when a slab of at least 8
    rows of Q fits in shared memory (:func:`fit_rows`), else
    ``"general"``."""
    return "sm90" if fit_rows(K, p, dtype.itemsize) >= 8 else "general"


def imgs_panel(V: torch.Tensor, Q: torch.Tensor):
    """One classical-GS panel pass: returns ``(V - Q Q^H V, Q^H V)``.

    Matches :func:`repro_torch.kernels.imgs_panel.ref.imgs_panel_ref`.
    """
    return _imgs_panel(V, Q, general=False)


def _imgs_panel_general(V, Q):
    """:func:`imgs_panel` through the general kernel whatever
    :func:`kernel_route` says: the first design, timed beside the sm90
    kernel by ``chip_smoke.py`` and held to the plain version by the card
    tests at the shapes the sm90 kernel now takes."""
    return _imgs_panel(V, Q, general=True)


def _imgs_panel(V, Q, general):
    global launches, launches_sm90, launches_general
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
    route = "general" if general else kernel_route(Q.dtype, K, p)
    lib_name, signatures = _LIBS[route]
    lib = _build.load(lib_name, signatures)
    C = torch.empty((K, p), dtype=Q.dtype, device=dev)
    V_out = torch.empty_like(V)
    stream = stream_ptr(dev)
    if route == "sm90":
        if dev not in _sm_count:
            _sm_count[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        T = slab_rows(N, K, p, Q.dtype.itemsize, _sm_count[dev])
        scratch = scratch_buffer(dev, stream,
                                 lib.imgs_panel_sm90_scratch(N, K, p, T)
                                 * Q.dtype.itemsize)
        tickets = ticket_counters(dev, stream,
                                  lib.imgs_panel_sm90_tickets(N, T))
        err = getattr(lib, f"imgs_panel_sm90_{sfx}")(
            ptr(V), ptr(Q), ptr(C), ptr(V_out), ptr(scratch), ptr(tickets),
            N, K, p, T, stream)
    else:
        err = getattr(lib, f"imgs_panel_{sfx}")(
            ptr(V), ptr(Q), ptr(C), ptr(V_out), N, K, p, stream)
    raise_on_error(lib, f"imgs_panel ({route})", err)
    launches += 1
    if route == "sm90":
        launches_sm90 += 1
    else:
        launches_general += 1
    return V_out, C
