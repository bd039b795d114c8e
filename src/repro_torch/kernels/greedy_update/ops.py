"""Wrapper of the CUDA pivot-search sweep: two hand-written kernels, chosen by
shape.

A fake tensor (a traced step) takes the kernel's shape-only stand-in
(:mod:`repro_torch.kernels.traced`).  A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches
one of the two kernels, by the fixed rule of :func:`kernel_route`, or
raises:

* ``"sm90"`` (``csrc/greedy_update_lanes_sm90.cu`` with one lane: a TMA
  ring, one launch per sweep) takes S whose rows are a multiple of 16
  bytes, with S and q on 16-byte boundaries;
* ``"general"`` (``csrc/greedy_update.cu``, the first design: two launches
  per sweep) takes the rest: odd M in complex64 / float64, M % 4 != 0 in
  float32, unaligned views.

Both kernels take an optional on-device ``active`` flag (a 0-d bool
tensor): where it is false, every CTA returns without reading S, having
written what q = 0 gives (c = 0, ``acc_out = acc``, the first-index argmax
of ``norms_sq - acc``).  The greedy driver passes its latched "no stop
yet" flag, so the masked steps after a stop do not sweep S.

``launches`` counts calls that launched either kernel; ``launches_sm90``
and ``launches_general`` count them by route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, base_aligned16, check_tensor, flag_ptr, is_fake,
    kernel_dtype, ptr, raise_on_error, stream_ptr, ticket_counters,
)
from repro_torch.kernels.greedy_update.ref import greedy_update_ref

launches = 0
launches_sm90 = 0
launches_general = 0

_LIBS = {
    "general": ("greedy_update", {
        **{f"greedy_update_{sfx}": (
            [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2
            + [ctypes.c_void_p], ctypes.c_int)
           for sfx in DTYPE_SUFFIX.values()},
        "greedy_update_num_blocks": ([ctypes.c_longlong], ctypes.c_longlong),
    }),
    # the B-lane sweep, which greedy_update_lanes launches for B lanes
    "sm90": ("greedy_update_lanes_sm90", {
        **{f"greedy_update_lanes_sm90_{sfx}": (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_void_p] * 10
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p], ctypes.c_int)
           for sfx in DTYPE_SUFFIX.values()},
        "greedy_update_lanes_sm90_num_blocks": ([ctypes.c_longlong],
                                                ctypes.c_longlong),
    }),
}


def kernel_route(dtype: torch.dtype, M: int, aligned: bool) -> str:
    """The kernel a CUDA call takes: ``"sm90"`` when a row of S (M elements
    of ``dtype``) is a multiple of 16 bytes and S and q start on 16-byte
    boundaries (``aligned``), what TMA needs; else ``"general"``."""
    if aligned and M * dtype.itemsize % 16 == 0:
        return "sm90"
    return "general"


def greedy_update(q: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                  norms_sq: torch.Tensor, active: torch.Tensor | None = None):
    """Fused pivot-search update: c = q^H S, acc + |c|^2, residual argmax.

    Same arguments and results as
    :func:`repro_torch.kernels.greedy_update.ref.greedy_update_ref`; the
    argmax is the first index of the maximum on the card too.  ``acc`` is
    not modified (``acc_out`` is a new tensor).
    """
    return _greedy_update(q, S, acc, norms_sq, active, general=False)


def _greedy_update_general(q, S, acc, norms_sq, active=None):
    """:func:`greedy_update` through the general kernel whatever
    :func:`kernel_route` says: the first design, timed beside the sm90
    kernel by ``chip_smoke.py`` and held to the plain version by the card
    tests at the shapes the sm90 kernel now takes."""
    return _greedy_update(q, S, acc, norms_sq, active, general=True)


def _greedy_update(q, S, acc, norms_sq, active, general):
    global launches, launches_sm90, launches_general
    if is_fake(S):
        from repro_torch.kernels import traced

        return traced.greedy_update(q, S, acc, norms_sq, active)
    if S.device.type == "cpu":
        return greedy_update_ref(q, S, acc, norms_sq, active)
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
    flag = flag_ptr("greedy_update", active, dev)
    route = "general" if general else kernel_route(
        S.dtype, M, base_aligned16(S, q))
    if route == "sm90":
        out = launch_sm90(q, N, S, False, acc, norms_sq, flag, 1, N, M, ())
        launches += 1
        launches_sm90 += 1
        return out
    lib = _build.load(*_LIBS["general"])
    nb = int(lib.greedy_update_num_blocks(M))
    c = torch.empty((M,), dtype=S.dtype, device=dev)
    acc_out = torch.empty((M,), dtype=rdt, device=dev)
    bmax = torch.empty((nb,), dtype=rdt, device=dev)
    bidx = torch.empty((nb,), dtype=torch.int64, device=dev)
    max_res = torch.empty((), dtype=rdt, device=dev)
    argmax = torch.empty((), dtype=torch.int64, device=dev)
    err = getattr(lib, f"greedy_update_{sfx}")(
        ptr(q), ptr(S), ptr(acc), ptr(norms_sq), flag, ptr(c), ptr(acc_out),
        ptr(bmax), ptr(bidx), ptr(max_res), ptr(argmax), N, M,
        stream_ptr(dev))
    raise_on_error(lib, "greedy_update (general)", err)
    launches += 1
    launches_general += 1
    return c, acc_out, max_res, argmax


def launch_sm90(q, q_stride, S, stacked, acc, norms_sq, flag, B, N, M,
                lead):
    """One launch of ``csrc/greedy_update_lanes_sm90.cu`` on B lanes (the
    caller has checked the operands): q's lanes ``q_stride`` elements
    apart, S shared (N, M) or ``stacked`` (B, N, M), ``flag`` the pointer
    of the (B,) or 0-d bool flags (or null).  Returns ``(c, acc_out,
    max_res, argmax)`` shaped ``lead + (M,)`` and ``lead``, where ``lead``
    is ``(B,)``, or ``()`` for one lane."""
    dev, rdt = S.device, S.dtype.to_real()
    lib = _build.load(*_LIBS["sm90"])
    nb = int(lib.greedy_update_lanes_sm90_num_blocks(M))
    c = torch.empty((*lead, M), dtype=S.dtype, device=dev)
    acc_out = torch.empty((*lead, M), dtype=rdt, device=dev)
    bmax = torch.empty((B, nb), dtype=rdt, device=dev)
    bidx = torch.empty((B, nb), dtype=torch.int64, device=dev)
    max_res = torch.empty(lead, dtype=rdt, device=dev)
    argmax = torch.empty(lead, dtype=torch.int64, device=dev)
    stream = stream_ptr(dev)
    err = getattr(lib, f"greedy_update_lanes_sm90_{DTYPE_SUFFIX[S.dtype]}")(
        ptr(q), q_stride, ptr(S), int(stacked), ptr(acc), ptr(norms_sq),
        flag, ptr(c), ptr(acc_out), ptr(bmax), ptr(bidx),
        ptr(ticket_counters(dev, stream, B)), ptr(max_res), ptr(argmax), B,
        N, M, stream)
    raise_on_error(lib, "greedy_update (sm90)", err)
    return c, acc_out, max_res, argmax
