"""Wrapper of the B-lane pivot-search sweep (``csrc/greedy_update_lanes_sm90.
cu``): one launch a lockstep round of the many-basis build.

A CPU tensor takes the plain version (:mod:`.ref`, the scalar plain
version lane by lane); a CUDA tensor launches a kernel, by the fixed rule
of :func:`kernel_route`, or raises:

* ``"lanes"`` (``csrc/greedy_update_lanes_sm90.cu``, the kernel of the
  scalar sm90 route: a TMA ring, each stage's rows of S summed for a group
  of up to 16 lanes, one launch for all lanes) takes what that route takes,
  rows of S a multiple of 16 bytes and S and q on 16-byte boundaries, with
  q's lanes 16-byte multiples apart when B > 1 (TMA starts a box at a
  16-byte aligned address only; the lockstep driver's lane rows are);
* ``"per_lane"`` takes the rest: one launch of the scalar
  :func:`repro_torch.kernels.greedy_update.ops.greedy_update` a lane (its
  own route rule then picks its general kernel).  That is a route chosen
  by shape, not a fallback on failure.

Either way lane b's results are bitwise the scalar kernel's on
``(q[b], S)`` (shared) or ``(q[b], S[b])`` (stacked), with ``active[b]``
as its flag.  ``launches`` counts calls that launched a kernel;
``launches_lanes`` and ``launches_per_lane`` count them by route (the
per-lane route's scalar launches are counted by ``greedy_update`` too).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    base_aligned16, check_tensor, kernel_dtype, ptr,
)
from repro_torch.kernels.greedy_update import ops as _gu
from repro_torch.kernels.greedy_update_lanes.ref import (
    greedy_update_lanes_ref,
)

launches = 0
launches_lanes = 0
launches_per_lane = 0

_LIBS = {"lanes": _gu._LIBS["sm90"]}


def kernel_route(dtype: torch.dtype, M: int, aligned: bool) -> str:
    """The kernel a CUDA call takes: ``"lanes"`` when a row of S (M
    elements of ``dtype``) is a multiple of 16 bytes and S and every lane
    of q start on 16-byte boundaries (``aligned``), the scalar sm90
    kernel's rule; else ``"per_lane"``."""
    if aligned and M * dtype.itemsize % 16 == 0:
        return "lanes"
    return "per_lane"


def _aligned(S: torch.Tensor, q: torch.Tensor) -> bool:
    return base_aligned16(S, q) and (
        q.shape[0] == 1 or q.stride(0) * q.element_size() % 16 == 0)


def greedy_update_lanes(q: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                        norms_sq: torch.Tensor,
                        active: torch.Tensor | None = None):
    """B lanes of the fused pivot-search update: per lane ``c = q_b^H S_b``,
    ``acc_b + |c|^2`` and the first-index residual argmax.

    Same arguments and results as
    :func:`repro_torch.kernels.greedy_update_lanes.ref.
    greedy_update_lanes_ref`.  ``q`` may hold its lanes any number of
    elements apart (``q.stride(0) >= N``), as the lockstep driver's
    aligned lane rows do; the other tensors are contiguous.  ``acc`` is
    not modified.
    """
    global launches, launches_lanes, launches_per_lane
    if S.device.type == "cpu":
        return greedy_update_lanes_ref(q, S, acc, norms_sq, active)
    if S.device.type != "cuda":
        raise ValueError(
            f"greedy_update_lanes: no kernel for device {S.device}")
    kernel_dtype("greedy_update_lanes", S.dtype)
    if S.dim() not in (2, 3) or q.dim() != 2:
        raise ValueError(
            f"greedy_update_lanes: S must be (N, M) or (B, N, M) and q "
            f"(B, N), got {tuple(S.shape)} and {tuple(q.shape)}")
    B, N = q.shape
    M = S.shape[-1]
    stacked = S.dim() == 3
    if B == 0 or N == 0 or M == 0:
        raise ValueError(f"greedy_update_lanes: empty S {tuple(S.shape)} "
                         f"or q {tuple(q.shape)}")
    dev, rdt = S.device, S.dtype.to_real()
    check_tensor("greedy_update_lanes", "S", S, S.dtype,
                 (B, N, M) if stacked else (N, M), dev)
    if q.device != dev or q.dtype != S.dtype or q.stride(1) != 1 \
            or q.stride(0) < N:
        raise ValueError(
            f"greedy_update_lanes: q must be a (B, N) {S.dtype} tensor on "
            f"{dev} with unit row stride and lanes at least N apart, got "
            f"{q.dtype} on {q.device}, strides {q.stride()}")
    check_tensor("greedy_update_lanes", "acc", acc, rdt, (B, M), dev)
    check_tensor("greedy_update_lanes", "norms_sq", norms_sq, rdt, (B, M),
                 dev)
    if active is not None:
        check_tensor("greedy_update_lanes", "active", active, torch.bool,
                     (B,), dev)
    if kernel_route(S.dtype, M, _aligned(S, q)) == "per_lane":
        outs = [_gu.greedy_update(q[b], S[b] if stacked else S, acc[b],
                                  norms_sq[b],
                                  None if active is None else active[b])
                for b in range(B)]
        launches += 1
        launches_per_lane += 1
        return tuple(torch.stack(x) for x in zip(*outs))
    out = _gu.launch_sm90(
        q, q.stride(0), S, stacked, acc, norms_sq,
        ctypes.c_void_p(None) if active is None else ptr(active), B, N, M,
        (B,))
    launches += 1
    launches_lanes += 1
    return out
