"""Wrapper of the CUDA classical-GS pass: two hand-written kernels, chosen by
shape.

A fake tensor (a traced step) takes the kernel's shape-only stand-in
(:mod:`repro_torch.kernels.traced`).  A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches
one of the two kernels, by the fixed rule of :func:`kernel_route`, or
raises:

* ``"sm90"`` (``csrc/imgs_project_sm90.cu``: one cooperative launch, each
  CTA's slab of Q held in shared memory from the projection through the
  update, a fixed-order fold behind one grid barrier) takes every K for
  which a slab of at least 8 rows fits in shared memory (:func:`fit_rows`);
  a grid that cannot be resident at once fails to launch and raises;
* ``"general"`` (``csrc/imgs_project.cu``, the first design: two launches,
  the projection then the update) takes the rest.

Both kernels take an optional on-device ``active`` flag (a 0-d bool
tensor): where it is false, every CTA returns without reading Q, having
written what Q = 0 gives (``v' = v``, ``c = 0``).  The greedy driver passes
its latched "no stop yet" flag, and a GS re-run pass its re-run test.

``launches`` counts calls that launched either kernel; ``launches_sm90``
and ``launches_general`` count them by route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    DTYPE_SUFFIX, barrier_counter, check_tensor, flag_ptr, is_fake,
    kernel_dtype, ptr, raise_on_error, scratch_buffer, stream_ptr,
)
from repro_torch.kernels.imgs_project.ref import imgs_project_ref

launches = 0
launches_sm90 = 0
launches_general = 0

THREADS = 512             # threads of a CTA of the sm90 kernel
SMEM_BUDGET = 224 * 1024  # dynamic shared memory a CTA of it may take

_LL = ctypes.c_longlong
_LIBS = {
    "general": ("imgs_project", {
        f"imgs_project_{sfx}": ([ctypes.c_void_p] * 5 + [_LL] * 2
                                + [ctypes.c_void_p], ctypes.c_int)
        for sfx in DTYPE_SUFFIX.values()}),
    "sm90": ("imgs_project_sm90", {
        **{f"imgs_project_sm90_{sfx}": ([ctypes.c_void_p] * 7 + [_LL] * 4
                                        + [ctypes.c_void_p], ctypes.c_int)
           for sfx in DTYPE_SUFFIX.values()},
        "imgs_project_sm90_smem": ([_LL] * 3, _LL),
    }),
}
_sm_count: dict = {}


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def smem_bytes(K: int, T: int, itemsize: int) -> int:
    """Shared memory of a CTA of the sm90 kernel with chunks of T rows: c
    (K elements, padded to 16 bytes), THREADS 16-byte sums, v's chunk and
    Q's chunk after 16 bytes of alignment slack (the kernel's
    ``imgs_project_sm90_smem``)."""
    return (_round16(K * itemsize) + THREADS * 16 + _round16(T * itemsize)
            + 16 + T * K * itemsize)


def fit_rows(K: int, itemsize: int) -> int:
    """The most rows of Q a CTA of the sm90 kernel holds within
    SMEM_BUDGET (:func:`smem_bytes`); K >= 1."""
    room = SMEM_BUDGET - _round16(K * itemsize) - THREADS * 16 - 16 - 15
    return max(room // ((K + 1) * itemsize), 0)


def plan(N: int, K: int, itemsize: int, sm_count: int):
    """``(rows_per_cta, ctas, T)`` of the sm90 kernel: one CTA for each of
    ``sm_count`` SMs, at least 8 rows each, no empty CTA; each CTA takes its
    rows in chunks of T, all at once where they fit."""
    rows = max(8, -(-N // sm_count))
    return rows, -(-N // rows), min(rows, fit_rows(K, itemsize))


def kernel_route(dtype: torch.dtype, K: int) -> str:
    """The kernel a CUDA call takes: ``"sm90"`` when a slab of at least 8
    rows of Q fits in shared memory (:func:`fit_rows`), else
    ``"general"``."""
    return "sm90" if fit_rows(K, dtype.itemsize) >= 8 else "general"


def imgs_project(v: torch.Tensor, Q: torch.Tensor,
                 active: torch.Tensor | None = None):
    """One classical-GS pass: returns ``(v - Q Q^H v, Q^H v)``, or ``(v, 0)``
    where ``active`` is false.

    Matches :func:`repro_torch.kernels.imgs_project.ref.imgs_project_ref`.
    """
    return _imgs_project(v, Q, active, general=False)


def _imgs_project_general(v, Q, active=None):
    """:func:`imgs_project` through the general kernel whatever
    :func:`kernel_route` says: the first design, timed beside the sm90
    kernel by ``chip_smoke.py`` and held to the plain version by the card
    tests at the shapes the sm90 kernel now takes."""
    return _imgs_project(v, Q, active, general=True)


def _imgs_project(v, Q, active, general):
    global launches, launches_sm90, launches_general
    if is_fake(Q):
        from repro_torch.kernels import traced

        return traced.imgs_project(v, Q, active)
    if Q.device.type == "cpu":
        return imgs_project_ref(v, Q, active)
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
    flag = flag_ptr("imgs_project", active, dev)
    route = "general" if general else kernel_route(Q.dtype, K)
    lib_name, signatures = _LIBS[route]
    lib = _build.load(lib_name, signatures)
    c = torch.empty((K,), dtype=Q.dtype, device=dev)
    v_out = torch.empty((N,), dtype=Q.dtype, device=dev)
    stream = stream_ptr(dev)
    if route == "sm90":
        if dev not in _sm_count:
            _sm_count[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        rows, ctas, T = plan(N, K, Q.dtype.itemsize, _sm_count[dev])
        scratch = scratch_buffer(dev, stream,
                                 ctas * _round16(K * Q.dtype.itemsize))
        err = getattr(lib, f"imgs_project_sm90_{sfx}")(
            ptr(v), ptr(Q), flag, ptr(c), ptr(v_out), ptr(scratch),
            ptr(barrier_counter(dev, stream)), N, K, rows, T, stream)
    else:
        err = getattr(lib, f"imgs_project_{sfx}")(
            ptr(v), ptr(Q), flag, ptr(c), ptr(v_out), N, K, stream)
    raise_on_error(lib, f"imgs_project ({route})", err)
    launches += 1
    if route == "sm90":
        launches_sm90 += 1
    else:
        launches_general += 1
    return v_out, c
