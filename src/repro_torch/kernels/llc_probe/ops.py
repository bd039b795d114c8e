"""Wrapper of the one-launch cache probe (``csrc/llc_probe.cu``).

:func:`llc_probe` reads a float32 working set ``reps`` times over and
returns partial sums of squares whose total is ``reps * (x . x)``: the
work whose time gives the streaming rate of that working set
(:func:`repro_torch.api.roofline._timed_stream_rate`).  A CPU ``x`` takes
the plain version (:func:`.ref.llc_probe_ref`, a loop of ``torch.dot``);
a CUDA ``x`` gets the kernel, one launch for all the passes, or an error.

``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import ptr, raise_on_error, stream_ptr
from repro_torch.kernels.llc_probe.ref import llc_probe_ref

launches = 0

# CTAs an SM: 1,024 threads, four float4 loads each in flight
CTAS_PER_SM = 4

_SIGNATURES = {"llc_probe_f32": ([ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p],
                                 ctypes.c_int)}


def llc_probe(x: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps`` reads of the contiguous 1-D float32 ``x`` (its length a
    multiple of 4 on the card, its base 16-byte aligned); a 1-D float32
    tensor whose sum is ``reps * (x . x)``."""
    global launches
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("llc_probe: x must be a contiguous 1-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if reps < 1:
        raise ValueError(f"llc_probe: reps must be >= 1, got {reps}")
    if x.device.type == "cpu":
        return llc_probe_ref(x, reps)
    if x.device.type != "cuda":
        raise ValueError(f"llc_probe: no kernel for device {x.device}")
    n4 = x.numel() // 4
    if x.numel() % 4 or n4 == 0 or x.data_ptr() % 16:
        raise ValueError("llc_probe: x needs a length that is a positive "
                         "multiple of 4 and a 16-byte aligned base")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(CTAS_PER_SM * sms, n4)
    if reps * -(-n4 // blocks) >= 2 ** 32:
        raise ValueError("llc_probe: reps * slice exceeds 2^32 loads")
    partial = torch.empty(blocks, dtype=torch.float32, device=x.device)
    lib = _build.load("llc_probe", _SIGNATURES)
    err = lib.llc_probe_f32(ptr(x), n4, reps, ptr(partial), blocks,
                            stream_ptr(x.device))
    raise_on_error(lib, "llc_probe", err)
    launches += 1
    return partial
