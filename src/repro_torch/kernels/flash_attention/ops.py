"""Wrapper of the CUDA flash attention (``csrc/flash_attention.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  ``launches`` counts calls that launched it.

The kernel masks ragged sequence ends itself (no padding, no fallback) and
reads q, k, v through their strides, so the transposed (B, S, H, D)
activations of :func:`repro_torch.models.attention.multihead_attention`
are read in place.  The output has q's memory layout.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import ptr, raise_on_error, stream_ptr
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {f"flash_attention_{sfx}": (_ARGTYPES, ctypes.c_int)
               for sfx in _SUFFIX.values()}


def _check_shapes(q, k, v, causal, window):
    """Raise ``ValueError`` on a problem the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if min(B, Hq, Hkv, Sq, Skv) == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: need non-empty shapes and Hq % "
                         f"Hkv == 0, got Hq {Hq}, Hkv {Hkv}")
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"flash_attention: head dim {D} is not a multiple "
                         f"of 16 in [16, 256]")
    if causal and Sq > Skv:
        raise ValueError(f"flash_attention: causal with Sq {Sq} > Skv {Skv} "
                         f"leaves rows with no key")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with GQA + causal/sliding-window masking.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  Returns (B, Hq, Sq, D).
    Same function as
    :func:`repro_torch.kernels.flash_attention.ref.attention_ref`.
    """
    global launches
    _check_shapes(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    sfx = _SUFFIX.get(q.dtype)
    if sfx is None:
        raise ValueError(f"flash_attention: no kernel for dtype {q.dtype}; "
                         f"supported: {list(_SUFFIX)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype} "
                             f"on {t.device}, q has {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit stride "
                             f"along D, got strides {t.stride()}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention: B {B} or Hq {Hq} above 65535")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    tensors = (q, k, v, out)
    strides = [s for t in tensors for s in t.stride()]
    # 16-byte vector loads need 16-byte aligned rows
    vec = all(t.data_ptr() % 16 == 0 for t in tensors) and all(
        s * q.element_size() % 16 == 0
        for t in tensors for s in t.stride()[:3])
    lib = _build.load("flash_attention", _SIGNATURES)
    err = getattr(lib, f"flash_attention_{sfx}")(
        ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Sq, Skv, D,
        (ctypes.c_longlong * 16)(*strides), int(causal),
        0 if window is None else int(window), float(sm_scale), int(vec),
        stream_ptr(q.device))
    raise_on_error(lib, "flash_attention", err)
    launches += 1
    return out
