"""Wrapper of the CUDA flash attention: two hand-written kernels, chosen by
shape.

A fake tensor (a traced step) takes the kernel's shape-only stand-in
(:mod:`repro_torch.kernels.traced`).  A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches
one of the two kernels, by the fixed rule of :func:`kernel_route`, or
raises:

* ``"sm90"`` (``csrc/flash_attention_sm90.cu``: TMA, ``wgmma``, O in
  registers) takes bf16 / f16 at head dims 64, 80, 96, 128 and 256 when
  every base pointer and every stride but D's is a multiple of 16 bytes
  (80 and 96, stablelm's 80 among them, run its D 128 build on zero
  columns that TMA fills and never stores);
* ``"general"`` (``csrc/flash_attention.cu``: WMMA for 16-bit, FMA for f32)
  takes the rest: f32, the other head dims (16 to 256 in steps of 16) and
  unaligned views.

A CUDA call on the sm90 route that fails to build or launch raises; it
never falls back to the general kernel.

``launches`` counts calls that launched either kernel; ``launches_sm90``
and ``launches_general`` count them by route, ``launches_noncausal`` those
of either route without the causal mask (an encoder's bidirectional
attention).

Neither route has a backward pass: under grad mode, with q, k or v
requiring grad, both raise (as the reference's kernel does under
``jax.grad``), on the CPU too.

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
from repro_torch.kernels.common import (
    is_fake, ptr, raise_on_error, stream_ptr,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0
launches_sm90 = 0
launches_general = 0
launches_noncausal = 0

SM90_HEAD_DIMS = (64, 80, 96, 128, 256)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
_LIBS = {
    "general": ("flash_attention", {
        f"flash_attention_{sfx}":
            (_ARGTYPES + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
        for sfx in _SUFFIX.values()}),
    "sm90": ("flash_attention_sm90", {
        f"flash_attention_sm90_{sfx}":
            (_ARGTYPES + [ctypes.c_void_p], ctypes.c_int)
        for sfx in ("bf16", "f16")}),
}


def aligned16(*tensors: torch.Tensor) -> bool:
    """Every base pointer and every stride but the last (D's, which is 1) a
    multiple of 16 bytes: what TMA and the 16-byte vector loads need."""
    return all(t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:3])
        for t in tensors)


def kernel_route(dtype: torch.dtype, head_dim: int, aligned: bool) -> str:
    """The kernel a CUDA call takes: ``"sm90"`` for bf16 / f16 at a head dim
    of 64, 80, 96, 128 or 256 with 16-byte aligned pointers and strides,
    else ``"general"``."""
    if (dtype in (torch.bfloat16, torch.float16)
            and head_dim in SM90_HEAD_DIMS and aligned):
        return "sm90"
    return "general"


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
    return _flash(q, k, v, causal, window, sm_scale, general=False)


def _flash_attention_general(q, k, v, causal=True, window=None,
                             sm_scale=None) -> torch.Tensor:
    """:func:`flash_attention` through the general kernel whatever
    :func:`kernel_route` says: the first design, timed beside the sm90
    kernel by ``chip_smoke.py`` and held to the plain version by the card
    tests at the shapes the sm90 kernel now takes."""
    return _flash(q, k, v, causal, window, sm_scale, general=True)


def _check_no_grad(q, k, v) -> None:
    """Raise while gradients are taken through q, k or v: the kernel has no
    backward pass (nor has the reference's, whose ``jax.grad`` raises), and
    its output would carry no gradient to the projections, on the card with
    no error.  Training attends by einsum or chunks (``attn_impl="auto"``);
    a flash backward is ``ROADMAP.md`` queue 2 entry 5."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward pass (ROADMAP.md queue 2 "
            "entry 5): call it under torch.no_grad() or on tensors that do "
            "not require grad, or train with attn_impl='auto', 'einsum' or "
            "'chunked'")


def _flash(q, k, v, causal, window, sm_scale, general):
    global launches, launches_sm90, launches_general, launches_noncausal
    _check_no_grad(q, k, v)
    _check_shapes(q, k, v, causal, window)
    if is_fake(q):
        from repro_torch.kernels import traced

        if sm_scale not in (None, q.shape[-1] ** -0.5):
            raise ValueError("flash_attention: a traced call takes the "
                             "default scale")
        return traced.flash_attention(q, k, v, causal, window)
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
    aligned = aligned16(*tensors)
    route = "general" if general else kernel_route(q.dtype, D, aligned)
    strides = (ctypes.c_longlong * 16)(
        *[s for t in tensors for s in t.stride()])
    lib_name, signatures = _LIBS[route]
    lib = _build.load(lib_name, signatures)
    args = [ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Sq, Skv, D,
            strides, int(causal), 0 if window is None else int(window),
            float(sm_scale)]
    if route == "sm90":
        err = getattr(lib, f"flash_attention_sm90_{sfx}")(
            *args, stream_ptr(q.device))
    else:
        # aligned rows: 16-byte vector loads
        err = getattr(lib, f"flash_attention_{sfx}")(
            *args, int(aligned), stream_ptr(q.device))
    raise_on_error(lib, f"flash_attention ({route})", err)
    launches += 1
    if route == "sm90":
        launches_sm90 += 1
    else:
        launches_general += 1
    if not causal:
        launches_noncausal += 1
    return out
