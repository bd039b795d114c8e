"""Wrapper of the sketch's test-block generator (``csrc/sketch_omega.cu``).

:func:`sketch_omega` writes tile t's block ``Omega_t`` of the randomized
range-finder's test matrix into ``out``: the JAX package's own draws
(``repro/core/randomized.py::_test_block``), derived from
``fold_in(PRNGKey(seed), t)`` (:mod:`.ref` says how).  A CPU ``out`` takes
the plain version (:func:`.ref.sketch_omega_ref`); a CUDA ``out`` gets the
kernel, one launch for the whole block, or an error.

``launches`` counts calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    kernel_dtype, ptr, raise_on_error, stream_ptr,
)
from repro_torch.kernels.sketch_omega.ref import (
    KINDS, block_keys, sketch_omega_ref,
)

launches = 0

# Integer-ALU operations one draw (one real value) needs, the integer
# pipe's share of the bound: its Threefry evaluation's 20 rotates and 20
# xors, which only the ALU pipe issues, and the bits-to-float step: the xor
# of the two words, the shift and the or of the exponent for a gaussian
# draw, the or of the sign into 1.0 for a rademacher one.  A complex
# element is two draws.  The adds can issue on the FMA pipe (as IMADs) at
# the same rate, so they are not the ALU pipe's; but every instruction
# takes an issue slot, whichever pipe runs it, so the bound is also the
# instructions a draw must issue (ISSUE_PER_DRAW) at 4 warp-instructions an
# SM a clock, and it is the larger of the two times.
ALU_OPS_PER_DRAW = {"gaussian": 43, "rademacher": 41}
# Instructions one draw must issue, from the kernel's SASS
# (``tools/sass_mix.py sketch_omega``, the complex64 loops; a complex
# element is two draws).  gaussian: Threefry's 20 round adds and its key
# injections as compiled, 27 (16 IMAD.IADD, 7 IADD3, 1 IADD3.X, 3 VIADD:
# two adds of an injection fuse into one IADD3 with the next round's), its
# 20 rotates (SHF), 20 xors and the draw's integer steps as compiled (21
# LOP3, 1 LEA.HI: the shift and the or of the exponent fused), and the
# draw's float and MUFU instructions with both branches of erfinvf and the
# scaling (33: 66 an element); 102 in all, 204 an element.  rademacher:
# the last round's rotate and xor of the discarded word and its last
# injection are not compiled: 25 adds, 19 rotates, 19 xors and the sign's
# select, 64.
ISSUE_PER_DRAW = {"gaussian": 102, "rademacher": 64}

_U = ctypes.c_uint
_SIGNATURES = {
    f"sketch_omega_{sfx}": ([_U] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p],
                            ctypes.c_int)
    for sfx in ("f32", "f64", "c64", "c128")}


def sketch_omega(seed: int, tile: int, out: torch.Tensor,
                 kind: str = "gaussian") -> torch.Tensor:
    """Tile ``tile``'s test block under ``seed``, written into ``out``, a
    contiguous (m, ell) tensor of float32, float64, complex64 or complex128
    on the CPU or a CUDA device; returns ``out``.  ``kind``:
    ``"gaussian"`` or ``"rademacher"``."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"unknown sketch kind {kind!r}; valid: {KINDS}")
    sfx = kernel_dtype("sketch_omega", out.dtype)
    if out.dim() != 2 or not out.is_contiguous():
        raise ValueError(f"sketch_omega: out must be a contiguous 2-D "
                         f"tensor, got shape {tuple(out.shape)}")
    if out.device.type == "cpu":
        return out.copy_(sketch_omega_ref(seed, tile, tuple(out.shape),
                                          out.dtype, kind))
    if out.device.type != "cuda":
        raise ValueError(f"sketch_omega: no kernel for device {out.device}")
    keys = block_keys(seed, tile, out.dtype.is_complex)
    kr, ki = keys[0], keys[-1]
    lib = _build.load("sketch_omega", _SIGNATURES)
    err = getattr(lib, f"sketch_omega_{sfx}")(
        kr[0], kr[1], ki[0], ki[1], out.numel(), int(kind == "gaussian"),
        ptr(out), stream_ptr(out.device))
    raise_on_error(lib, "sketch_omega", err)
    launches += 1
    return out
