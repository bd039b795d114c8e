"""Helpers shared by the CUDA kernel wrappers (``ops.py`` modules).

One home for the argument checks and the launch plumbing, so that both
wrappers validate their tensors the same way before a pointer reaches C.
"""

from __future__ import annotations

import ctypes

import torch

# The dtype suffix of each C entry point (``greedy_update_c64`` ...).
DTYPE_SUFFIX = {
    torch.float32: "f32",
    torch.float64: "f64",
    torch.complex64: "c64",
    torch.complex128: "c128",
}


def is_fake(t) -> bool:
    """A fake tensor (a traced step, :mod:`repro_torch.kernels.traced`):
    shapes and dtypes only.  A plain tensor answers at once, with nothing
    imported."""
    if type(t) in (torch.Tensor, torch.nn.Parameter):
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def check_tensor(kernel: str, name: str, t: torch.Tensor,
                 dtype: torch.dtype, shape: tuple, device: torch.device):
    """Raise ``ValueError`` unless ``t`` is a contiguous CUDA tensor of the
    given dtype, shape and device — what the kernels' raw pointers need."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                         f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def flag_ptr(kernel: str, active, device: torch.device) -> ctypes.c_void_p:
    """The pointer a kernel reads its ``active`` flag through: null for
    ``None`` (active), else that of a 0-d bool tensor on ``device``.  A
    kernel that reads false skips its big input and writes what a zero
    basis vector would give."""
    if active is None:
        return ctypes.c_void_p(None)
    check_tensor(kernel, "active", active, torch.bool, (), device)
    return ptr(active)


def kernel_dtype(kernel: str, dtype: torch.dtype) -> str:
    """The C entry suffix for ``dtype``; raises on a dtype with no kernel."""
    try:
        return DTYPE_SUFFIX[dtype]
    except KeyError:
        raise ValueError(
            f"{kernel}: no kernel for dtype {dtype}; supported: "
            f"{list(DTYPE_SUFFIX)}") from None


def base_aligned16(*tensors: torch.Tensor) -> bool:
    """Every base pointer a multiple of 16 bytes: what TMA and the 16-byte
    ``cp.async`` copies of the sm90 kernels need."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# Buffers that belong to the wrappers, one of each kind per (device index,
# stream): kernels on one stream run one after another, so each finds the
# buffer as the previous one left it.  Launches on another stream get their
# own.
_tickets: dict = {}
_scratch: dict = {}
_barriers: dict = {}


def ticket_counters(device: torch.device, stream: ctypes.c_void_p,
                    n: int) -> torch.Tensor:
    """``n`` int32 counters at 0, for a kernel whose CTAs take tickets to
    elect the last one to finish; the kernel leaves them at 0.  ``stream``
    is :func:`stream_ptr`'s value."""
    key = (device.index, stream.value)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def barrier_counter(device: torch.device,
                    stream: ctypes.c_void_p) -> torch.Tensor:
    """One int32 at 0 for a kernel's grid-wide barrier, used by no other
    kernel: each barrier flips its top bit and leaves the low bits at 0."""
    key = (device.index, stream.value)
    buf = _barriers.get(key)
    if buf is None:
        buf = torch.zeros(1, dtype=torch.int32, device=device)
        _barriers[key] = buf
    return buf


def scratch_buffer(device: torch.device, stream: ctypes.c_void_p,
                   nbytes: int) -> torch.Tensor:
    """At least ``nbytes`` of uninitialised device memory that a kernel uses
    within one launch (16-byte aligned, like every PyTorch allocation)."""
    key = (device.index, stream.value)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        _scratch[key] = buf
    return buf


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``: every kernel launches there."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(lib, kernel: str, err: int) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({err}): {msg}")
