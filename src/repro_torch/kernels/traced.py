"""Shape-only stand-ins of the kernels that a traced step reaches.

The dry run (:mod:`repro_torch.launch.dryrun`) traces steps on fake
tensors (``FakeTensorMode``), which hold no data: a ctypes launch cannot
take them, and handing them to a kernel's plain version would trace
another computation in the kernel's place.  So each wrapper that a traced
step reaches sends a fake tensor here first
(:func:`repro_torch.kernels.common.is_fake`; this module is imported only
then): to a
``torch.library`` custom op whose fake implementation gives the kernel's
output shapes and dtypes, and whose FLOP formula is the one that kernel's
bound uses in ``chip_smoke.py`` and PERF.md §6:

- ``flash_attention``: two products of 2 flops a multiply-add over the
  (query, key) pairs the mask keeps, ``4 B Hq D pairs``;
- ``greedy_update``: ``c = q^H S``, one multiply-add an element of S
  (8 flops complex, 2 real);
- ``imgs_project``: ``Q^H v`` and ``v - Q c``, two multiply-adds an
  element of Q.

A real tensor never reaches these ops: its route, launch counts and bits
stay the wrapper's own.
"""

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula


def _no_data(name):
    raise RuntimeError(f"repro_torch::{name} is the traced stand-in of a "
                       f"kernel: it takes fake tensors only")


def _macs_flops(dtype) -> int:
    return 8 if dtype.is_complex else 2


def kept_pairs(Sq: int, Skv: int, causal: bool,
               window: Optional[int]) -> int:
    """(query, key) pairs the end-aligned causal / window mask keeps."""
    total = 0
    for i in range(Sq):
        pos = i + Skv - Sq
        hi = pos if causal else Skv - 1
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(0, min(hi, Skv - 1) - lo + 1)
    return total


# ------------------------------------------------------------ flash attention
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int]) -> torch.Tensor:
    _no_data("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _(q, k, v, causal, window, *args, **kwargs) -> int:
    B, Hq, Sq, D = q.shape
    return 4 * B * Hq * D * kept_pairs(Sq, k.shape[2], causal, window)


# --------------------------------------------------------------- greedy update
@torch.library.custom_op("repro_torch::greedy_update", mutates_args=())
def greedy_update(q: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                  norms_sq: torch.Tensor, active: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    _no_data("greedy_update")


@greedy_update.register_fake
def _(q, S, acc, norms_sq, active):
    M, rdt = S.shape[1], S.dtype.to_real()
    return (S.new_empty((M,)), S.new_empty((M,), dtype=rdt),
            S.new_empty((), dtype=rdt), S.new_empty((), dtype=torch.int64))


@register_flop_formula(torch.ops.repro_torch.greedy_update, get_raw=True)
def _(q, S, *args, **kwargs) -> int:
    return _macs_flops(S.dtype) * S.shape[0] * S.shape[1]


# ----------------------------------------------------------- imgs project
@torch.library.custom_op("repro_torch::imgs_project", mutates_args=())
def imgs_project(v: torch.Tensor, Q: torch.Tensor,
                 active: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    _no_data("imgs_project")


@imgs_project.register_fake
def _(v, Q, active):
    return (torch.empty_like(v, memory_format=torch.contiguous_format),
            Q.new_empty((Q.shape[1],)))


@register_flop_formula(torch.ops.repro_torch.imgs_project, get_raw=True)
def _(v, Q, *args, **kwargs) -> int:
    return 2 * _macs_flops(Q.dtype) * Q.shape[0] * Q.shape[1]
