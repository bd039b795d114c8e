"""AdamW with decoupled weight decay, global-norm clipping, f32 moments.

The port of :mod:`repro.optim.adamw`, with its numerics: the moments are
float32 whatever the parameters' dtype; there is no float32 master copy
(a bf16 parameter is updated in float32 and rounded back to bf16); the
clip scale ``min(1, clip / max(gn, 1e-12))`` is cast to each gradient's
dtype before the multiply; the bias corrections come from ``b ** step``
in float32.  ``torch.optim.AdamW`` computes something else (bf16 moments
for bf16 parameters, no global-norm clip).

A state is a tree (:mod:`repro_torch.tree`) of the parameters' structure;
``step`` is a 0-d int32 tensor on the parameters' device, so an update
needs no host sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def _device(params) -> torch.device:
    flat = leaves(params)
    return flat[0].device if flat else torch.device("cpu")


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, in tree order, of each leaf's float32 sum of
    squares."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    clip_norm: float | None = 1.0,
):
    """Updates ``params`` and ``state`` in place and returns them.

    The port's form of the reference's buffer donation: the parameters,
    both moments and the step are written into the tensors passed in, leaf
    by leaf (only one leaf's float32 temporaries live at a time), and the
    clip scales ``grads`` in place.  A caller that needs the old values
    passes clones."""
    with torch.no_grad():
        state.step.add_(1)
        flat_g = leaves(grads)
        if clip_norm is not None:
            gn = global_norm(flat_g)
            scale = torch.clamp(
                clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
            for g in flat_g:
                g.mul_(scale.to(g.dtype))
        stepf = state.step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=stepf.device), stepf)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

        for g, m, v, p in zip(flat_g, leaves(state.m), leaves(state.v),
                              leaves(params)):
            g32 = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            del g32
            delta = (m / c1) / (torch.sqrt(v / c2) + eps) \
                + weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
            del delta
    return params, state
